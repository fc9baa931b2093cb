"""The port's encoder fine-tuning against the JAX package's (CPU).

The SupCon losses, their gradients and three AdamW steps on three tiny
encoders (the committed ``checkpoints/ac-tiny``, mean-pooled; an offline
BERT of 2 layers at width 64, CLS-pooled; a DistilBERT of the same size),
each fed the JAX package's own draws: the masked views and the batch rows
(``pretrain._masking_draws`` / ``pretrain._batch_rows`` replaced by
JAX's).  Tolerances: losses within 1e-3 relative, every gradient tensor
within cosine 0.999, the embeddings after three steps within cosine
0.9999 row by row (bf16 products on both sides, summed in other orders).
``typo_augment`` equal to JAX's; the behaviour of
``AdaptiveClassifier.finetune_encoder`` as the JAX package's
``tests/test_finetune.py`` holds it (memory slots and counts kept, the
temperature dropped, the int8 guard, no examples, an unknown augment,
merging across fine-tuned spaces, the multi-label run), saving and loading
the fine-tuned encoder in both packages, the int8 export of the adapted
weights, and the kernel wrappers' refusal of autograd.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import finetune as jft
from adaptive_classifier_tpu import pretrain as jpre
from adaptive_classifier_tpu import training as jtraining
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu_torch import AdaptiveClassifier, MultiLabelAdaptiveClassifier
from adaptive_classifier_tpu_torch import finetune, pretrain, training
from adaptive_classifier_tpu_torch.models import encoder as tenc

from torch_train_helpers import (one_torch_thread,  # noqa: F401
                                 BATCH, MASK_ID, N, REPO, S, _config, _corpus, _jax_views,
                                 _port_cfg, _views, assert_grads_close, cosine)

FAMILIES = ["ac-tiny", "bert-2x64", "distilbert-2x64"]


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    tree, cfg = _config(request.param)
    return request.param, tree, cfg, _corpus(cfg)


def test_supcon_loss_and_gradients_match_jax(case):
    name, tree, cfg, (ids, attn, labels) = case
    key = jax.random.PRNGKey(7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jft.supcon_loss(p, jnp.asarray(ids), jnp.asarray(attn),
                                  jnp.asarray(labels), key, cfg, MASK_ID)))(tree)
    v1, v2 = _views(ids, attn, _jax_views(key, ids.shape, cfg.vocab_size))
    params = tenc.params_from_tree(tree)
    loss, grads = training.value_and_grad(
        lambda p: finetune.supcon_loss_on_views(p, v1, v2, torch.from_numpy(attn),
                                                torch.from_numpy(labels), _port_cfg(cfg)),
        params)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (name, loss, jloss)
    assert_grads_close(jgrads, grads)


def test_supcon_loss_multihot_matches_jax():
    tree, cfg = _config("bert-2x64")
    ids, attn, labels = _corpus(cfg)
    y = np.zeros((N, 4), np.float32)
    y[np.arange(N), labels] = 1.0
    y[::4, 3] = 1.0                      # a shared second label across classes
    key = jax.random.PRNGKey(11)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jft.supcon_loss_multihot(p, jnp.asarray(ids), jnp.asarray(attn),
                                           jnp.asarray(y), key, cfg, MASK_ID)))(tree)
    v1, v2 = _views(ids, attn, _jax_views(key, ids.shape, cfg.vocab_size))
    loss, grads = training.value_and_grad(
        lambda p: finetune.supcon_loss_multihot_on_views(
            p, v1, v2, torch.from_numpy(attn), torch.from_numpy(y), _port_cfg(cfg)),
        tenc.params_from_tree(tree))
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    assert_grads_close(jgrads, grads)


@pytest.mark.parametrize("name", FAMILIES[:2])
def test_three_adamw_steps_match_jax(name, monkeypatch):
    """Three one-step chunks: JAX ``supcon_chunk`` with its keys, the port's
    with the same batch rows and views handed over."""
    tree, cfg = _config(name)
    ids, attn, labels = _corpus(cfg)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    rows, draws = [], []
    for key in keys:
        k_idx, k_loss = jax.random.split(jax.random.fold_in(key, 0))
        rows.append(torch.from_numpy(np.array(jax.random.randint(k_idx, (BATCH,), 0, N))))
        draws += _jax_views(k_loss, (BATCH, S), cfg.vocab_size)
    monkeypatch.setattr(pretrain, "_batch_rows", lambda g, n, b: rows.pop(0))
    monkeypatch.setattr(pretrain, "_masking_draws", lambda g, shape, lo, hi: draws.pop(0))

    jparams, jopt = tree, jtraining.adamw_init(tree)
    params = tenc.params_from_tree(tree)
    opt = training.adamw_init(params)
    ids_t, attn_t, y_t = (torch.from_numpy(a) for a in (ids, attn, labels))
    gen = torch.Generator().manual_seed(0)
    for key in keys:
        jparams, jopt, jloss = jft.supcon_chunk(
            jparams, jopt, jnp.asarray(ids), jnp.asarray(attn), jnp.asarray(labels), key,
            cfg, MASK_ID, BATCH, 1, lr=1e-3)
        params, opt, loss = finetune.supcon_chunk(params, opt, ids_t, attn_t, y_t, gen,
                                                  _port_cfg(cfg), MASK_ID, BATCH, 1, lr=1e-3)
        assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (name, loss, jloss)
    assert opt.step == 3 and not rows and not draws
    want = np.array(jpre._mean_pool_embed(jparams, jnp.asarray(ids), jnp.asarray(attn), cfg))
    with torch.no_grad():
        got = pretrain._mean_pool_embed(params, ids_t, attn_t, _port_cfg(cfg)).numpy()
    cos = (want * got).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    assert cos.min() >= 0.9999, (name, cos.min())


@pytest.mark.parametrize("copies,seed", [(1, 0), (2, 5), (3, 42)])
def test_typo_augment_equals_jax(copies, seed):
    texts = ["the billing charge is wrong", "reset my password now please",
             "a tiny word", "internationalization localization"]
    labels = ["billing", "password", "x", "y"]
    want = jft.typo_augment(texts, labels, random.Random(seed), copies=copies)
    assert finetune.typo_augment(texts, labels, random.Random(seed), copies=copies) == want


# ---------------------------------------------------------------------------
# the classifier's behaviour (the JAX package's tests/test_finetune.py)
# ---------------------------------------------------------------------------

SMALL = {"train_size_buckets": [64], "class_capacity_buckets": [8],
         "example_capacity_buckets": [32]}


def _make(cls=AdaptiveClassifier, **config):
    return cls("prajjwal1/bert-tiny", device="cpu", config={**SMALL, **config})


@pytest.fixture(scope="module")
def tuned():
    """A bert-tiny classifier, grown, calibrated, then fine-tuned; float32
    inference, so that the two packages' embeddings agree to 1e-5."""
    clf = _make(compute_dtype="float32")
    texts = [f"the billing charge looks wrong case {i}" for i in range(6)] + \
            [f"please reset my account password now {i}" for i in range(6)]
    clf.add_examples(texts, ["billing"] * 6 + ["password"] * 6)
    clf.calibrate(["billing charge three", "password reset three"], ["billing", "password"])
    before = {"word": clf.encoder.params["embeddings.word"].clone(),
              "tree": clf.encoder.float_tree(),
              "protos": {l: v.copy() for l, v in clf.memory.prototypes.items()},
              "slots": dict(clf.memory.label_to_index),
              "counts": {l: len(ts) for l, ts in clf.memory.texts.items()},
              "scaler": clf._temperature_scaler}
    report = clf.finetune_encoder(steps=15, chunk_steps=10, batch=8, lr=1e-4)
    return clf, before, report


def test_finetune_end_to_end(tuned):
    clf, before, report = tuned
    assert report["steps"] == 20 and len(report["chunk_losses"]) == 2
    assert np.isfinite(report["final_loss"]) and report["final_loss"] == report["chunk_losses"][-1]
    assert clf.encoder._finetuned
    assert not torch.equal(before["word"], clf.encoder.params["embeddings.word"])
    assert clf.encoder.params["layers.0.qkv_w"].dtype == clf.encoder.compute_dtype
    for label, proto in clf.memory.prototypes.items():
        assert not np.allclose(before["protos"][label], proto), label
    preds = clf.predict("the charge on my bill is wrong", k=2)
    assert {p[0] for p in preds} == {"billing", "password"}


def test_reembed_keeps_slots_and_counts(tuned):
    clf, before, _ = tuned
    assert clf.memory.label_to_index == before["slots"]
    assert {l: len(ts) for l, ts in clf.memory.texts.items()} == before["counts"]
    counts = clf.memory.state.count.cpu().numpy()
    for label, slot in before["slots"].items():
        assert counts[slot] == before["counts"][label]
    # each prototype is the mean of its texts' new embeddings
    for label, ts in clf.memory.texts.items():
        want = clf._embed_uncached(ts).mean(axis=0)
        got = clf.memory.prototypes[label]
        assert cosine(want, got) > 0.9999


def test_resets_temperature_and_caches(tuned):
    clf, before, _ = tuned
    assert before["scaler"] is not None and clf._temperature_scaler is None


def test_float_tree_and_int8_export_carry_the_adapted_weights(tuned, tmp_path):
    from adaptive_classifier_tpu_torch import io_safetensors
    from adaptive_classifier_tpu_torch.quantization import quantize_tree, save_quantized_encoder

    clf, before, _ = tuned
    tree = clf.encoder.float_tree()
    assert np.array_equal(tree["embeddings"]["word"],
                          clf.encoder.params["embeddings.word"].numpy())
    for name, base in before["tree"]["layers"].items():
        assert not np.array_equal(tree["layers"][name], base), name
    save_quantized_encoder(clf.encoder, tmp_path / "q")
    written = io_safetensors.load_file(tmp_path / "q" / "model_int8.safetensors")
    want, _ = quantize_tree(tree)
    base, _ = quantize_tree(before["tree"])
    assert written.keys() == want.keys()
    for name in want:
        assert np.array_equal(written[name], want[name]), name
    assert not np.array_equal(written["layers/ffn_in_w.int8"], base["layers/ffn_in_w.int8"])


def test_saved_encoder_loads_in_both_packages(tuned, tmp_path):
    from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier

    clf, _, _ = tuned
    saved = clf.save(tmp_path / "ck", include_quantized=False)
    assert saved["encoder"] == "encoder/"
    assert (tmp_path / "ck" / "encoder" / "model.safetensors").exists()
    text = ["refund the charge on my bill"]
    for cls in (AdaptiveClassifier, JaxClassifier):
        kw = {"device": "cpu"} if cls is AdaptiveClassifier else {}
        other = cls.load(str(tmp_path / "ck"), **kw)
        assert getattr(other.encoder, "_finetuned", False)
        assert other.model_name == clf.model_name
        np.testing.assert_allclose(other._get_embeddings(text), clf._get_embeddings(text),
                                   atol=1e-5)
    # a second save of the loaded classifier writes the adapted encoder again
    again = AdaptiveClassifier.load(tmp_path / "ck", device="cpu")
    again.save(tmp_path / "ck2", include_quantized=False)
    np.testing.assert_array_equal(
        tenc._load_state_dict(tmp_path / "ck2" / "encoder")["bert.embeddings.word_embeddings.weight"],
        tenc._load_state_dict(tmp_path / "ck" / "encoder")["bert.embeddings.word_embeddings.weight"])


def test_jax_finetuned_checkpoint_loads_in_the_port(tmp_path):
    from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier

    jclf = JaxClassifier("prajjwal1/bert-tiny", config=dict(SMALL, embedding_cache_size=0,
                                                            compute_dtype="float32"))
    jclf.add_examples(["refund the charge", "billing dispute case", "forgot my password",
                       "cannot sign in"], ["billing", "billing", "password", "password"])
    # weights moved off the base model's, as a fine-tuning run leaves them
    # (the JAX run itself is held to the port's in the tests above)
    r = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a + 0.01 * r.standard_normal(a.shape).astype(np.float32),
                          jclf.encoder.params)
    jclf.encoder.restore_params(params)
    jclf.encoder._finetuned = True
    jclf.save(str(tmp_path / "jk"), include_onnx=False)
    clf = AdaptiveClassifier.load(tmp_path / "jk", device="cpu")
    assert clf.encoder._finetuned and clf.model_name == "prajjwal1/bert-tiny"
    text = ["refund the charge"]
    np.testing.assert_allclose(clf._get_embeddings(text), jclf._get_embeddings(text),
                               atol=1e-5)


def test_saving_a_finetuned_non_bert_encoder_raises(tmp_path):
    clf = _make()
    clf.add_examples(["a b", "c d"], ["x", "y"])
    clf.encoder.config = tenc.EncoderConfig(**{**clf.encoder.config.__dict__,
                                               "arch": "distilbert"})
    clf.encoder._finetuned = True
    with pytest.raises(ValueError, match="cannot persist the fine-tuned 'distilbert'"):
        clf.save(tmp_path / "ck")


def test_guards():
    clf = _make()
    with pytest.raises(ValueError, match="no stored examples"):
        clf.finetune_encoder(steps=10)
    clf.add_examples(["the invoice total is wrong today", "please reset my password"],
                     ["billing", "password"])
    with pytest.raises(ValueError, match="positive"):
        clf.finetune_encoder(steps=0)
    with pytest.raises(ValueError, match="unknown augment"):
        clf.finetune_encoder(steps=10, augment="nope")
    rep = clf.finetune_encoder(steps=5, chunk_steps=5, batch=4, augment="typo")
    assert np.isfinite(rep["final_loss"])
    int8 = _make(quantization="int8")
    assert int8.encoder.quantization == "int8"
    int8.add_examples(["a", "b"], ["x", "y"])
    with pytest.raises(ValueError, match="float encoder params"):
        int8.finetune_encoder(steps=10)
    with pytest.raises(ValueError, match="no float master weights"):
        int8.encoder.master_params()


def test_merge_reembeds_across_finetuned_spaces():
    """A fine-tuned source's rows live in another space: its texts are
    embedded again with the target's encoder, not copied."""
    src = _make(embedding_cache_size=0)
    src.add_examples(["ship my parcel today", "where is my delivery"], ["shipping"] * 2)
    src.finetune_encoder(steps=5, chunk_steps=5, batch=4, lr=1e-3)
    dst = _make(embedding_cache_size=0)
    dst.add_examples(["refund the charge", "wrong bill amount"], ["billing"] * 2)
    dst.merge_classifiers(src)
    want = dst._get_embeddings(["ship my parcel today", "where is my delivery"]).mean(0)
    assert cosine(want, dst.memory.prototypes["shipping"]) > 0.9999
    copied = src.memory.prototypes["shipping"]
    assert cosine(copied, dst.memory.prototypes["shipping"]) < 0.9999
    # and the other way: a fine-tuned target takes a base classifier's texts anew
    base = _make(embedding_cache_size=0)
    base.add_examples(["track my order", "order status please"], ["orders"] * 2)
    src.merge_classifiers(base)
    want = src._get_embeddings(["track my order", "order status please"]).mean(0)
    assert cosine(want, src.memory.prototypes["orders"]) > 0.9999


def test_multilabel_finetune(monkeypatch):
    clf = _make(MultiLabelAdaptiveClassifier)
    clf.add_examples(["urgent billing problem with my card", "urgent access issue cannot log in",
                      "billing statement question", "login page not loading"],
                     [["urgent", "billing"], ["urgent", "access"], ["billing"], ["access"]])
    word = clf.encoder.params["embeddings.word"].clone()
    seen = {}
    real = finetune.supcon_chunk_multihot

    def spy(params, opt, ids, attn, y, *a, **k):
        seen["rows"], seen["y"] = ids.shape[0], y.clone()
        return real(params, opt, ids, attn, y, *a, **k)

    monkeypatch.setattr(finetune, "supcon_chunk_multihot", spy)
    rep = clf.finetune_encoder(steps=10, chunk_steps=10, batch=4)
    # four unique texts, multi-hot rows: the {urgent, billing} text once
    assert seen["rows"] == 4 and seen["y"].sum().item() == 6
    rep2 = clf.finetune_encoder(steps=10, chunk_steps=10, batch=4, augment="typo")
    assert seen["rows"] == 8 and torch.equal(seen["y"][:4], seen["y"][4:])
    assert np.isfinite(rep["final_loss"]) and np.isfinite(rep2["final_loss"])
    assert not torch.equal(word, clf.encoder.params["embeddings.word"])
    assert isinstance(clf.predict_multilabel("urgent charge on my bill"), list)


# ---------------------------------------------------------------------------
# the kernels refuse autograd; the differentiable CUDA product
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_autograd():
    import ast
    import inspect

    from adaptive_classifier_tpu_torch import ops
    from adaptive_classifier_tpu_torch.ops import attention_qkv, flash_attention, layernorm

    x = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.refuse_autograd("add_layer_norm", x, None)
    with torch.no_grad():
        ops.refuse_autograd("add_layer_norm", x)
    ops.refuse_autograd("add_layer_norm", x.detach())
    # each wrapper checks before it reaches the kernel library
    for fn in (attention_qkv.attention_from_qkv, layernorm.add_layer_norm,
               flash_attention._launch):
        calls = [n.func.attr if isinstance(n.func, ast.Attribute) else n.func.id
                 for n in ast.walk(ast.parse(inspect.getsource(fn).lstrip()))
                 if isinstance(n, ast.Call) and isinstance(n.func, (ast.Name, ast.Attribute))]
        assert "refuse_autograd" in calls and "library" in calls, fn.__name__
        assert calls.index("refuse_autograd") < calls.index("library"), fn.__name__


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_product_backward_is_the_upcast_products(dtype):
    """``_ProductF32``'s backward equals autograd through the upcast
    product bit for bit: f32 cotangent times the other operand, rounded
    once to the operand's type."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((24, 16), np.float32)).to(dtype)
    w = torch.from_numpy(r.standard_normal((16, 8), np.float32)).to(dtype)
    g = torch.from_numpy(r.standard_normal((24, 8), np.float32))
    got = [t.clone().requires_grad_(True) for t in (x, w)]
    tenc._ProductF32.apply(*got).backward(g)
    want = [t.clone().requires_grad_(True) for t in (x, w)]
    torch.mm(want[0].float(), want[1].float()).backward(g)
    for a, b in zip(got, want):
        assert a.grad.dtype == dtype and torch.equal(a.grad, b.grad)
