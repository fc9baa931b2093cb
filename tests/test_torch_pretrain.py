"""The port's pretraining against the JAX package's (CPU).

On an offline BERT of 2 layers at width 64 (matrices at std
1/sqrt(fan_in), so that sentences embed apart), fed the JAX package's own
draws (``pretrain._masking_draws``, ``_rank_draws`` and ``_batch_rows``
replaced by JAX's): ``apply_mlm_masking`` equal; ``mlm_loss_sparse``,
``mlm_loss`` and ``contrastive_loss`` within 1e-3 relative and every
gradient tensor within cosine 0.999; three steps of ``train_chunk`` and of
``contrastive_chunk`` with losses within 1e-3 and embeddings within cosine
0.9999.  Also: the learning-rate schedule, ``init_mlm`` bit for bit, the
MLM loss falling on a learnable corpus (JAX ``tests/test_pretrain.py``'s
bounds), ``to_hf_state_dict`` equal to JAX's, ``tree_from_params``
inverting ``params_from_tree``, HF checkpoints written by either package
loading in the other (float32 embeddings within 1e-5), and
``train_wordpiece_vocab`` equal to JAX's on ``data/*.json``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import pretrain as jpre
from adaptive_classifier_tpu import training as jtraining
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu_torch import pretrain, training
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models import modernbert

from torch_train_helpers import (one_torch_thread,  # noqa: F401
                                 _corpus, _jax_masking, _jax_views, _port_cfg, _views,
                                 assert_grads_close, cosine, spread)

REPO = Path(__file__).resolve().parent.parent
MASK_ID = 4
CFG = jenc.EncoderConfig(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128, max_position_embeddings=64)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(91)]


@pytest.fixture(scope="module")
def model():
    tree = spread(jenc.init_params(1, CFG))
    ids, attn, _ = _corpus(CFG)
    return tree, jpre.init_mlm(0, CFG), ids, attn


def _port_mlm(jmlm):
    return pretrain.MLMParams(*(torch.from_numpy(np.array(a)) for a in jmlm))


def _feed(monkeypatch, rows=(), masks=(), ranks=()):
    rows, masks, ranks = list(rows), list(masks), list(ranks)
    monkeypatch.setattr(pretrain, "_batch_rows", lambda g, n, b: rows.pop(0))
    monkeypatch.setattr(pretrain, "_masking_draws", lambda g, shape, lo, hi: masks.pop(0))
    monkeypatch.setattr(pretrain, "_rank_draws", lambda g, shape: ranks.pop(0))
    return rows, masks, ranks


def _rank(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 17), shape)))


def test_apply_mlm_masking_equals_jax_given_its_draws(model):
    _, _, ids, attn = model
    key = jax.random.PRNGKey(3)
    want = jpre.apply_mlm_masking(key, jnp.asarray(ids), jnp.asarray(attn), MASK_ID, 96)
    got = pretrain.masking_from_draws(torch.from_numpy(ids), torch.from_numpy(attn), MASK_ID,
                                      _jax_masking(key, ids.shape, 96))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.array(a), b.numpy())


def test_masking_recipe_statistics():
    """The port's own draws: ~15% of the eligible positions selected, ~80%
    of those [MASK], ~10% kept; [CLS] and pads never; the rest unchanged."""
    r = np.random.default_rng(0)
    ids = torch.from_numpy(r.integers(4, 64, (64, 32))).int()
    ids[:, 0] = 2
    attn = torch.ones_like(ids)
    attn[:, 28:] = 0
    masked, targets, sel = pretrain.apply_mlm_masking(
        torch.Generator().manual_seed(0), ids, attn, mask_id=4, vocab_size=64)
    assert torch.equal(targets, ids) and not sel[:, 0].any() and not sel[:, 28:].any()
    assert 0.10 < sel[:, 1:28].float().mean() < 0.20
    n = sel.sum()
    assert 0.7 < ((masked == 4) & sel).sum() / n < 0.9
    assert 0.03 < ((masked == ids) & sel).sum() / n < 0.2
    assert torch.equal(masked[~sel], ids[~sel])


def test_init_mlm_bit_for_bit():
    for seed in (0, 5):
        want = jpre.init_mlm(seed, CFG)
        got = pretrain.init_mlm(seed, _port_cfg(CFG), device="cpu")
        for a, b in zip(want, got):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(np.array(a), b.numpy())


def test_mlm_losses_and_gradients_match_jax(model, monkeypatch):
    tree, jmlm, ids, attn = model
    key = jax.random.PRNGKey(5)
    n_pred = 8
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda b: jpre.mlm_loss_sparse(b["enc"], jpre.MLMParams(*b["mlm"]), jnp.asarray(ids),
                                       jnp.asarray(attn), key, CFG, MASK_ID, n_pred)))(
        {"enc": tree, "mlm": jmlm})
    _feed(monkeypatch, masks=[_jax_masking(key, ids.shape, 96)] * 2,
          ranks=[_rank(key, ids.shape)])
    params, mlm = tenc.params_from_tree(tree), _port_mlm(jmlm)
    cfg = _port_cfg(CFG)
    ids_t, attn_t = torch.from_numpy(ids), torch.from_numpy(attn)
    loss, grads = training.value_and_grad(
        lambda b: pretrain.mlm_loss_sparse(b["enc"], pretrain.MLMParams(*b["mlm"]), ids_t,
                                           attn_t, None, cfg, MASK_ID, n_pred),
        {"enc": params, "mlm": mlm})
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (loss, jloss)
    assert_grads_close(jgrads["enc"], grads["enc"])
    for name, a, b in zip(jpre.MLMParams._fields, jgrads["mlm"], grads["mlm"]):
        assert cosine(a, b) >= 0.999, name
    # the dense loss, the same masking: the sparse one reads every selected
    # position here (at most n_pred a row), so the two agree
    jdense = jax.jit(lambda: jpre.mlm_loss(tree, jmlm, jnp.asarray(ids), jnp.asarray(attn),
                                           key, CFG, MASK_ID))()
    with torch.no_grad():
        dense = pretrain.mlm_loss(params, mlm, ids_t, attn_t, None, cfg, MASK_ID)
    assert abs(float(dense) - float(jdense)) <= 1e-3 * abs(float(jdense))
    assert abs(float(dense) - float(loss)) <= 1e-3 * abs(float(loss))


def test_contrastive_loss_and_gradients_match_jax(model):
    tree, _, ids, attn = model
    key = jax.random.PRNGKey(9)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpre.contrastive_loss(p, jnp.asarray(ids), jnp.asarray(attn), key, CFG,
                                        MASK_ID)))(tree)
    v1, v2 = _views(ids, attn, _jax_views(key, ids.shape, 96), prob=0.1)
    loss, grads = training.value_and_grad(
        lambda p: pretrain.contrastive_loss_on_views(p, v1, v2, torch.from_numpy(attn),
                                                     _port_cfg(CFG)),
        tenc.params_from_tree(tree))
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (loss, jloss)
    assert_grads_close(jgrads, grads)


def test_train_and_contrastive_chunks_match_jax(model, monkeypatch):
    """Three one-step ``train_chunk`` calls (warmup then cosine), then three
    one-step ``contrastive_chunk`` calls, each side with JAX's draws."""
    tree, jmlm, ids, attn = model
    N, S = ids.shape
    batch, n_pred = 8, max(int(S * 0.2), 8)
    mlm_keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    con_keys = [jax.random.PRNGKey(40 + i) for i in range(3)]
    rows, masks, ranks = [], [], []
    for key in mlm_keys:
        k_idx, k_mask = jax.random.split(jax.random.fold_in(key, 0))
        rows.append(torch.from_numpy(np.array(jax.random.randint(k_idx, (batch,), 0, N))))
        masks.append(_jax_masking(k_mask, (batch, S), 96))
        ranks.append(_rank(k_mask, (batch, S)))
    for key in con_keys:
        k_idx, k_loss = jax.random.split(jax.random.fold_in(key, 0))
        rows.append(torch.from_numpy(np.array(jax.random.randint(k_idx, (batch,), 0, N))))
        masks += _jax_views(k_loss, (batch, S), 96)
    left = _feed(monkeypatch, rows, masks, ranks)

    cfg = _port_cfg(CFG)
    ids_t, attn_t = torch.from_numpy(ids), torch.from_numpy(attn)
    jenc_p, jm = tree, jmlm
    jopt = jtraining.adamw_init({"enc": jenc_p, "mlm": jm})
    params, mlm = tenc.params_from_tree(tree), _port_mlm(jmlm)
    opt = training.adamw_init({"enc": params, "mlm": mlm})
    sched = dict(lr_peak=3e-3, warmup=2, total_steps=3)
    for key in mlm_keys:
        jenc_p, jm, jopt, jloss = jpre.train_chunk(
            jenc_p, jm, jopt, jnp.asarray(ids), jnp.asarray(attn), key, CFG, MASK_ID, batch,
            1, **sched)
        params, mlm, opt, loss = pretrain.train_chunk(params, mlm, opt, ids_t, attn_t, None,
                                                      cfg, MASK_ID, batch, 1, **sched)
        assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (loss, jloss)
    assert n_pred == 8 and opt.step == 3
    jopt, opt = jtraining.adamw_init(jenc_p), training.adamw_init(params)
    for key in con_keys:
        jenc_p, jopt, jloss = jpre.contrastive_chunk(
            jenc_p, jopt, jnp.asarray(ids), jnp.asarray(attn), key, CFG, MASK_ID, batch, 1)
        params, opt, loss = pretrain.contrastive_chunk(params, opt, ids_t, attn_t, None, cfg,
                                                       MASK_ID, batch, 1)
        assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss)), (loss, jloss)
    assert not any(left)
    want = np.array(jpre._mean_pool_embed(jenc_p, jnp.asarray(ids), jnp.asarray(attn), CFG))
    with torch.no_grad():
        got = pretrain._mean_pool_embed(params, ids_t, attn_t, cfg).numpy()
    cos = (want * got).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    assert cos.min() >= 0.9999, cos.min()


def test_scheduled_lr_equals_jax():
    lr_peak, warmup, total = 6e-4, 30, 300
    for step in (0, 1, 29, 30, 31, 150, 299, 300, 400):
        t = jnp.float32(step)
        want = jnp.where(t < warmup, lr_peak * (t + 1.0) / warmup,
                         lr_peak * 0.5 * (1.0 + jnp.cos(jnp.pi * jnp.minimum(
                             (t - warmup) / max(total - warmup, 1), 1.0))))
        got = pretrain.scheduled_lr(step, lr_peak, warmup, total)
        assert abs(got - float(want)) <= 1e-6 * lr_peak, step


def test_mlm_loss_falls():
    """200 sparse-logit steps on a corpus where token t is always followed
    by t+1 take the last chunk's mean loss far below the first's (JAX
    ``tests/test_pretrain.py``'s bounds: under 0.6 of it and under 2.2)."""
    cfg = tenc.EncoderConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                             intermediate_size=64, max_position_embeddings=32)
    r = np.random.default_rng(1)
    rows = [[(int(s) + j) % 60 + 4 for j in range(16)] for s in r.integers(4, 60, 64)]
    ids = torch.tensor(rows, dtype=torch.int32)
    attn = torch.ones_like(ids)
    params = tenc.params_from_tree(tenc.init_params(0, cfg))
    mlm = pretrain.init_mlm(0, cfg, device="cpu")
    opt = training.adamw_init({"enc": params, "mlm": mlm})
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        params, mlm, opt, loss = pretrain.train_chunk(
            params, mlm, opt, ids, attn, gen, cfg, 4, batch=32, n_steps=50, lr_peak=1e-2,
            warmup=20, total_steps=200)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6 and losses[-1] < 2.2, losses


def test_to_hf_state_dict_equals_jax(model):
    tree = model[0]
    want = jpre.to_hf_state_dict(tree, CFG)
    got = pretrain.to_hf_state_dict(tenc.tree_from_params(tenc.params_from_tree(tree)),
                                    _port_cfg(CFG))
    assert want.keys() == got.keys()
    for name in want:
        assert got[name].flags.c_contiguous and got[name].dtype == np.float32
        np.testing.assert_array_equal(np.asarray(want[name]), got[name], err_msg=name)


@pytest.mark.parametrize("name", ["bert", "electra", "modernbert"])
def test_tree_from_params_inverts_params_from_tree(name):
    cfg = {"bert": _port_cfg(CFG),
           "electra": tenc.EncoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                                         num_heads=2, intermediate_size=64,
                                         embedding_size=16, arch="electra"),
           "modernbert": tenc.EncoderConfig(vocab_size=64, hidden_size=32, num_layers=3,
                                            num_heads=2, intermediate_size=48,
                                            type_vocab_size=0, layer_norm_eps=1e-5,
                                            arch="modernbert")}[name]
    tree = tenc.init_params(2, cfg)
    MATRICES = set(tenc._MATRICES) | set(modernbert.MATRICES) | {"q_w", "k_w", "v_w"}
    for dtype in (torch.float32, torch.bfloat16):
        back = tenc.tree_from_params(tenc.params_from_tree(tree, matrix_dtype=dtype))
        flat = lambda t: {f"{s}.{k}": v for s in ("embeddings", "layers")  # noqa: E731
                          for k, v in t[s].items()}
        assert flat(back).keys() == flat(tree).keys()
        for k, want in flat(tree).items():
            want = np.asarray(want, np.float32)
            if dtype == torch.bfloat16 and k.split(".")[1] in MATRICES:
                want = torch.from_numpy(want).bfloat16().float().numpy()
            np.testing.assert_array_equal(back[k.split(".")[0]][k.split(".")[1]], want,
                                          err_msg=k)
        if name == "modernbert":
            np.testing.assert_array_equal(back["final_ln_scale"], tree["final_ln_scale"])


def test_hf_checkpoints_load_across_packages(model, tmp_path):
    tree = model[0]
    texts = ["tok1 tok2 tok3", "tok40 tok41", "tok7"]
    port_dir = pretrain.save_hf_checkpoint(tenc.tree_from_params(tenc.params_from_tree(tree)),
                                           _port_cfg(CFG), tmp_path / "port", VOCAB,
                                           extra_config={"ac_pooling": "mean"})
    jax_dir = jpre.save_hf_checkpoint(tree, CFG, tmp_path / "jax", VOCAB,
                                      extra_config={"ac_pooling": "mean"})
    for a, b in (("config.json", None), ("vocab.txt", None), ("tokenizer_config.json", None)):
        assert (port_dir / a).read_text() == (jax_dir / a).read_text(), a
    embs = []
    for d in (port_dir, jax_dir):
        t = tenc.Encoder(str(d), compute_dtype="float32", device="cpu")
        j = jenc.Encoder(str(d), compute_dtype="float32")
        assert t.pretrained and j.pretrained and t.config.pooling == "mean"
        for section in ("embeddings", "layers"):
            for k, v in tree[section].items():
                np.testing.assert_array_equal(t.float_tree()[section][k], v)
        embs += [t.embed(texts).numpy(), np.asarray(j.embed(texts))]
    for e in embs[1:]:
        np.testing.assert_allclose(e, embs[0], atol=1e-5)


def test_train_wordpiece_vocab_equals_jax():
    from adaptive_classifier_tpu.models.wordpiece_trainer import (
        train_wordpiece_vocab as jax_train)
    from adaptive_classifier_tpu_torch.models.wordpiece_trainer import train_wordpiece_vocab

    texts = []

    def walk(o):
        if isinstance(o, str):
            texts.append(o)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    for path in sorted((REPO / "data").glob("*.json")):
        walk(json.loads(path.read_text()))
    assert len(texts) > 5000
    got = train_wordpiece_vocab(texts, 2000)
    assert got == jax_train(texts, 2000) and len(got) == 2000
