"""The port's ModernBERT against the JAX package's and the ``transformers``
model (CPU).

A 4-layer ModernBERT at D 64 (``global_attn_every_n_layers`` 3, a local
window of ±4 at S 24, so both kinds of layer and the window's edge run),
random weights, ``save_pretrained`` into a temporary directory, loaded by
both packages.  Tolerances: float32 hidden states and embeddings within
``atol=1e-4`` of the JAX package's, cosine 0.999 against ``transformers``;
bf16 within cosine 0.999 of the JAX bf16 forward.  Also the weight mapping
and offline init array for array, the int8 request (a warning, then the
float forward), and a classifier on this checkpoint with the committed
byte-level BPE fixture against the JAX package's, saved and loaded.
"""

import dataclasses
import logging
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models import modernbert as jmb
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models import modernbert as tmb

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "bpe"


def _config(vocab_size=512):
    return transformers.ModernBertConfig(
        vocab_size=vocab_size, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=96, global_attn_every_n_layers=3, local_attention=8,
        max_position_embeddings=128, pad_token_id=1, bos_token_id=0, eos_token_id=2,
        cls_token_id=0, sep_token_id=2, attn_implementation="eager")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    torch.manual_seed(0)
    model = transformers.ModernBertModel(_config())
    model.eval()
    d = tmp_path_factory.mktemp("modernbert")
    model.save_pretrained(d)
    (d / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(507)]))
    return d, model


def _ids_and_mask(seed=0, B=3, S=24):
    r = np.random.default_rng(seed)
    ids = r.integers(5, 500, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 18:] = 0
    mask[2, 5:] = 0
    return np.where(mask > 0, ids, 1).astype(np.int32), mask


def test_forward_matches_jax_and_transformers(checkpoint):
    path, model = checkpoint
    jax_enc = jenc.Encoder(str(path), compute_dtype="float32")
    enc = tenc.Encoder(str(path), device="cpu", compute_dtype="float32")
    assert enc.config.arch == "modernbert"
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jax_enc.config)
    ids, mask = _ids_and_mask()
    want = np.asarray(jenc.encoder_forward(jax_enc.params, jnp.asarray(ids),
                                           jnp.asarray(mask), jax_enc.config,
                                           compute_dtype=jnp.float32))
    got = tenc.encoder_forward(enc.params, torch.from_numpy(ids), torch.from_numpy(mask),
                               enc.config, compute_dtype=torch.float32).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)
    emb = enc.embed_ids(ids, mask).numpy()
    np.testing.assert_allclose(emb, np.asarray(jax_enc._embed_jit(
        jax_enc.params, jnp.asarray(ids), jnp.asarray(mask))), atol=1e-4)
    # transformers on whole rows (its unpadded path drops the pad tokens)
    full = np.ones_like(mask)
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(full).long()).last_hidden_state
    ref = torch.nn.functional.normalize(out[:, 0], dim=1).numpy()
    emb_full = enc.embed_ids(ids, full).numpy()
    assert ((emb_full * ref).sum(axis=1) > 0.999).all()
    np.testing.assert_allclose(
        tenc.encoder_forward(enc.params, torch.from_numpy(ids), torch.from_numpy(full),
                             enc.config, compute_dtype=torch.float32).numpy(),
        out.numpy(), atol=2e-3)


def test_bf16_forward_matches_jax(checkpoint):
    path, _ = checkpoint
    jax_enc = jenc.Encoder(str(path), compute_dtype="float32")
    cfg = tenc.EncoderConfig(**dataclasses.asdict(jax_enc.config))
    ids, mask = _ids_and_mask(seed=1, B=4, S=32)
    want = np.asarray(jmb.modernbert_forward(jax_enc.params, jnp.asarray(ids),
                                             jnp.asarray(mask), jax_enc.config,
                                             compute_dtype=jnp.bfloat16))
    params = convert.encoder_params_from_jax(jax_enc.params, matrix_dtype=torch.bfloat16)
    got = tmb.modernbert_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                                 compute_dtype=torch.bfloat16).numpy()
    valid = mask.astype(bool)
    g, w = got[valid], want[valid]
    cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1))
    print(f"modernbert bf16: min row cosine {cos.min():.6f}, "
          f"equal share {float((g == w).mean()):.4f}")
    assert cos.min() >= 0.999


def test_weights_and_layout_match_jax(checkpoint):
    path, _ = checkpoint
    jcfg = jenc._read_hf_config(path)
    cfg = tenc._read_hf_config(path)
    jtree = jenc._map_hf_weights(jenc._load_state_dict(path), jcfg)
    tree = tenc._map_hf_weights(tenc._load_state_dict(path), cfg)
    for group in ("embeddings", "layers"):
        assert set(tree[group]) == set(jtree[group])
        for k, v in jtree[group].items():
            np.testing.assert_array_equal(tree[group][k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tree["final_ln_scale"], np.asarray(jtree["final_ln_scale"]))
    # layer 0 has no attention norm: a unit scale
    np.testing.assert_array_equal(tree["layers"]["attn_ln_scale"][0], np.ones(64, np.float32))
    params = tenc.params_from_tree(tree, matrix_dtype=torch.bfloat16)
    assert params["layers.3.wqkv"].shape == (64, 192)
    assert params["layers.3.wqkv"].dtype == torch.bfloat16
    assert params["layers.3.mlp_ln_scale"].dtype == torch.float32
    assert params["final_ln_scale"].shape == (64,)
    assert set(convert.encoder_params_from_jax(jtree)) == set(params)


@pytest.mark.parametrize("seed", [0, 9])
def test_offline_init_bit_for_bit(seed):
    jcfg = dataclasses.replace(jenc.KNOWN_ARCHS["answerdotai/ModernBERT-base"],
                               vocab_size=101, hidden_size=32, num_layers=3, num_heads=4,
                               intermediate_size=40)
    tree = tmb.init_modernbert_params(seed, tenc.EncoderConfig(**dataclasses.asdict(jcfg)))
    jtree = jmb.init_modernbert_params(seed, jcfg)
    for group in ("embeddings", "layers"):
        assert list(tree[group]) == list(jtree[group])
        for k, v in jtree[group].items():
            assert np.array_equal(tree[group][k], np.asarray(v)), k
    assert np.array_equal(tree["final_ln_scale"], np.asarray(jtree["final_ln_scale"]))


def test_int8_request_runs_float(checkpoint, caplog):
    path, _ = checkpoint
    with caplog.at_level(logging.WARNING):
        enc = tenc.Encoder(str(path), device="cpu", compute_dtype="float32",
                           quantization="int8")
    assert enc.quantization is None and "'modernbert'" in caplog.text
    assert "layers.0.wqkv" in enc.params
    assert enc._attn_impl(60) == "einsum"


@pytest.fixture(scope="module")
def bpe_checkpoint(tmp_path_factory):
    """A tiny ModernBERT sized to the committed BPE fixture's vocabulary,
    with its ``tokenizer.json``."""
    import json

    vocab = json.loads((FIXTURE / "tokenizer.json").read_text())["model"]["vocab"]
    torch.manual_seed(2)
    d = tmp_path_factory.mktemp("modernbert_bpe")
    transformers.ModernBertModel(_config(vocab_size=len(vocab))).save_pretrained(d)
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(FIXTURE / f, d / f)
    return d


def _intents(block):
    import json

    data = json.loads((REPO / "data" / "intents.json").read_text())
    if block == "train":
        rows = [(t, lbl) for lbl, ts in data["train"].items() for t in ts]
    else:
        rows = [(t, lbl) for lbl in data["train"] for t in data["test"][lbl]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def test_classifier_matches_jax_and_round_trips(bpe_checkpoint, tmp_path):
    """add_examples on intents' train rows, predict_batch on its test rows,
    in both packages (float32, ridge head): every JAX top-1 score within
    1e-4 in the port's answer, and the same top-1 where the JAX package's
    first two scores are more than 1e-5 apart (random weights put most rows
    on near-ties, the top three classes at 1/3 to within ~1e-6, as
    ``tests/test_torch_offline_encoder.py`` finds for bert-tiny); then save
    → load gives the same answers."""
    config = {"head_type": "ridge", "compute_dtype": "float32", "embedding_cache_size": 0}
    clf = AdaptiveClassifier(str(bpe_checkpoint), device="cpu", config=dict(config))
    jclf = JaxClassifier(str(bpe_checkpoint), config=dict(config))
    assert type(clf.encoder.tokenizer).__name__ == type(jclf.encoder.tokenizer).__name__
    texts, labels = _intents("train")
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    test_t, _ = _intents("test")
    got, want = clf.predict_batch(test_t, k=3), jclf.predict_batch(test_t, k=3)
    decided = [w[0][1] - w[1][1] > 1e-5 for w in want]
    for g, w, d in zip(got, want, decided):
        assert abs(dict(g).get(w[0][0], 0.0) - w[0][1]) < 1e-4
        if d:
            assert g[0][0] == w[0][0]
    clf.save(tmp_path / "saved")
    back = AdaptiveClassifier.load(tmp_path / "saved", device="cpu")
    assert back.encoder.config == clf.encoder.config
    again = back.predict_batch(test_t, k=3)
    assert [a[0][0] for a in again] == [g[0][0] for g in got]
    assert max(abs(s - dict(g)[lbl]) for a, g in zip(again, got) for lbl, s in a
               if lbl in dict(g)) < 1e-5
