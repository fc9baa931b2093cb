"""The offline random-weight BERT encoder and the attention policy, against
the JAX package (CPU).

- ``init_params`` draws the JAX package's numpy-RNG weights bit for bit, so
  an offline encoder needs no conversion at all;
- the built-in vocabulary is the JAX package's token for token;
- ``AdaptiveClassifier("prajjwal1/bert-tiny")`` builds the same classifier
  as the JAX package's through ``add_examples`` and answers the same
  ``predict_batch``;
- ``Encoder._attn_impl``: ``AC_ATTN_IMPL`` forces the path as in the JAX
  package (the port's own ``attn_impl`` wins over it), the flash kernel from
  1,024 tokens on a CUDA device, the plain attention on a CUDA device
  outside the packed-QKV kernel's envelope (the JAX package's ``"einsum"``
  there), and a sequence past the position table raises (the JAX
  package's gather clamps there).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models.tokenizer import WordPieceTokenizer

REPO = Path(__file__).resolve().parent.parent
TINY_NAME = "prajjwal1/bert-tiny"
INTENTS = json.loads((REPO / "data" / "intents.json").read_text())

_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps", "pad_token_id", "arch", "pooling", "pool_layer")


def _port_cfg(jcfg) -> tenc.EncoderConfig:
    return tenc.EncoderConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS})


def _assert_trees_equal(tree, jtree):
    for group in ("embeddings", "layers"):
        # the same names in the same order: the draw order
        assert list(tree[group]) == list(jtree[group])
        for name, want in jtree[group].items():
            want = np.asarray(want)
            assert tree[group][name].dtype == want.dtype == np.float32
            assert np.array_equal(tree[group][name], want), name


@pytest.mark.parametrize("name,seed", [(TINY_NAME, 3), ("bert-base-uncased", 0)])
def test_known_archs_match_jax(name, seed):
    jcfg = jenc.config_for_model_name(name)
    assert tenc.config_for_model_name(name) == _port_cfg(jcfg)
    assert tenc.offline_seed(seed, name) == (
        (seed * 1000003 + jenc.hash_name(name) % 65521) & 0x7FFFFFFF)


@pytest.mark.parametrize("name", ["bert-base-cased", "google-bert/bert-large-cased",
                                  "bert-large-uncased", "my-tiny-bert", "some-large-model",
                                  "unknown/model"])
def test_name_resolution_matches_jax(name):
    assert tenc.config_for_model_name(name) == _port_cfg(jenc.config_for_model_name(name))


@pytest.mark.parametrize("cfg_kwargs,seed", [
    ({}, 7),                                       # bert-tiny dims, below
    ({"vocab_size": 97, "hidden_size": 64, "num_layers": 3, "num_heads": 4,
      "intermediate_size": 96, "max_position_embeddings": 40,
      "type_vocab_size": 0}, 11),
])
def test_init_params_bit_for_bit(cfg_kwargs, seed):
    jcfg = (jenc.EncoderConfig(**cfg_kwargs) if cfg_kwargs
            else jenc.config_for_model_name(TINY_NAME))
    _assert_trees_equal(tenc.init_params(seed, _port_cfg(jcfg)),
                        jenc.init_params(seed, jcfg))


@pytest.mark.parametrize("vocab_size", [8192, 28996, 30522])
def test_hermetic_vocabulary_matches_jax(vocab_size):
    tok, jtok = WordPieceTokenizer.hermetic(vocab_size), JaxWordPiece.hermetic(vocab_size)
    assert list(tok.vocab.items()) == list(jtok.vocab.items())
    assert tok.vocab_size == jtok.vocab_size == vocab_size
    texts = [t for rows in INTENTS["test"].values() for t in rows][:64] + [
        "Zürich café — 42 €", ""]
    for got, want in zip(tok(texts, 512, pad_to_buckets=(32, 64)),
                         jtok(texts, 512, pad_to_buckets=(32, 64))):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny_encoders():
    return (tenc.Encoder(TINY_NAME, compute_dtype="float32", device="cpu", seed=42),
            jenc.Encoder(TINY_NAME, compute_dtype="float32", seed=42))


def test_offline_encoder_matches_jax(tiny_encoders):
    enc, jenc_ = tiny_encoders
    assert not enc.pretrained and not jenc_.pretrained
    assert enc.config == _port_cfg(jenc_.config)
    assert list(enc.tokenizer.vocab.items()) == list(jenc_.tokenizer.vocab.items())
    want = convert.encoder_params_from_jax(jenc_.params)
    assert set(enc.params) == set(want)
    for name, w in want.items():
        assert torch.equal(enc.params[name], w), name
    texts = ["where is my card?", "I was charged twice", "change my PIN", ""]
    np.testing.assert_allclose(enc.embed(texts).numpy(), np.asarray(jenc_.embed(texts)),
                               atol=1e-4)


def test_attn_impl_env_matches_jax(tiny_encoders, monkeypatch):
    """With AC_ATTN_IMPL set both packages take the named path (on the CPU
    the port's plain versions, the JAX package's Pallas kernels in
    interpret mode) and agree."""
    enc, jenc_ = tiny_encoders
    texts = ["where is my card?", "the exchange rate looks wrong today", "hi"]
    for impl in ("flash", "oneshot"):
        monkeypatch.setenv("AC_ATTN_IMPL", impl)
        assert enc._attn_impl(64) == jenc_._attn_impl(64) == impl
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jenc_.embed(texts))
        np.testing.assert_allclose(enc.embed(texts).numpy(), want, atol=1e-4)


def test_attn_impl_policy(monkeypatch):
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    enc = tenc.Encoder(str(REPO / "checkpoints" / "ac-tiny"), compute_dtype="float32",
                       device="cpu")
    assert enc._attn_impl(64) == enc._attn_impl(2048) == "einsum"
    # the policy of a CUDA device, asked without one
    enc.device = torch.device("cuda")
    assert enc._attn_impl(64) == "fusedqkv"
    assert enc._attn_impl(1023 + 1) == enc._attn_impl(4096) == "flash"
    # AC_ATTN_IMPL is read on every call, before the policy
    monkeypatch.setenv("AC_ATTN_IMPL", "oneshot")
    assert enc._attn_impl(64) == enc._attn_impl(2048) == "oneshot"
    # the port's own override wins over the environment
    enc.attn_impl = "einsum"
    assert enc._attn_impl(64) == "einsum"
    monkeypatch.setenv("AC_ATTN_IMPL", "")
    enc.attn_impl = None
    assert enc._attn_impl(128) == "fusedqkv"


@pytest.mark.parametrize("hidden,heads,seq_len", [
    (312, 12, 32),    # head_dim 26: TinyBERT-4L-312's shape
    (312, 12, 60),
    (512, 8, 60),     # S % 8 != 0
    (512, 8, 17),
    (640, 4, 64),     # head_dim 160 > 128
])
def test_attn_impl_outside_the_packed_qkv_envelope(monkeypatch, hidden, heads, seq_len):
    """On a CUDA device (asked without one) a head_dim or sequence length
    outside B1's envelope takes the plain attention, as the JAX package
    takes its plain ``jnp`` attention there on a TPU; inside it B1."""
    import dataclasses

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    path = str(REPO / "checkpoints" / "ac-tiny")
    enc = tenc.Encoder(path, compute_dtype="float32", device="cpu")
    jenc_ = jenc.Encoder(path, compute_dtype="float32")
    enc.config = dataclasses.replace(enc.config, hidden_size=hidden, num_heads=heads)
    jenc_.config = dataclasses.replace(jenc_.config, hidden_size=hidden, num_heads=heads)
    enc.device = torch.device("cuda")
    monkeypatch.setattr(jenc.jax, "default_backend", lambda: "tpu")
    assert enc._attn_impl(seq_len) == jenc_._attn_impl(seq_len) == "einsum"
    assert enc._attn_impl(1024) == jenc_._attn_impl(1024) == "flash"
    if hidden // heads <= 128 and (hidden // heads) % 8 == 0:
        assert enc._attn_impl(64) == jenc_._attn_impl(64) == "fusedqkv"


def test_sequence_past_the_position_table_raises():
    cfg = tenc.EncoderConfig(vocab_size=50, hidden_size=32, num_layers=1, num_heads=2,
                             intermediate_size=64, max_position_embeddings=16)
    params = tenc.params_from_tree(tenc.init_params(0, cfg))
    mask = torch.ones(2, 16, dtype=torch.int32)
    ids = torch.ones(2, 16, dtype=torch.int32)
    assert tenc.encoder_forward(params, ids, mask, cfg,
                                compute_dtype=torch.float32).shape == (2, 16, 32)
    ids, mask = torch.ones(2, 17, dtype=torch.int32), torch.ones(2, 17, dtype=torch.int32)
    for impl in ("einsum", "flash"):
        with pytest.raises(ValueError, match="max_position_embeddings=16"):
            tenc.encoder_forward(params, ids, mask, cfg, attn_impl=impl)


def _rows(block):
    if block == "train":
        rows = [(t, l) for l, ts in INTENTS["train"].items() for t in ts]
    else:
        rows = [(t, l) for l in INTENTS["train"] for t in INTENTS["test"][l]]
    return [t for t, _ in rows], [l for _, l in rows]


@pytest.mark.parametrize("config", [
    {"head_type": "ridge"},
    {"lexical_dim": 4096, "head_type": "ridge", "fusion_weights": "auto",
     "ridge_lambda": "auto"},
])
def test_offline_classifier_matches_jax(config):
    """add_examples on intents' train rows, predict_batch on its test rows:
    the same classifier state and the same answers (float32 both sides).
    Random weights put most rows without the lexical channel on near-ties
    (the top three classes at 1/3 to within 1e-6): top-1 labels are
    compared where the JAX package's first two scores are more than 1e-5
    apart (the packages' scores agree to ~2e-7), scores everywhere."""
    config = {**config, "compute_dtype": "float32", "embedding_cache_size": 0}
    clf = AdaptiveClassifier(TINY_NAME, device="cpu", config=dict(config))
    jclf = JaxClassifier(TINY_NAME, config=dict(config))
    texts, labels = _rows("train")
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    assert clf.label_to_id == jclf.label_to_id
    assert clf.config.ridge_lambda == jclf.config.ridge_lambda
    assert clf._fusion_alpha == jclf._fusion_alpha
    want = convert.memory_state_from_jax(jclf.memory.state)
    np.testing.assert_allclose(clf.memory.state.proto.numpy(), want.proto.numpy(),
                               atol=1e-4)
    test_t, _ = _rows("test")
    got, want = clf.predict_batch(test_t, k=3), jclf.predict_batch(test_t, k=3)
    decided = [i for i, w in enumerate(want) if w[0][1] - w[1][1] > 1e-5]
    assert decided
    assert [got[i][0][0] for i in decided] == [want[i][0][0] for i in decided]
    for g, w in zip(got, want):
        gs = dict(g)
        for label, score in w:
            if label in gs:
                assert abs(gs[label] - score) <= 1e-4
