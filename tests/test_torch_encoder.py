"""The port's encoder, tokenizer and checkpoint reader against the JAX
package's, on identical inputs and weights (CPU, float32)."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file
from safetensors.torch import save_file as st_save_torch

from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from adaptive_classifier_tpu_torch import io_safetensors
from adaptive_classifier_tpu_torch.convert import encoder_params_from_jax
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models.tokenizer import WordPieceTokenizer

REPO = Path(__file__).resolve().parent.parent
CKPTS = REPO / "checkpoints"

_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps", "pad_token_id", "arch", "pooling", "pool_layer")


def _port_cfg(jcfg) -> tenc.EncoderConfig:
    return tenc.EncoderConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS})


def _ids_and_mask(seed, B, S, vocab):
    r = np.random.default_rng(seed)
    ids = r.integers(1, vocab, size=(B, S)).astype(np.int32)
    lens = r.integers(3, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("pooling,pool_layer", [("mean", 0), ("cls", 0), ("mean", 1)])
def test_forward_matches_jax(S, pooling, pool_layer):
    jcfg = jenc.EncoderConfig(vocab_size=97, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate_size=128,
                              max_position_embeddings=128, pooling=pooling,
                              pool_layer=pool_layer)
    jparams = jenc.init_params(7, jcfg)
    ids, mask = _ids_and_mask(S, 5, S, jcfg.vocab_size)
    j_hidden = np.asarray(jenc.encoder_forward(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
        compute_dtype=jnp.float32, attn_impl="einsum"))
    j_emb = np.asarray(jenc.embed_texts_device(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
        compute_dtype=jnp.float32, pooling=pooling, attn_impl="einsum"))

    cfg = _port_cfg(jcfg)
    params = encoder_params_from_jax(jparams)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    hidden = tenc.encoder_forward(params, ids_t, mask_t, cfg,
                                  compute_dtype=torch.float32, attn_impl="fusedqkv")
    emb = tenc.embed_texts_device(params, ids_t, mask_t, cfg,
                                  compute_dtype=torch.float32)
    # f32 on both sides; matmul and reduction order differ
    np.testing.assert_allclose(hidden.numpy(), j_hidden, atol=1e-4)
    np.testing.assert_allclose(emb.numpy(), j_emb, atol=1e-4)


def test_bf16_forward_matches_jax():
    """The whole bf16 forward: each linear layer rounds once, as the JAX
    package's (``tests/test_torch_linear.py``), so the hidden states of the
    valid tokens equal the JAX forward's bit for bit on at least 98% of the
    values (0.995 measured on the CPU; 0.846 while the products rounded to
    bf16 before the bias)."""
    jcfg = jenc.EncoderConfig(vocab_size=97, hidden_size=128, num_layers=2,
                              num_heads=4, intermediate_size=512,
                              max_position_embeddings=128)
    jparams = jenc.init_params(7, jcfg)
    ids, mask = _ids_and_mask(0, 8, 32, jcfg.vocab_size)
    want = np.asarray(jenc.encoder_forward(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
        compute_dtype=jnp.bfloat16, attn_impl="einsum"))
    params = encoder_params_from_jax(jparams, matrix_dtype=torch.bfloat16)
    got = tenc.encoder_forward(params, torch.from_numpy(ids), torch.from_numpy(mask),
                               _port_cfg(jcfg), compute_dtype=torch.bfloat16,
                               attn_impl="einsum").numpy()
    valid = mask.astype(bool)
    equal = float((got[valid] == want[valid]).mean())
    err = float(np.abs(got[valid] - want[valid]).max())
    print(f"bf16 forward: {equal:.6f} of the hidden values equal the JAX forward's, "
          f"max abs error {err:.3g}")
    assert equal >= 0.98
    assert err <= 0.05


def test_params_layout():
    jcfg = jenc.EncoderConfig(vocab_size=50, hidden_size=32, num_layers=3,
                              num_heads=2, intermediate_size=64)
    jparams = jenc.init_params(1, jcfg)
    params = encoder_params_from_jax(jparams, matrix_dtype=torch.bfloat16)
    lay = jparams["layers"]
    assert params["layers.2.qkv_w"].shape == (32, 96)
    assert params["layers.2.qkv_w"].dtype == torch.bfloat16
    assert params["layers.2.qkv_b"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["layers.1.qkv_b"].numpy(),
        np.concatenate([lay["q_b"][1], lay["k_b"][1], lay["v_b"][1]]))
    np.testing.assert_array_equal(params["embeddings.word"].numpy(),
                                  np.asarray(jparams["embeddings"]["word"]))


@pytest.mark.parametrize("name", ["ac-tiny", "ac-small", "ac-base-v2"])
def test_read_hf_config_matches_jax(name):
    jcfg = jenc._read_hf_config(CKPTS / name)
    assert tenc._read_hf_config(CKPTS / name) == _port_cfg(jcfg)


def test_map_hf_weights_matches_jax():
    path = CKPTS / "ac-tiny"
    jcfg = jenc._read_hf_config(path)
    jtree = jenc._map_hf_weights(jenc._load_state_dict(path), jcfg)
    tree = tenc._map_hf_weights(tenc._load_state_dict(path), _port_cfg(jcfg))
    for group in ("embeddings", "layers"):
        assert set(tree[group]) == set(jtree[group])
        for k, v in jtree[group].items():
            np.testing.assert_array_equal(tree[group][k], np.asarray(v), err_msg=k)


def test_encoder_embed_matches_jax():
    texts = ["where is my card?", "I was charged twice for a top-up",
             "change my PIN", "the exchange rate looks wrong today", ""]
    jax_enc = jenc.Encoder(str(CKPTS / "ac-tiny"), compute_dtype="float32")
    enc = tenc.Encoder(str(CKPTS / "ac-tiny"), compute_dtype="float32", device="cpu")
    assert enc._attn_impl(64) == "einsum"
    got = enc.embed(texts).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_enc.embed(texts)), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_encoder_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.Encoder(str(CKPTS / "ac-tiny"))


def test_encoder_rejects_int8(caplog):
    """The int8 forward takes BERT, DistilBERT, RoBERTa and projection-free
    ELECTRA: int8 for another family logs the JAX package's warning and
    resolves to float.  A quantization other than None, "int8" and "auto"
    runs the float forward and is kept as given, as the JAX package's
    encoder keeps it (it tests only for "int8")."""
    with caplog.at_level("WARNING"):
        assert tenc.check_int8_arch(tenc.EncoderConfig(arch="mpnet"), "int8") is None
    assert "'mpnet'" in caplog.text
    assert tenc.check_int8_arch(tenc.EncoderConfig(arch="roberta"), "int8") == "int8"
    unknown = tenc.Encoder(str(CKPTS / "ac-tiny"), device="cpu", quantization="int4",
                           compute_dtype="float32")
    plain = tenc.Encoder(str(CKPTS / "ac-tiny"), device="cpu", compute_dtype="float32")
    assert unknown.quantization == "int4"
    texts = ["where is my card", "how do I reset my password"]
    assert torch.equal(unknown.embed(texts), plain.embed(texts))


def _intent_texts():
    data = json.loads((REPO / "data" / "intents.json").read_text())
    texts = []
    for split in ("train", "new_classes", "test"):
        for rows in data[split].values():
            texts.extend(rows)
    return texts


@pytest.mark.parametrize("name", ["ac-tiny", "ac-base-v2"])
def test_tokenizer_matches_jax(name):
    texts = _intent_texts()
    assert len(texts) > 300
    jtok = JaxWordPiece.from_pretrained(str(CKPTS / name))
    tok = WordPieceTokenizer.from_pretrained(str(CKPTS / name))
    for i in range(0, len(texts), 64):
        part = texts[i:i + 64]
        jids, jmask = jtok(part, max_length=512, pad_to_buckets=(32, 64, 128, 256, 512))
        ids, mask = tok(part, max_length=512, pad_to_buckets=(32, 64, 128, 256, 512))
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("max_length,buckets", [(16, None), (64, (8, 32)),
                                                (512, (32, 64, 128))])
def test_tokenizer_truncates_like_jax(max_length, buckets):
    texts = [" ".join(["refund"] * 100), "hi"]
    jtok = JaxWordPiece.from_pretrained(str(CKPTS / "ac-tiny"))
    tok = WordPieceTokenizer.from_pretrained(str(CKPTS / "ac-tiny"))
    for got, want in zip(tok(texts, max_length, pad_to_buckets=buckets),
                         jtok(texts, max_length, pad_to_buckets=buckets)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rel", ["ac-tiny/model.safetensors",
                                 "zoo/banking-intents/model.safetensors"])
def test_safetensors_reader_matches_library(rel):
    want = st_load_file(str(CKPTS / rel))
    got = io_safetensors.load_file(CKPTS / rel)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def test_safetensors_reader_dtypes(tmp_path):
    r = np.random.default_rng(0)
    arrays = {"f16": r.standard_normal((3, 5)).astype(np.float16),
              "i64": r.integers(-9, 9, size=(7,)).astype(np.int64),
              "f32": r.standard_normal((2, 2, 2)).astype(np.float32)}
    st_save_file(arrays, str(tmp_path / "a.safetensors"))
    got = io_safetensors.load_file(tmp_path / "a.safetensors")
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    bf = torch.randn(4, 6).to(torch.bfloat16)
    st_save_torch({"bf": bf}, str(tmp_path / "b.safetensors"))
    got = io_safetensors.load_file(tmp_path / "b.safetensors")["bf"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().numpy())


def test_safetensors_reader_rejects_truncated(tmp_path):
    src = (CKPTS / "zoo/banking-intents/model.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(src[: len(src) // 2])
    with pytest.raises(ValueError, match="outside the file"):
        io_safetensors.load_file(tmp_path / "cut.safetensors")
