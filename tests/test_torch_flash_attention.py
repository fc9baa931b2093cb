"""Flash (B6) and one-shot (B7) attention: the port's plain versions against
the JAX package's ``flash_attention`` / ``oneshot_attention`` run in Pallas
interpret mode, the port wrappers' checks, and the float and int8 encoder
forwards through both paths against the JAX package's on ac-tiny.  The CUDA
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

The JAX wrappers pad S to their TPU tiles with masked keys and pad Dh to
128 with a pre-scale of q; the port pads nothing.  Rows with at least one
valid key compute the same function; a fully masked row differs (the JAX
package averages V over the padded length, the port over S), so the
comparisons take valid query rows of batch rows with valid keys.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models import encoder_int8 as jenc8
from adaptive_classifier_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    oneshot_attention as jax_oneshot,
)
from adaptive_classifier_tpu_torch import convert
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models import encoder_int8 as tenc8
from adaptive_classifier_tpu_torch.ops import flash_attention as fa

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "checkpoints" / "ac-tiny"

_JAX = {"flash": jax_flash, "oneshot": jax_oneshot}
_PORT = {"flash": fa.flash_attention, "oneshot": fa.oneshot_attention}
_REF = {"flash": fa.flash_attention_ref, "oneshot": fa.oneshot_attention_ref}


def _inputs(seed, B, S, H, Dh):
    """q, k, v ``[B, S, H, Dh]`` and a ragged mask: row 0 keeps its first
    third, row 1 all but its last 8 keys (where S allows), the rest all."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, S, H, Dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[0, S // 3:] = 0
    if B > 1 and S > 8:
        mask[1, S - 8:] = 0
    return q, k, v, mask


def _jax(kernel, q, k, v, mask, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = _JAX[kernel](*(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(mask))
    return np.asarray(out.astype(jnp.float32))


def _valid_rows(x, mask):
    return np.concatenate([x[b][mask[b] > 0] for b in range(len(mask))])


@pytest.mark.parametrize("kernel", ["flash", "oneshot"])
@pytest.mark.parametrize("S,Dh", [(32, 32), (32, 64), (128, 32), (128, 64),
                                  (131, 32), (131, 64), (256, 32), (256, 64)])
def test_plain_matches_jax_f32(kernel, S, Dh):
    q, k, v, mask = _inputs(S + Dh, 3, S, 2, Dh)
    want = _jax(kernel, q, k, v, mask, jnp.float32)
    got = _PORT[kernel](*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))
    assert got.shape == q.shape and got.dtype == torch.float32
    # f32 on both sides; sums in another order and JAX's q pre-scale
    np.testing.assert_allclose(_valid_rows(got.numpy(), mask), _valid_rows(want, mask),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["flash", "oneshot"])
@pytest.mark.parametrize("S,Dh", [(32, 64), (128, 64), (131, 32), (256, 64)])
def test_plain_matches_jax_bf16(kernel, S, Dh):
    q, k, v, mask = _inputs(S * Dh, 2, S, 3, Dh)
    want = _valid_rows(_jax(kernel, q, k, v, mask, jnp.bfloat16), mask)
    got = _PORT[kernel](*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                        torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = _valid_rows(got.float().numpy(), mask)
    # bf16 probabilities rounded at other places (the JAX wrapper also
    # rounds its pre-scaled q to bf16 a second time)
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.999
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


@pytest.mark.parametrize("kernel", ["flash", "oneshot"])
def test_fully_masked_row_is_uniform_average(kernel):
    q, k, v, mask = _inputs(5, 2, 72, 2, 32)
    q, k = 0.1 * q, 0.1 * k
    mask[1] = 0
    got = _PORT[kernel](*(torch.from_numpy(x) for x in (q, k, v)),
                        torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=0), got[1].shape),
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["flash", "oneshot"])
def test_wrapper_is_the_plain_version_on_the_cpu(kernel):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(6, 2, 40, 2, 16))
    assert torch.equal(_PORT[kernel](q, k, v, mask), _REF[kernel](q, k, v, mask))


def test_flash_tiles_agree_with_one_tile():
    """The recurrence over 64-key tiles computes the whole-row softmax: in
    f32 it agrees with the one-shot version to the last bits."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(7, 2, 200, 2, 32))
    np.testing.assert_allclose(fa.flash_attention_ref(q, k, v, mask).numpy(),
                               fa.oneshot_attention_ref(q, k, v, mask).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("shape,dtype,change,match", [
    ((2, 16, 2, 32), torch.float16, None, "dtype"),
    ((2, 16, 1, 136), torch.float32, None, "head_dim"),
    ((2, 16, 64), torch.float32, None, "must be"),
    ((2, 16, 2, 32), torch.float32, "k", "shapes differ"),
    ((2, 16, 2, 32), torch.float32, "v_dtype", "dtypes"),
    ((2, 16, 2, 32), torch.float32, "mask", "mask shape"),
])
def test_wrappers_reject_outside_envelope(shape, dtype, change, match):
    q = torch.zeros(shape, dtype=dtype)
    k, v = q.clone(), q.clone()
    mask = torch.ones(shape[:2], dtype=torch.int32)
    if change == "k":
        k = torch.zeros(2, 8, 2, 32)
    elif change == "v_dtype":
        v = v.to(torch.bfloat16)
    elif change == "mask":
        mask = torch.ones(2, 8, dtype=torch.int32)
    for fn in _PORT.values():
        with pytest.raises(ValueError, match=match):
            fn(q, k, v, mask)


def test_oneshot_refuses_rows_longer_than_its_score_block():
    S = fa.MAX_ONESHOT_S + 8
    q = torch.zeros(1, S, 1, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fa.oneshot_attention(q, q, q, torch.ones(1, S, dtype=torch.int32))


def test_wrappers_have_no_path_for_other_devices():
    q = torch.zeros(1, 8, 1, 8, device="meta")
    mask = torch.ones(1, 8, dtype=torch.int32, device="meta")
    for fn in _PORT.values():
        with pytest.raises(ValueError, match="no path"):
            fn(q, q, q, mask)


# ---------------------------------------------------------------------------
# the encoder forwards through B6 and B7 (ac-tiny, CPU: the plain versions)
# ---------------------------------------------------------------------------

_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps", "pad_token_id", "arch", "pooling", "pool_layer")


@pytest.fixture(scope="module")
def tiny():
    """ac-tiny in both packages (float32 tree and eager int8 state) and a
    tokenized batch of intent texts."""
    jcfg = jenc._read_hf_config(TINY)
    jtree = jenc._map_hf_weights(jenc._load_state_dict(TINY), jcfg)
    cfg = tenc.EncoderConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS})
    jq = jenc8.quantize_encoder_for_inference(jtree)
    data = json.loads((REPO / "data" / "intents.json").read_text())
    texts = [t for rows in data["test"].values() for t in rows][:24] + ["", "hi"]
    enc = tenc.Encoder(str(TINY), compute_dtype="float32", device="cpu")
    ids, mask = enc.tokenizer(texts, max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    return (jcfg, jtree, jq, cfg, convert.encoder_params_from_jax(jtree),
            convert.encoder_int8_params_from_jax(jq), ids, mask)


@pytest.mark.parametrize("impl", ["flash", "oneshot"])
def test_float_forward_matches_jax(tiny, impl):
    jcfg, jtree, _, cfg, params, _, ids, mask = tiny
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc.embed_texts_device(
            jtree, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.float32,
            pooling=jcfg.pooling, attn_impl=impl))
    got = tenc.embed_texts_device(params, torch.from_numpy(ids), torch.from_numpy(mask),
                                  cfg, compute_dtype=torch.float32, attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "oneshot"])
def test_int8_forward_matches_jax(tiny, impl):
    """Per-row int8 requantization turns last-bit differences into int8
    steps: the two packages' int8 embeddings differ by up to 1.7e-3 on
    these texts through every attention path, einsum included (cosine
    >= 0.99998), so the bound is the int8 envelope, not 1e-4."""
    jcfg, _, jq, cfg, _, qparams, ids, mask = tiny
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc8.embed_texts_device_int8(
            jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.float32,
            pooling=jcfg.pooling, attn_impl=impl))
    got = tenc8.embed_texts_device_int8(qparams, torch.from_numpy(ids),
                                        torch.from_numpy(mask), cfg,
                                        compute_dtype=torch.float32,
                                        pooling=cfg.pooling, attn_impl=impl)
    got = got.numpy()
    assert ((got * want).sum(-1)).min() >= 0.9999
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "oneshot"])
def test_fused_int8_forward_matches_jax(tiny, impl):
    """The fused int8 forward (B2, B3 plain versions, and B8 with
    ``fuse_o_proj``) through B6/B7 against the JAX package's with its
    Pallas kernels in interpret mode.  B3/B8 requantize a GELU output, where
    a last-bit difference moves an int8 value by one step: on ac-tiny every
    attention path, the packed-QKV one included, agrees per token row to
    cosine 0.99974 (0.99979 einsum), so the bound is 0.999."""
    jcfg, _, jq, cfg, _, qparams, ids, mask = tiny
    for fuse in (False, True):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jenc8.encoder_forward_int8(
                jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.float32,
                use_fused_ffn=True, fuse_o_proj=fuse, attn_impl=impl))
        got = tenc8.encoder_forward_int8(qparams, torch.from_numpy(ids),
                                         torch.from_numpy(mask), cfg,
                                         compute_dtype=torch.float32, use_fused_ffn=True,
                                         fuse_o_proj=fuse, attn_impl=impl).numpy()
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999


def test_forward_paths_agree_in_bf16(tiny):
    """bf16: flash, oneshot and the packed-QKV attention give the same
    embeddings to within bf16 rounding."""
    _, _, _, cfg, _, _, ids, mask = tiny
    params = tenc.params_from_tree(tenc._map_hf_weights(tenc._load_state_dict(TINY), cfg),
                                   matrix_dtype=torch.bfloat16)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    base = tenc.embed_texts_device(params, ids_t, mask_t, cfg, attn_impl="fusedqkv")
    for impl in ("flash", "oneshot"):
        got = tenc.embed_texts_device(params, ids_t, mask_t, cfg, attn_impl=impl)
        assert ((got * base).sum(-1)).min() >= 0.999


def test_unknown_attn_impl_raises(tiny):
    _, _, _, cfg, params, qparams, ids, mask = tiny
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="attn_impl"):
        tenc.encoder_forward(params, ids_t, mask_t, cfg, attn_impl="ring")
    with pytest.raises(ValueError, match="attn_impl"):
        tenc8.encoder_forward_int8(qparams, ids_t, mask_t, cfg, attn_impl="ring")
