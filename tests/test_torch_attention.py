"""Packed-QKV attention (kernel B1): the port's plain version against the
JAX package's ``attention_from_qkv`` run in Pallas interpret mode, and the
port wrapper's checks.  The CUDA kernel itself is held to the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu.ops.attention_qkv import (
    attention_from_qkv as jax_attention_from_qkv,
)
from adaptive_classifier_tpu_torch.ops.attention_qkv import (
    attention_from_qkv,
    attention_from_qkv_ref,
    check_envelope,
)


def _inputs(seed, B, S, H, Dh, ragged=True):
    r = np.random.default_rng(seed)
    qkv = r.standard_normal((B, S, 3 * H * Dh)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    if ragged:
        mask[0, S // 2:] = 0
        if B > 1:
            mask[-1, S - 8:] = 0
    return qkv, mask


def _jax(qkv, mask, H, Dh, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_attention_from_qkv(jnp.asarray(qkv, dtype), jnp.asarray(mask), H, Dh)
    return np.asarray(out.astype(jnp.float32))


# the shapes of tests/test_attention_qkv.py, plus one more ragged mask and a
# narrow head
@pytest.mark.parametrize("B,S,H,Dh", [
    (2, 64, 12, 64),
    (4, 64, 8, 64),
    (2, 128, 12, 64),
    (1, 64, 3, 64),
    (2, 64, 4, 32),
    (3, 32, 2, 16),
])
def test_plain_matches_jax_f32(B, S, H, Dh):
    qkv, mask = _inputs(0, B, S, H, Dh)
    expect = _jax(qkv, mask, H, Dh)
    got = attention_from_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), H, Dh)
    # f32 on both sides; the sums run in another order
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5, rtol=2e-5)


def test_plain_matches_jax_bf16():
    B, S, H, Dh = 2, 64, 12, 64
    qkv, mask = _inputs(1, B, S, H, Dh)
    expect = _jax(qkv, mask, H, Dh, dtype=jnp.bfloat16)
    qkv_bf16 = torch.from_numpy(qkv).to(torch.bfloat16)
    got = attention_from_qkv(qkv_bf16, torch.from_numpy(mask), H, Dh)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # bf16 inputs, f32 scores: the two frameworks round at other places
    cos = (got * expect).sum() / (np.linalg.norm(got) * np.linalg.norm(expect))
    assert cos > 0.999
    np.testing.assert_allclose(got, expect, atol=0.05)


def _bit_equal_share(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).mean())


def _b6_order(qkv, mask, H, Dh):
    """The softmax in B6's order of rounding: p = exp(s - m) rounded to bf16
    before the PV product, the division by the row sum after it."""
    B, S, _ = qkv.shape
    D = H * Dh
    x = torch.from_numpy(qkv).to(torch.bfloat16).float()
    q, k, v = (x[..., j * D:(j + 1) * D].reshape(B, S, H, Dh) for j in range(3))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(Dh) + torch.where(
        torch.from_numpy(mask)[:, None, None, :] > 0, 0.0, -1e9)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v)
    ctx = ctx / p.sum(-1).transpose(1, 2)[..., None]
    return ctx.reshape(B, S, D).to(torch.bfloat16).float().numpy()


# B1 rounds p to the input type after the softmax's division
# (adaptive_classifier_tpu/ops/attention_qkv.py:40-44, :81-82): in bf16 the
# plain version, the kernel's yardstick on the card, gives JAX's output bit
# for bit on almost every element; B6's order (divide after the PV product)
# moves about half of them by one bf16 step
@pytest.mark.parametrize("B,S", [(8, 32), (2, 128), (4, 24)])
def test_plain_rounds_like_jax_bf16(B, S):
    H, Dh = 4, 64
    qkv, mask = _inputs(10 + S, B, S, H, Dh)
    want = _jax(qkv, mask, H, Dh, dtype=jnp.bfloat16)
    got = attention_from_qkv_ref(torch.from_numpy(qkv).to(torch.bfloat16),
                                 torch.from_numpy(mask), H, Dh).float().numpy()
    assert _bit_equal_share(got, want) >= 0.99
    assert _bit_equal_share(_b6_order(qkv, mask, H, Dh), want) < 0.95


def test_fully_masked_row_is_uniform_average():
    B, S, H, Dh = 2, 64, 2, 64
    qkv, mask = _inputs(2, B, S, H, Dh, ragged=False)
    qkv *= 0.1
    mask[1] = 0                                   # every key of row 1 masked
    got = attention_from_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), H, Dh)
    got = got.numpy()
    assert np.isfinite(got).all()
    D = H * Dh
    uniform = qkv[1, :, 2 * D:].mean(axis=0)      # mean of V over all keys
    np.testing.assert_allclose(got[1], np.broadcast_to(uniform, (S, D)), atol=1e-5)
    np.testing.assert_allclose(got, _jax(qkv, mask, H, Dh), atol=2e-5)


def test_ref_is_the_cpu_path():
    qkv, mask = _inputs(3, 2, 32, 4, 16)
    q, m = torch.from_numpy(qkv), torch.from_numpy(mask)
    assert torch.equal(attention_from_qkv(q, m, 4, 16),
                       attention_from_qkv_ref(q, m, 4, 16))


@pytest.mark.parametrize("shape,H,Dh,dtype,match", [
    ((2, 64, 3 * 4 * 32), 4, 32, torch.float16, "dtype"),
    ((2, 64, 3 * 1 * 136), 1, 136, torch.float32, "head_dim"),
    ((2, 64, 3 * 4 * 12), 4, 12, torch.float32, "head_dim"),
    ((2, 60, 3 * 4 * 32), 4, 32, torch.float32, "multiple of 8"),
    ((2, 64, 3 * 4 * 32), 8, 32, torch.float32, "width"),
    ((64, 3 * 4 * 32), 4, 32, torch.float32, "qkv must be"),
])
def test_wrapper_rejects_outside_envelope(shape, H, Dh, dtype, match):
    qkv = torch.zeros(shape, dtype=dtype)
    mask = torch.ones(shape[:2] if len(shape) == 3 else (1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        attention_from_qkv(qkv, mask, H, Dh)


def test_wrapper_rejects_mask_shape():
    with pytest.raises(ValueError, match="mask shape"):
        check_envelope(torch.zeros(2, 64, 3 * 64), torch.ones(2, 32), 1, 64)


def test_wrapper_has_no_path_for_other_devices():
    qkv = torch.zeros(1, 8, 3 * 8, device="meta")
    mask = torch.ones(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no path"):
        attention_from_qkv(qkv, mask, 1, 8)
