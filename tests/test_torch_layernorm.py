"""Fused add + LayerNorm (kernel B10): the port's plain version against the
JAX package's ``add_layer_norm_pallas`` in Pallas interpret mode, the port
wrapper's checks, and the encoder forward with the fused LayerNorm switched
on.  The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu.ops.layernorm import add_layer_norm_pallas
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.ops import layernorm as ln

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "checkpoints" / "ac-tiny"


def _inputs(seed, R, D):
    r = np.random.default_rng(seed)
    x = (2.0 * r.standard_normal((R, D)) + 0.5).astype(np.float32)
    res = r.standard_normal((R, D)).astype(np.float32)
    scale = (1.0 + 0.1 * r.standard_normal(D)).astype(np.float32)
    bias = (0.1 * r.standard_normal(D)).astype(np.float32)
    return x, res, scale, bias


def _jax(x, res, scale, bias, eps, dtype, tile):
    with pltpu.force_tpu_interpret_mode():
        out = add_layer_norm_pallas(jnp.asarray(x, dtype), jnp.asarray(res, dtype),
                                    jnp.asarray(scale), jnp.asarray(bias), eps=eps,
                                    tile=tile)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("R,D,tile", [(256, 512, 256), (512, 128, 256), (24, 768, 8)])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_plain_matches_pallas_f32(R, D, tile, eps):
    x, res, scale, bias = _inputs(R + D, R, D)
    want = _jax(x, res, scale, bias, eps, jnp.float32, tile)
    got = ln.add_layer_norm(*(torch.from_numpy(a) for a in (x, res, scale, bias)), eps)
    assert got.dtype == torch.float32
    # f32 statistics on both sides, summed in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("R,D,tile", [(256, 512, 256), (24, 768, 8)])
def test_plain_matches_pallas_bf16(R, D, tile):
    x, res, scale, bias = _inputs(R * D, R, D)
    want = _jax(x, res, scale, bias, 1e-12, jnp.bfloat16, tile)
    xb, rb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, res))
    got = ln.add_layer_norm(xb, rb, torch.from_numpy(scale), torch.from_numpy(bias), 1e-12)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the same f32 value rounds to the same bf16 unless the two f32 results
    # straddle a rounding boundary: one bf16 step (2^-7 relative) at most,
    # the step taken at 2^-7 for smaller values, where the f32 results'
    # ~1e-6 absolute difference exceeds a step
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -7))) - 7)
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() > 0.99


def test_plain_without_residual_is_layer_norm():
    x, _, scale, bias = _inputs(1, 16, 64)
    xt = torch.from_numpy(x)
    want = torch.nn.functional.layer_norm(xt, (64,), torch.from_numpy(scale),
                                          torch.from_numpy(bias), eps=1e-12)
    got = ln.add_layer_norm_ref(xt, None, torch.from_numpy(scale),
                                torch.from_numpy(bias), 1e-12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_wrapper_is_the_plain_version_on_the_cpu():
    x, res, scale, bias = (torch.from_numpy(a) for a in _inputs(2, 3 * 40, 256))
    x, res = x.view(3, 40, 256), res.view(3, 40, 256)
    assert torch.equal(ln.add_layer_norm(x, res, scale, bias, 1e-12),
                       ln.add_layer_norm_ref(x, res, scale, bias, 1e-12))


@pytest.mark.parametrize("change,match", [
    ("dtype", "dtype"), ("resid_dtype", "dtype"), ("resid_shape", "shape"),
    ("scale_shape", r"must be \["), ("scale_dtype", "float32"),
    ("D", "multiple of 8"), ("D_wide", "at most"),
])
def test_wrapper_rejects_outside_envelope(change, match):
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    res = torch.zeros_like(x)
    scale, bias = torch.ones(64), torch.zeros(64)
    if change == "dtype":
        x = res = x.half()
    elif change == "resid_dtype":
        res = res.float()
    elif change == "resid_shape":
        res = torch.zeros(4, 32, dtype=torch.bfloat16)
    elif change == "scale_shape":
        scale = torch.ones(32)
    elif change == "scale_dtype":
        scale = scale.to(torch.bfloat16)
    elif change in ("D", "D_wide"):
        D = 60 if change == "D" else 4096
        x, res = torch.zeros(4, D, dtype=torch.bfloat16), torch.zeros(4, D, dtype=torch.bfloat16)
        scale, bias = torch.ones(D), torch.zeros(D)
    with pytest.raises(ValueError, match=match):
        ln.add_layer_norm(x, res, scale, bias, 1e-12)


def test_wrapper_has_no_path_for_other_devices():
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="no path"):
        ln.add_layer_norm(x, x, torch.ones(64, device="meta"),
                          torch.zeros(64, device="meta"), 1e-12)


def test_encoder_forward_with_the_fused_layer_norm():
    """``use_fused_ln=True`` routes the residual LayerNorms through the
    wrapper (its plain version on the CPU: the same function); ``None``
    follows ``_FUSED_LN_ON_CUDA``, which applies to CUDA tensors only."""
    enc = tenc.Encoder(str(TINY), compute_dtype="float32", device="cpu")
    ids, mask = enc.tokenizer(["where is my card?", "change my PIN", ""],
                              max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    outs = [tenc.encoder_forward(enc.params, ids, mask, enc.config,
                                 compute_dtype=torch.float32, use_fused_ln=flag)
            for flag in (None, False, True)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert isinstance(tenc._FUSED_LN_ON_CUDA, bool)
