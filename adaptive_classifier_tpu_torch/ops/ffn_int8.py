"""The fused int8 FFN block (kernel B3) and the whole post-attention layer
body (kernel B8).

Counterpart of ``adaptive_classifier_tpu/ops/ffn_int8.py``.

- ``ffn_block_int8`` (B3): ``LN(q(gelu_tanh(q(h) @ W1 · s1 + b1)) @ W2 · s2
  + b2 + h)``, every product int8×int8→int32, the LayerNorm with f32
  statistics, in h's type.
- ``attn_ffn_block_int8`` (B8): the O-projection ``q(ctx) @ Wo · so + bo``,
  plus x, LayerNorm 1, then B3's body on that f32 result and LayerNorm 2,
  in ctx's type.

``q()`` is the per-row symmetric int8 quantization with scale
``absmax / 127``; the GELU is the tanh form (``_gelu_tanh``), not the float
path's erf.  Each wrapper takes its plain version (``*_ref``) for a CPU
tensor and launches its CUDA kernel (``csrc/ffn_int8.cu``) for a CUDA
tensor, or raises; there is no fallback between them.  Where the f32 GELU
tile does not fit a block (bert-base's F = 3,072), the kernel computes the
first product twice, once for each row's GELU maximum and once to quantize
the same values, and returns what the one-pass kernel would.  The plain
versions repeat the kernels' arithmetic step for step; a last-ulp
difference of ``tanh`` can move one requantized GELU value by one int8
step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .matmul_int8 import (_DTYPE_CODES, check_rows, check_weight, cuda_args,
                          int8_matmul, launch, layer_norm, quant_rows)

#: tanh-approximation GELU constants (the "gelu_new" form), float32
_G0 = float(np.float32(np.sqrt(2.0 / np.pi)))
_G1 = float(np.float32(0.044715))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³)))``, in the JAX
    package's order of operations."""
    inner = _G0 * (x + _G1 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _ffn_body(h: torch.Tensor, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias,
              eps: float) -> torch.Tensor:
    """B3's arithmetic on f32 rows h → f32."""
    x_q, x_scale = quant_rows(h, divide=True)
    ff = int8_matmul(x_q, w1_q).float() * x_scale * s1.float() + b1.float()
    ff = _gelu_tanh(ff)
    f_q, f_scale = quant_rows(ff, divide=True)
    y = int8_matmul(f_q, w2_q).float() * f_scale * s2.float() + b2.float()
    return layer_norm(y + h, ln_scale, ln_bias, eps)


def ffn_block_int8_ref(h, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias,
                       eps: float) -> torch.Tensor:
    """Plain version of B3 → ``[M, D]`` in h's type."""
    return _ffn_body(h.float(), w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias,
                     eps).to(h.dtype)


def attn_ffn_block_int8_ref(ctx, x, o_wq, o_s, o_b, ln1_scale, ln1_bias,
                            w1_q, s1, b1, w2_q, s2, b2, ln2_scale, ln2_bias,
                            eps: float) -> torch.Tensor:
    """Plain version of B8 → ``[M, D]`` in ctx's type."""
    c_q, c_scale = quant_rows(ctx.float(), divide=True)
    attn_out = int8_matmul(c_q, o_wq).float() * c_scale * o_s.float() + o_b.float()
    h = layer_norm(attn_out + x.float(), ln1_scale, ln1_bias, eps)
    return _ffn_body(h, w1_q, s1, b1, w2_q, s2, b2, ln2_scale, ln2_bias,
                     eps).to(ctx.dtype)


def _check_ffn(name: str, D: int, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias):
    F = w1_q.shape[-1]
    if F % 128:
        raise ValueError(f"{name}: F={F} must be a multiple of 128")
    check_weight(name, w1_q, D, F, s1, b1)
    check_weight(name, w2_q, F, D, s2, b2, ln_scale, ln_bias)
    return F


def _check_smem(name: str, device: torch.device, D: int, F: int):
    """Raise unless B3's and B8's two-pass row tile, the smaller, fits a
    block of ``device`` (the kernel takes one pass where that fits)."""
    need = _build.library().ac_ffn_int8_smem_bytes(D, F, 1)
    have = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"{name}: D={D}, F={F} needs {need} bytes of shared "
                         f"memory per block, the device has {have}")


def ffn_block_int8(h, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias,
                   eps: float) -> torch.Tensor:
    """B3 → ``[M, D]`` in h's type: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor."""
    name = "ffn_block_int8"
    check_rows(name, h)
    M, D = h.shape
    F = _check_ffn(name, D, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias)
    if h.device.type == "cpu":
        return ffn_block_int8_ref(h, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias, eps)
    ptrs = cuda_args(name, h.device, h, w1_q, s1, b1, w2_q, s2, b2, ln_scale, ln_bias)
    _check_smem(name, h.device, D, F)
    out = torch.empty_like(h)
    launch(name, "ffn_int8", h.device, _build.library().ac_ffn_block_int8, *ptrs,
           float(eps), out.data_ptr(), M, D, F, _DTYPE_CODES[h.dtype])
    return out


def attn_ffn_block_int8(ctx, x, o_wq, o_s, o_b, ln1_scale, ln1_bias,
                        w1_q, s1, b1, w2_q, s2, b2, ln2_scale, ln2_bias,
                        eps: float) -> torch.Tensor:
    """B8 → ``[M, D]`` in ctx's type: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    name = "attn_ffn_block_int8"
    check_rows(name, ctx, x)
    M, D = ctx.shape
    check_weight(name, o_wq, D, D, o_s, o_b, ln1_scale, ln1_bias)
    F = _check_ffn(name, D, w1_q, s1, b1, w2_q, s2, b2, ln2_scale, ln2_bias)
    if ctx.device.type == "cpu":
        return attn_ffn_block_int8_ref(ctx, x, o_wq, o_s, o_b, ln1_scale, ln1_bias,
                                       w1_q, s1, b1, w2_q, s2, b2, ln2_scale,
                                       ln2_bias, eps)
    ptrs = cuda_args(name, ctx.device, ctx, x, o_wq, o_s, o_b, ln1_scale, ln1_bias,
                     w1_q, s1, b1, w2_q, s2, b2, ln2_scale, ln2_bias)
    _check_smem(name, ctx.device, D, F)
    out = torch.empty_like(ctx)
    launch(name, "attn_ffn_int8", ctx.device, _build.library().ac_attn_ffn_block_int8,
           *ptrs, float(eps), out.data_ptr(), M, D, F, _DTYPE_CODES[ctx.dtype])
    return out
