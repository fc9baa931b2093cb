"""Fused residual add + LayerNorm.

Counterpart of ``adaptive_classifier_tpu/ops/layernorm.py``:
``LayerNorm(x + resid)`` with the sum, the mean and the two-pass variance
``mean((s − mean)²)`` in f32, scale and bias in f32, the result in x's type.

- ``add_layer_norm_ref``: the plain torch version (``resid`` may be None,
  the embedding LayerNorm); the CPU path, the encoder's LayerNorm wherever
  the fused kernel is off, and the yardstick the kernel is held to on the
  GPU.
- ``add_layer_norm``: the wrapper.  A CPU tensor takes the plain version; a
  CUDA tensor launches ``csrc/add_layernorm.cu`` (kernel B10) or raises.

The JAX package keeps its Pallas kernel off (``use_fused_ln = False`` in its
encoder) on its own TPU measurement, where XLA already fuses the epilogue.
Eager PyTorch fuses nothing, so the port decides the switch on the card
(``models/encoder._FUSED_LN_ON_CUDA``, PERF.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, count_launch, refuse_autograd

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel holds a row in registers, at most 8 16-byte vectors a lane
_MAX_VECTORS = 32 * 8


def add_layer_norm_ref(x: torch.Tensor, resid: Optional[torch.Tensor],
                       scale: torch.Tensor, bias: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """``LayerNorm(x + resid)`` with f32 statistics → dtype of ``x``."""
    s = x.float() if resid is None else x.float() + resid.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    y = (s - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def check_envelope(x: torch.Tensor, resid: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor):
    """Raise ValueError unless the inputs are what the kernel takes."""
    if x.dim() < 1 or resid.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and resid {tuple(resid.shape)} must "
                         f"share one [..., D] shape")
    if x.dtype not in _DTYPE_CODES or resid.dtype != x.dtype:
        raise ValueError(f"x, resid dtypes {x.dtype}, {resid.dtype}: the kernel "
                         f"takes one of float32/bfloat16")
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} "
                         f"must be [{D}]")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("scale and bias must be float32")
    per_vec = 16 // x.element_size()
    if D % per_vec or D // per_vec > _MAX_VECTORS:
        raise ValueError(f"D={D}: the kernel takes D a multiple of {per_vec} and at "
                         f"most {_MAX_VECTORS * per_vec} for {x.dtype}")


def add_layer_norm(x: torch.Tensor, resid: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``LayerNorm(x + resid)`` over the last dimension of ``[..., D]``: the
    plain version for a CPU tensor, kernel B10 for a CUDA tensor."""
    check_envelope(x, resid, scale, bias)
    if x.device.type == "cpu":
        return add_layer_norm_ref(x, resid, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm has no path for device {x.device}")
    if any(t.device != x.device for t in (resid, scale, bias)):
        raise ValueError(f"x, resid, scale and bias must share one device ({x.device})")
    refuse_autograd("add_layer_norm", x, resid, scale, bias)
    tensors = (x, resid, scale, bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, resid, scale and bias must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, resid, scale and bias must be 16-byte aligned")
    D = x.shape[-1]
    R = x.numel() // D
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ac_add_layer_norm(x.data_ptr(), resid.data_ptr(), scale.data_ptr(),
                                    bias.data_ptr(), float(eps), out.data_ptr(), R, D,
                                    _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "add_layer_norm launch")
    count_launch("add_layer_norm")
    return out
