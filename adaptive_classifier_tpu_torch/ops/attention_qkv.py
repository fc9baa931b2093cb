"""All-heads attention straight off the packed QKV projection output.

Counterpart of ``adaptive_classifier_tpu/ops/attention_qkv.py``.  Takes the
fused QKV projection's natural output, one ``[B, S, 3·D]`` row-major tensor,
and returns the O-projection's natural input ``[B, S, D]``: per head,
``softmax(q·kᵀ/√Dh + bias)·v`` with an additive −1e9 bias on padded keys
(queries are not masked), softmax statistics in f32, and the probabilities
rounded to the input type before the PV product.

- ``attention_from_qkv_ref``: the plain torch version; the CPU path, and the
  yardstick the kernel is held to on the GPU.
- ``attention_from_qkv``: the wrapper.  A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel in
  ``csrc/attention_qkv.cu`` or raises.  There is no fallback between them.
  In bf16 the kernel multiplies on the tensor cores in the plain version's
  order of rounding: each row's exact softmax first, then the
  probabilities rounded to bf16.  Rows of more than 64 keys run B7's
  kernel on the packed strides (``wgmma`` fed by TMA,
  ``csrc/attention_hopper.cuh``); shorter rows the ``mma.sync`` tile loop
  of ``csrc/attention_tile.cuh``.
- ``kernel_info``: what the kernel would launch on given inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch, refuse_autograd
from .flash_attention import _info_dict

NEG = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_from_qkv_ref(
    qkv: torch.Tensor,             # [B, S, 3D] packed (q | k | v)
    attention_mask: torch.Tensor,  # [B, S] 1 valid / 0 pad
    num_heads: int,
    head_dim: int,
) -> torch.Tensor:                 # [B, S, D], dtype of qkv
    """Plain torch version: split heads, f32 scores and softmax, then the
    PV product on probabilities rounded to the input type."""
    B, S, _ = qkv.shape
    H, Dh = num_heads, head_dim
    D = H * Dh
    q = qkv[..., :D].reshape(B, S, H, Dh).float()
    k = qkv[..., D:2 * D].reshape(B, S, H, Dh).float()
    v = qkv[..., 2 * D:].reshape(B, S, H, Dh).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG).to(logits)
    probs = torch.softmax(logits + bias, dim=-1)
    probs = probs.to(qkv.dtype).float()
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return ctx.reshape(B, S, D).to(qkv.dtype)


def check_envelope(qkv: torch.Tensor, attention_mask: torch.Tensor,
                   num_heads: int, head_dim: int):
    """Raise ValueError unless the inputs are what the kernel takes."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, S, 3D], got shape {tuple(qkv.shape)}")
    B, S, threeD = qkv.shape
    if threeD != 3 * num_heads * head_dim:
        raise ValueError(f"qkv width {threeD} != 3 * {num_heads} heads * {head_dim}")
    if tuple(attention_mask.shape) != (B, S):
        raise ValueError(f"mask shape {tuple(attention_mask.shape)} != {(B, S)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"qkv dtype {qkv.dtype} not in float32/bfloat16")
    if head_dim > 128 or head_dim % 8:
        raise ValueError(f"head_dim={head_dim}: the kernel takes head_dim <= 128, "
                         f"a multiple of 8")
    if S % 8:
        raise ValueError(f"S={S} must be a multiple of 8")


def attention_from_qkv(
    qkv: torch.Tensor,             # [B, S, 3D] packed (q | k | v), row-major
    attention_mask: torch.Tensor,  # [B, S] 1 valid / 0 pad
    num_heads: int,
    head_dim: int,
) -> torch.Tensor:                 # [B, S, D], dtype of qkv
    """All-heads attention off the packed QKV tensor: the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor."""
    check_envelope(qkv, attention_mask, num_heads, head_dim)
    if qkv.device.type == "cpu":
        return attention_from_qkv_ref(qkv, attention_mask, num_heads, head_dim)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_from_qkv has no path for device {qkv.device}")
    if attention_mask.device != qkv.device:
        raise ValueError(f"mask on {attention_mask.device}, qkv on {qkv.device}")
    refuse_autograd("attention_from_qkv", qkv)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    B, S, _ = qkv.shape
    mask = attention_mask.to(torch.int32).contiguous()
    out = torch.empty((B, S, num_heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.ac_attention_qkv(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                   B, S, num_heads, head_dim,
                                   _DTYPE_CODES[qkv.dtype], stream)
    _build.check(err, "attention_qkv launch")
    count_launch("attention_qkv")
    return out


def kernel_info(qkv: torch.Tensor, num_heads: int, head_dim: int) -> dict:
    """What ``attention_from_qkv`` would launch on this CUDA ``qkv``, as the
    CUDA runtime reports the instantiation: registers per thread, shared
    bytes per block, threads per block, blocks resident per SM, local
    (spill) bytes per thread, consumer warpgroups, the wgmma form
    (``flash_attention.WGMMA_FORMS``) and whether TMA feeds it.  Launches
    nothing."""
    if qkv.device.type != "cuda":
        raise ValueError(f"kernel_info needs a CUDA tensor, got {qkv.device}")
    B, S, _ = qkv.shape
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(qkv.device):
        err = _build.library().ac_attention_qkv_info(
            qkv.data_ptr(), B, S, num_heads, head_dim, _DTYPE_CODES[qkv.dtype], info)
    _build.check(err, "attention_qkv_info")
    return _info_dict(info)
