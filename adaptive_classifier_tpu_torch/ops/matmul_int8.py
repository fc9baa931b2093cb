"""The int8 projections of the encoder layer: kernels B2 and B9.

Counterpart of ``adaptive_classifier_tpu/ops/matmul_int8.py``.

- ``quant_matmul_int8`` (B2): per-row symmetric int8 quantization of x
  (scale ``absmax · (1/127)``, floor 1e-8, round half to even, clip ±127),
  an int8×int8→int32 product with per-output-channel int8 weights, and
  ``acc · x_scale · w_scale + b`` in f32, returned in x's type.  It is the
  fused QKV projection of the int8 forward.
- ``proj_residual_ln_int8`` (B9): the same product with ``N = D``, plus the
  residual and a LayerNorm with f32 statistics: ``LN(q(x) @ Wo · s + b +
  res)``.  No path of either package calls it.

Each wrapper takes its plain version (``*_ref``) for a CPU tensor and
launches its CUDA kernel (``csrc/matmul_int8.cu``) for a CUDA tensor, or
raises; there is no fallback between them.  Both kernels read the weight's
K-contiguous copy (``ffn_int8.k_contiguous``, made once per weight; the CPU
path never reads it).  B2 runs on Hopper's ``wgmma`` with TMA: it
quantizes each 64-row tile of x once per unit of work, reads the copy
through a tensor map kept beside it (``ffn_int8.weight_map``) and writes
its output by TMA stores; B9 is an ``mma.sync`` loop.  The plain versions
repeat the kernels' arithmetic step for step: the int8 operands agree bit
for bit and the int32 sums are exact, so B2's outputs equal the plain
version's bit for bit and only B9's LayerNorm sum order differs.

The shared pieces, ``quant_rows``, ``int8_matmul`` and ``layer_norm``, are
also the plain arithmetic of ``ops.ffn_int8`` and ``models.encoder_int8``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_rows(h: torch.Tensor, divide: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of f32 rows ``[..., K]`` → (int8, f32 scale
    ``[..., 1]``).  The scale is ``absmax · (1/127)`` (B2, B9) or, with
    ``divide``, ``absmax / 127`` (B3, B8, ``_dyn_quant_rows``), as each JAX
    function writes it.  The divisor is a tensor: torch turns a CUDA
    division by a Python scalar into a multiplication by its reciprocal."""
    absmax = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scale = (absmax / torch.full_like(absmax, 127.0) if divide
             else absmax * (1.0 / 127.0))
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``[M, K] int8 @ [K, N] int8 → [M, N] int32``: ``torch._int_mm``
    on a GPU where its shape rules hold (M > 16, K and N multiples of 8),
    else a float64 product, exact since every sum is below 127²·K < 2⁵³."""
    if (a.device.type == "cuda" and a.shape[0] > 16 and a.shape[1] % 8 == 0
            and b.shape[1] % 8 == 0):
        return torch._int_mm(a, b)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def layer_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Row LayerNorm of f32 ``y`` with f32 statistics → f32."""
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def quant_matmul_int8_ref(x: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain version of B2: ``(q(x) @ w_q) · x_scale · s + b`` in x's type."""
    x_q, x_scale = quant_rows(x.float(), divide=False)
    acc = int8_matmul(x_q, w_q)
    return (acc.float() * x_scale * s.float() + b.float()).to(x.dtype)


def proj_residual_ln_int8_ref(x: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor,
                              b: torch.Tensor, res: torch.Tensor,
                              ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                              eps: float) -> torch.Tensor:
    """Plain version of B9: ``LN(q(x) @ w_q · x_scale · s + b + res)``."""
    x_q, x_scale = quant_rows(x.float(), divide=False)
    y = int8_matmul(x_q, w_q).float() * x_scale * s.float() + b.float()
    y = y + res.float()
    return layer_norm(y, ln_scale, ln_bias, eps).to(x.dtype)


def check_rows(name: str, rows: torch.Tensor, *more: torch.Tensor):
    """Raise ValueError unless ``rows`` (and each of ``more``) is ``[M, K]``
    float32 or bfloat16 with K % 128 == 0 and M > 0, all of one shape and
    type."""
    if rows.dim() != 2 or rows.shape[0] == 0:
        raise ValueError(f"{name}: rows must be [M, K] with M > 0, got {tuple(rows.shape)}")
    if rows.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: rows must be float32 or bfloat16, got {rows.dtype}")
    if rows.shape[1] % 128:
        raise ValueError(f"{name}: K={rows.shape[1]} must be a multiple of 128")
    for t in (rows,) + more:
        if t.shape != rows.shape or t.dtype != rows.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(rows.shape)} {rows.dtype}")


def check_weight(name: str, w: torch.Tensor, K: int, N: int, *vectors: torch.Tensor):
    """Raise ValueError unless ``w`` is ``[K, N]`` int8 with N % 64 == 0 and
    every vector is ``[N]`` float32."""
    if w.dtype != torch.int8 or tuple(w.shape) != (K, N):
        raise ValueError(f"{name}: weight must be [{K}, {N}] int8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if N % 64:
        raise ValueError(f"{name}: N={N} must be a multiple of 64")
    for v in vectors:
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != N:
            raise ValueError(f"{name}: per-column vectors must be [{N}] float32, "
                             f"got {tuple(v.shape)} {v.dtype}")


def cuda_args(name: str, device: torch.device, *tensors: torch.Tensor):
    """Raise ValueError unless every tensor is contiguous on ``device``, a
    CUDA device; → their data pointers."""
    if device.type != "cuda":
        raise ValueError(f"{name} has no path for device {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: inputs on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return [t.data_ptr() for t in tensors]


def launch(name: str, counter: str, device: torch.device, fn, *args):
    """Call launcher ``fn(*args, stream)`` on ``device``'s current stream,
    raise on a CUDA error, and count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    _build.check(err, f"{name} launch")
    count_launch(counter)


def quant_matmul_info(M: int, K: int, N: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What B2 would launch for ``[M, K]`` rows of ``dtype`` and N columns
    on the current CUDA device, as the CUDA runtime reports the
    instantiation: registers per thread, shared bytes per block, threads per
    block, blocks resident per SM, local (spill) bytes per thread, rows and
    columns a block's unit of work, and blocks in the grid.  Launches
    nothing."""
    info = (ctypes.c_int * 8)()
    _build.check(_build.library().ac_quant_matmul_int8_info(M, K, N, _DTYPE_CODES[dtype],
                                                            info), "quant_matmul_int8_info")
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                     "local_bytes", "rows", "columns", "blocks"), info))


#: widest D B9 takes: a block keeps all D columns of its rows in registers
B9_MAX_D = 1024


def proj_residual_ln_info(M: int, D: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What B9 would launch for ``[M, D]`` rows of ``dtype`` on the current
    CUDA device, as the CUDA runtime reports the instantiation: registers
    per thread, shared bytes per block, threads per block, blocks resident
    per SM, local (spill) bytes per thread, rows a block, and blocks in the
    grid.  Launches nothing."""
    info = (ctypes.c_int * 7)()
    _build.check(_build.library().ac_proj_residual_ln_int8_info(M, D, _DTYPE_CODES[dtype],
                                                                info),
                 "proj_residual_ln_int8_info")
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                     "local_bytes", "rows", "blocks"), info))


def quant_matmul_int8(x: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """B2: ``(q(x) @ w_q) · x_scale · s + b`` → ``[M, N]`` in x's type; the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    check_rows("quant_matmul_int8", x)
    M, K = x.shape
    check_weight("quant_matmul_int8", w_q, K, w_q.shape[-1], s, b)
    if x.device.type == "cpu":
        return quant_matmul_int8_ref(x, w_q, s, b)
    from .ffn_int8 import k_contiguous, weight_map    # ffn_int8 imports this module

    N = w_q.shape[1]
    ptrs = cuda_args("quant_matmul_int8", x.device, x, k_contiguous(w_q), s, b)
    with torch.cuda.device(x.device):
        ptrs[1] = ctypes.addressof(weight_map(w_q))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch("quant_matmul_int8", "matmul_int8", x.device,
           _build.library().ac_quant_matmul_int8, *ptrs, out.data_ptr(), M, K, N,
           _DTYPE_CODES[x.dtype])
    return out


def proj_residual_ln_int8(x: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor,
                          b: torch.Tensor, res: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """B9: ``LN(q(x) @ w_q · x_scale · s + b + res)`` → ``[M, D]`` in x's
    type; the plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    check_rows("proj_residual_ln_int8", x, res)
    M, D = x.shape
    check_weight("proj_residual_ln_int8", w_q, D, D, s, b, ln_scale, ln_bias)
    if x.device.type == "cpu":
        return proj_residual_ln_int8_ref(x, w_q, s, b, res, ln_scale, ln_bias, eps)
    if D > B9_MAX_D:
        raise ValueError(f"proj_residual_ln_int8: D={D} > {B9_MAX_D}")
    from .ffn_int8 import k_contiguous    # ffn_int8 imports this module

    # the [D, D] copy with K contiguous that the kernel reads: made on the
    # first call with this weight tensor and kept on it, never per call
    ptrs = cuda_args("proj_residual_ln_int8", x.device, x, k_contiguous(w_q), s, b, res,
                     ln_scale, ln_bias)
    out = torch.empty_like(x)
    launch("proj_residual_ln_int8", "proj_residual_ln_int8", x.device,
           _build.library().ac_proj_residual_ln_int8, *ptrs, float(eps),
           out.data_ptr(), M, D, _DTYPE_CODES[x.dtype])
    return out
