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
tensor and launches its CUDA kernel for a CUDA tensor, or raises; there is
no fallback between them.  The plain versions repeat the kernels'
arithmetic step for step; a last-ulp difference of ``tanh`` can move one
requantized GELU value by one int8 step.

Both read K-contiguous weights: ``k_contiguous`` makes the ``[N, K]``
copy once per weight and keeps it on the weight tensor, and
``prepare_int8_weights`` does so for a whole int8 encoder state when it
reaches the device (the QKV weight for B2 too).  ``weight_map`` keeps the
tensor map B2 and B3 read a copy through beside it, made on the first
launch with that weight.  The CPU path never reads a copy.  Both kernels
run on Hopper's ``wgmma`` with TMA.  B3 (``csrc/ffn_block_int8.cu``) runs
its first product twice, once for each row's GELU maximum and once to
quantize the same values, and sends only the int8 q(f) through a device
scratch the wrapper allocates (``ffn_block_scratch_bytes``); from D 512 a
pair of blocks (a cluster) shares each 64-row tile.  B8
(``csrc/int8_hopper.cuh``) runs its first product and GELU once: the f32
GELU values go to a device scratch (``attn_ffn_scratch_bytes``, beside the
f32 LayerNorm rows and q(f)) and are read back to be quantized.
"""

from __future__ import annotations

import ctypes

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


#: widest D B3 takes: its second product keeps its share of a tile's
#: columns in registers
B3_MAX_D = 1024

#: K-contiguous copies made so far by ``k_contiguous`` (for tests)
k_contiguous_copies = 0


def k_contiguous(w: torch.Tensor) -> torch.Tensor:
    """The ``[N, K]`` copy of an int8 weight ``[K, N]`` that B2, B3, B8 and
    B9 read, made on the first call for this tensor and kept on it: a weight
    is copied once, never per call."""
    global k_contiguous_copies
    kc = getattr(w, "_ac_k_contiguous", None)
    if kc is None:
        kc = w.t().contiguous()
        w._ac_k_contiguous = kc
        k_contiguous_copies += 1
    return kc


#: tensor maps made so far by ``weight_map`` (for tests)
weight_maps_made = 0


def weight_map(w: torch.Tensor) -> ctypes.Array:
    """The host copy (128 bytes) of the TMA tensor map over int8 weight
    ``w``'s K-contiguous copy that B2 and B3 read, in boxes of 64 rows x
    128 bytes: made on the first call for this weight on ``w``'s device and
    kept on the copy, so a launch encodes only its activations' maps.  A
    new weight tensor gets its own copy and map."""
    global weight_maps_made
    kc = k_contiguous(w)
    m = getattr(kc, "_ac_tma_map", None)
    if m is None:
        m = (ctypes.c_ubyte * 128)()
        with torch.cuda.device(kc.device):
            _build.check(_build.library().ac_int8_weight_map(
                kc.data_ptr(), kc.shape[0], kc.shape[1], m), "int8 weight map")
        kc._ac_tma_map = m
        weight_maps_made += 1
    return m


#: the int8 weights the kernels read K-contiguous: QKV (B2), O (B8), the
#: FFN's two (B3, B8)
K_CONTIGUOUS_WEIGHTS = ("qkv_w.int8", "o_w.int8", "ffn_in_w.int8", "ffn_out_w.int8")


def prepare_int8_weights(params) -> None:
    """The int8 load path's step on a CUDA device: the K-contiguous copy of
    every layer's QKV, O and FFN weights of an int8 encoder state, so no
    forward makes one."""
    for key, w in params.items():
        if key.endswith(K_CONTIGUOUS_WEIGHTS):
            k_contiguous(w)


def drop_int8_copies(params) -> None:
    """Forget the K-contiguous copies of an int8 encoder state: a state off
    the GPU keeps none."""
    for key, w in params.items():
        if key.endswith(K_CONTIGUOUS_WEIGHTS) and hasattr(w, "_ac_k_contiguous"):
            del w._ac_k_contiguous


def _check_smem(name: str, device: torch.device, D: int, F: int, need: int):
    """Raise unless ``need`` bytes of shared memory, the kernel's smallest
    row tile at widths D, F, fit a block of ``device``."""
    have = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"{name}: D={D}, F={F} needs {need} bytes of shared "
                         f"memory per block, the device has {have}")


def ffn_block_info(D: int, F: int, o_proj: bool = False, M: int = 8192) -> dict:
    """What B3 (B8 with ``o_proj``) would launch for M rows at widths D, F
    on the current CUDA device, as the CUDA runtime reports the
    instantiation: registers per thread, shared bytes per block, threads
    per block, blocks resident per SM, local (spill) bytes per thread, rows
    a tile, consumer warpgroups, blocks a tile (``cluster``) and blocks of
    the launch.  Launches nothing."""
    info = (ctypes.c_int * 9)()
    _build.check(_build.library().ac_ffn_block_int8_info(M, D, F, int(o_proj), info),
                 "ffn_block_int8_info")
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                     "local_bytes", "rows", "warpgroups", "cluster", "blocks"), info))


def ffn_block_scratch_bytes(M: int, D: int, F: int) -> int:
    """Bytes of the int8 q(f) scratch B3 takes for M rows at widths D, F on
    the current CUDA device: 64 x F for each tile its persistent grid has in
    flight."""
    n = int(_build.library().ac_ffn_block_int8_scratch_bytes(M, D, F))
    if n <= 0:
        raise RuntimeError(f"ffn_block_int8: no launch at M={M}, D={D}, F={F} on the "
                           f"current CUDA device")
    return n


def attn_ffn_scratch_bytes(M: int, D: int, F: int) -> int:
    """Bytes of the device scratch B8 takes for M rows at widths D, F on the
    current CUDA device: a slot of 64 rows for each block of its persistent
    grid, each holding f32 LayerNorm rows, f32 GELU values and q(f)."""
    n = int(_build.library().ac_attn_ffn_block_int8_scratch_bytes(M, D, F))
    if n <= 0:
        raise RuntimeError("attn_ffn_block_int8: cannot read the current CUDA device")
    return n


def _wgmma_scratch(name: str, device: torch.device, M: int, D: int, F: int):
    """The device scratch of ``csrc/int8_hopper.cuh``'s body for M rows at
    widths D, F, after checking that the body's shared memory fits."""
    if D > B3_MAX_D:
        raise ValueError(f"{name}: D={D} > {B3_MAX_D}: the kernel keeps q(h) "
                         f"[64, D] in shared memory")
    _check_smem(name, device, D, F, _build.library().ac_ffn_block_int8_smem_bytes(D, 1))
    with torch.cuda.device(device):
        return torch.empty(attn_ffn_scratch_bytes(M, D, F), dtype=torch.uint8, device=device)


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
    if D > B3_MAX_D:
        raise ValueError(f"{name}: D={D} > {B3_MAX_D}: the kernel keeps its share "
                         f"of a tile's columns in registers")
    ptrs = cuda_args(name, h.device, h, k_contiguous(w1_q), s1, b1, k_contiguous(w2_q),
                     s2, b2, ln_scale, ln_bias)
    lib = _build.library()
    _check_smem(name, h.device, D, F, lib.ac_ffn_block_int8_smem_bytes(D, 0))
    with torch.cuda.device(h.device):
        ptrs[1] = ctypes.addressof(weight_map(w1_q))
        ptrs[4] = ctypes.addressof(weight_map(w2_q))
        scratch = torch.empty(ffn_block_scratch_bytes(M, D, F), dtype=torch.uint8,
                              device=h.device)
    out = torch.empty_like(h)
    launch(name, "ffn_int8", h.device, lib.ac_ffn_block_int8, *ptrs, float(eps),
           scratch.data_ptr(), out.data_ptr(), M, D, F, _DTYPE_CODES[h.dtype])
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
    ptrs = cuda_args(name, ctx.device, ctx, x, k_contiguous(o_wq), o_s, o_b, ln1_scale,
                     ln1_bias, k_contiguous(w1_q), s1, b1, k_contiguous(w2_q), s2, b2,
                     ln2_scale, ln2_bias)
    scratch = _wgmma_scratch(name, ctx.device, M, D, F)
    out = torch.empty_like(ctx)
    launch(name, "attn_ffn_int8", ctx.device, _build.library().ac_attn_ffn_block_int8,
           *ptrs, float(eps), scratch.data_ptr(), out.data_ptr(), M, D, F,
           _DTYPE_CODES[ctx.dtype])
    return out

