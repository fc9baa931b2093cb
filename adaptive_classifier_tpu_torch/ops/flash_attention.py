"""Flash (online-softmax) and one-shot attention over per-head q, k, v.

Counterpart of ``adaptive_classifier_tpu/ops/flash_attention.py``.  Both
take the encoder layout, q, k and v as ``[B, S, H, Dh]`` (views of the
packed ``[B, S, 3D]`` QKV tensor do: no copy), and a ``[B, S]`` 1/0 key mask,
and return ``[B, S, H, Dh]``: per head ``softmax(q·kᵀ/√Dh + bias)·v`` with an
additive −1e9 bias on padded keys.  They round differently:

- ``flash_attention`` (kernel B6): online softmax over 64-key tiles; per
  tile ``p = exp(s − m)`` with the running max ``m``, rounded to the input
  type for the PV product, ``acc = acc·corr + p·v`` and ``l`` (from the
  unrounded ``p``) in f32; at the end ``acc / max(l, 1e-30)``.
- ``oneshot_attention`` (kernel B7): the exact row softmax, normalized by
  ``max(l, 1e-30)`` and then rounded to the input type, then the PV product
  in f32.  Rows of at most ``MAX_ONESHOT_S`` keys.

In bf16 both kernels multiply on the tensor cores with ``wgmma`` fed by
TMA (``csrc/attention_hopper.cuh``; rows of at most 64 keys on the
``mma.sync`` tile loop of ``csrc/attention_tile.cuh``): bf16 products are
exact in f32, so only the order of the sums differs from the plain
versions.  In f32 they multiply on the CUDA cores.

Each ``*_ref`` is the plain torch version in its kernel's order of rounding:
the CPU path, and the yardstick the kernel is held to on the GPU.  The
wrappers take it for a CPU tensor, and launch ``csrc/flash_attention.cu`` for
a CUDA tensor or raise.  Keys past S do not exist (the JAX package pads S
and Dh to its TPU tiles; the port pads nothing), so a fully masked row is
the uniform average of V over its S keys.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch, refuse_autograd

NEG = -1e9
#: keys per step of the flash recurrence (``TK`` in csrc/flash_attention.cu
#: and csrc/attention_hopper.cuh; rows of at most 64 keys take one tile of
#: csrc/attention_tile.cuh, the same single step)
K_TILE = 64
#: longest row the one-shot kernel takes: in f32 its query tile keeps every
#: score of its rows in shared memory (the bf16 kernel keeps them in
#: registers up to S 512 and takes two passes above)
MAX_ONESHOT_S = 2048

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the forms of the bf16 kernel of ``csrc/attention_hopper.cuh`` (B1, B6 and
#: B7 above 64 keys), by the code ``kernel_info`` reads back: "rows" keeps a
#: warpgroup's [64, S] scores in registers (S <= 256), "split keys" halves
#: the keys between the two consumer warpgroups (S <= 512), "two passes"
#: computes the scores twice (S > 512), "flash" is B6's online recurrence
#: over the key tiles (any S); "none" is a loop without wgmma (rows of at
#: most 64 keys, the f32 kernels)
WGMMA_FORMS = {0: "none", 1: "rows", 2: "split keys", 3: "two passes", 4: "flash"}


def _info_dict(info) -> dict:
    """The instantiation a ``*_info`` entry point reports, by name."""
    out = dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                    "local_bytes", "warpgroups"), info[:6]))
    out["wgmma_form"] = WGMMA_FORMS[info[6]]
    out["tma"] = bool(info[7])
    return out


def _heads_f32(q, k, v, attention_mask):
    """→ q, k, v as f32 ``[B, H, S, Dh]``, the f32 key bias ``[B, 1, 1, S]``
    and the softmax scale."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG).to(
        device=q.device, dtype=torch.float32)
    return qf, kf, vf, bias, 1.0 / math.sqrt(q.shape[-1])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: the online-softmax recurrence over ``K_TILE``
    keys at a time, in the kernel's order of rounding."""
    qf, kf, vf, bias, scale = _heads_f32(q, k, v, attention_mask)
    B, H, S, Dh = qf.shape
    m = torch.full((B, H, S, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, Dh), device=q.device)
    for k0 in range(0, S, K_TILE):
        s = (torch.matmul(qf, kf[:, :, k0:k0 + K_TILE].transpose(-1, -2)) * scale
             + bias[..., k0:k0 + K_TILE])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vf[:, :, k0:k0 + K_TILE])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def oneshot_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of B7: the whole row softmax, the probabilities
    normalized and then rounded to the input type, then the PV product."""
    qf, kf, vf, bias, scale = _heads_f32(q, k, v, attention_mask)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.clamp(l, min=1e-30)).to(v.dtype).float()
    return torch.matmul(p, vf).to(q.dtype).transpose(1, 2).contiguous()


def check_envelope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   attention_mask: torch.Tensor, max_s: int = 0):
    """Raise ValueError unless the inputs are what the kernels take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, Dh], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if tuple(attention_mask.shape) != (B, S):
        raise ValueError(f"mask shape {tuple(attention_mask.shape)} != {(B, S)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"kernels take one of float32/bfloat16")
    if Dh > 128:
        raise ValueError(f"head_dim={Dh}: the kernels take head_dim <= 128")
    if max_s and S > max_s:
        raise ValueError(f"S={S} > {max_s}: the one-shot kernel keeps every score "
                         f"of its query tile in shared memory")


def _launch(entry: str, count: str, q, k, v, attention_mask) -> torch.Tensor:
    dev = q.device
    if q.device.type != "cuda":
        raise ValueError(f"{count} has no path for device {dev}")
    if any(t.device != dev for t in (k, v, attention_mask)):
        raise ValueError(f"q, k, v and the mask must share one device ({dev})")
    refuse_autograd(count, q, k, v)
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(-1) != 1:
        raise ValueError(f"q, k, v must share strides with unit stride on Dh, got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    B, S, H, Dh = q.shape
    sb, ss, sh, _ = q.stride()
    mask = attention_mask.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  mask.data_ptr(), out.data_ptr(), B, S, H, Dh,
                                  sb, ss, sh, _DTYPE_CODES[q.dtype], stream)
    _build.check(err, f"{count} launch")
    count_launch(count)
    return out


def kernel_info(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                oneshot: bool) -> dict:
    """What B6 (or B7, with ``oneshot``) would launch on these CUDA inputs,
    as the CUDA runtime reports the instantiation: registers per thread,
    shared bytes per block, threads per block, blocks resident per SM,
    local (spill) bytes per thread, consumer warpgroups, the wgmma form
    (``WGMMA_FORMS``) and whether TMA feeds it.  Launches nothing."""
    if q.device.type != "cuda":
        raise ValueError(f"kernel_info needs CUDA tensors, got {q.device}")
    B, S, H, Dh = q.shape
    sb, ss, sh, _ = q.stride()
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(q.device):
        err = _build.library().ac_flash_attention_info(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, H, Dh, sb, ss, sh,
            _DTYPE_CODES[q.dtype], int(oneshot), info)
    _build.check(err, "flash_attention_info")
    return _info_dict(info)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """B6 on ``[B, S, H, Dh]`` q, k, v → ``[B, S, H, Dh]``: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    check_envelope(q, k, v, attention_mask)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, attention_mask)
    return _launch("ac_flash_attention", "flash_attention", q, k, v, attention_mask)


def oneshot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attention_mask: torch.Tensor) -> torch.Tensor:
    """B7 on ``[B, S, H, Dh]`` q, k, v → ``[B, S, H, Dh]``: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor (S <= 2,048)."""
    check_envelope(q, k, v, attention_mask, max_s=MAX_ONESHOT_S)
    if q.device.type == "cpu":
        return oneshot_attention_ref(q, k, v, attention_mask)
    return _launch("ac_oneshot_attention", "oneshot_attention", q, k, v, attention_mask)
