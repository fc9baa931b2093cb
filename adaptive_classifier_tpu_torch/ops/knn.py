"""Exact kNN over class prototypes: similarities and neighbor scoring.

Counterpart of ``adaptive_classifier_tpu/ops/knn.py``.  Similarity is
``exp(−‖q−p‖²)`` over valid prototypes (0 for invalid slots), then a
softmax over the selected neighbors.

The JAX package sends ``masked_sims`` to a Pallas kernel at
``C >= pallas_min_classes`` (``masked_sims_pallas``, kernel B4) and keeps the
plain computation below it.  The port keeps that threshold.  At or above it
a CPU tensor takes the plain version, ``masked_sims_ref``, and a CUDA tensor
launches the hand-written kernel in ``csrc/knn_sims.cu`` or raises; there is
no fallback between them.  The kernel forms ``q·p`` on the tensor cores in
three TF32 products a pair (f32-level error), 128 × 128 output tiles fed by
TMA; where the tiles alone would leave most of the card idle, the wrapper
splits the contraction over several blocks a tile (:func:`sims_splits`) and
a second pass adds their partial sums.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from . import _build, launch_counts


def masked_sims_ref(
    queries: torch.Tensor,   # [B, D] float32
    protos: torch.Tensor,    # [C, D] float32
    valid: torch.Tensor,     # [C] bool
) -> torch.Tensor:
    """``exp(−‖q−p‖²)`` for valid prototypes, 0 for invalid — [B, C]."""
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)          # [B, 1]
    pn = torch.sum(protos * protos, dim=-1)[None, :]                 # [1, C]
    d2 = torch.clamp(qn + pn - 2.0 * (queries @ protos.T), min=0.0)
    return torch.where(valid[None, :], torch.exp(-d2), torch.zeros_like(d2))


def check_knn_inputs(queries: torch.Tensor, protos: torch.Tensor,
                     valid: torch.Tensor, *extra: torch.Tensor):
    """Raise ValueError unless the inputs are what the kNN kernels take:
    ``queries [B, D]`` and ``protos [C, D]`` float32, ``valid [C]`` bool,
    and any ``extra`` ``[C]`` float32, contiguous on one CUDA device."""
    if queries.dim() != 2 or protos.dim() != 2 or queries.shape[1] != protos.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and prototypes "
                         f"{tuple(protos.shape)} must be [B, D] and [C, D]")
    C = protos.shape[0]
    if tuple(valid.shape) != (C,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be [{C}] bool, got {tuple(valid.shape)} {valid.dtype}")
    for t in (queries, protos) + extra:
        if t.dtype != torch.float32:
            raise ValueError(f"kNN kernels take float32, got {t.dtype}")
    for t in extra:
        if tuple(t.shape) != (C,):
            raise ValueError(f"per-prototype input must be [{C}], got {tuple(t.shape)}")
    for t in (queries, protos, valid) + extra:
        if t.device != queries.device:
            raise ValueError(f"inputs on {t.device} and {queries.device}")
        if not t.is_contiguous():
            raise ValueError("kNN kernel inputs must be contiguous")
    if queries.shape[0] == 0 or C == 0 or queries.shape[1] == 0:
        raise ValueError("kNN kernels take non-empty inputs")


def staged(x: torch.Tensor) -> torch.Tensor:
    """``x [N, D]`` as kernels B4 and B5 stage it: 16-byte aligned rows (D a
    multiple of 4, padded with zero columns, which add nothing to a dot
    product or a norm)."""
    pad = -x.shape[1] % 4
    if pad == 0 and x.data_ptr() % 16 == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


@lru_cache(maxsize=None)
def sims_info(device_index: int = 0) -> dict:
    """Kernel B4's first pass on a CUDA device, as the CUDA runtime reports
    its instantiation: registers per thread, shared bytes per block, threads
    per block, blocks resident per SM, local (spill) bytes per thread, query
    rows and prototypes a tile, contraction columns a slice, the fewest
    slices a split takes and the most splits.  Launches nothing."""
    info = (ctypes.c_int * 10)()
    with torch.cuda.device(device_index):
        _build.check(_build.library().ac_masked_sims_info(info), "knn_sims info")
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                     "local_bytes", "rows", "cols", "slice", "min_slices",
                     "max_splits"), info))


def sims_splits(B: int, C: int, D: int, info: dict, sms: int) -> Tuple[int, int]:
    """(splits, slices a split) for kernel B4, from its instantiation
    ``info`` (:func:`sims_info`): the contraction's ``ceil(D / slice)``
    slices go to as many blocks an output tile as one wave of the card
    holds beside the other tiles, each split taking at least
    ``min_slices`` slices; one split where the tiles alone fill the card."""
    tiles = -(-B // info["rows"]) * -(-C // info["cols"])
    slices = -(-D // info["slice"])
    want = min(info["blocks_per_sm"] * sms // tiles, slices // info["min_slices"],
               info["max_splits"])
    if want <= 1:
        return 1, slices
    per = -(-slices // want)
    return -(-slices // per), per


def masked_sims_cuda(queries: torch.Tensor, protos: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Kernel B4 on the GPU: ``[B, C]`` masked ``exp(−d²)``, the product in
    3×TF32 with f32 sums."""
    if queries.device.type != "cuda":
        raise ValueError(f"masked_sims_cuda takes CUDA tensors, got {queries.device}")
    check_knn_inputs(queries, protos, valid)
    B, C = queries.shape[0], protos.shape[0]
    dev = queries.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    info = sims_info(index)
    queries, protos = staged(queries), staged(protos)
    D = queries.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = sims_splits(B, C, D, info, sms)
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    scratch = (torch.empty((splits * (B * C + B + C),), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ac_masked_sims(queries.data_ptr(), protos.data_ptr(), valid.data_ptr(),
                                 out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                                 B, C, D, splits, per, stream)
    _build.check(err, "knn_sims launch")
    launch_counts["knn_sims"] += 1
    return out


def masked_sims(
    queries: torch.Tensor,
    protos: torch.Tensor,
    valid: torch.Tensor,
    pallas_min_classes: int = 512,
) -> torch.Tensor:
    """Prototype similarities, dispatched by the JAX package's threshold:
    below it the plain computation; at or above it kernel B4 for a CUDA
    tensor, its plain version for a CPU tensor."""
    if protos.shape[0] < pallas_min_classes or queries.device.type == "cpu":
        return masked_sims_ref(queries, protos, valid)
    return masked_sims_cuda(queries, protos, valid)


def top_k_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal values rank by lower index, as
    ``jax.lax.top_k`` orders them.  ``torch.topk`` promises no tie order on
    CUDA, so this takes a stable descending sort and slices."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_scores(
    sims: torch.Tensor,      # [B, C] masked similarities (0 = invalid)
    valid: torch.Tensor,     # [C] bool
    k: int,
    bias: Optional[torch.Tensor] = None,   # [C] per-class calibration logit
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k neighbors + softmax over the selected k → ``(scores, idx)``.

    Slots beyond the number of valid prototypes get idx −1 and score 0.
    ``bias`` shifts the similarities before selection.
    """
    n_valid = valid.sum()
    adj = sims if bias is None else sims + bias[None, :]
    neg = torch.where(valid[None, :], adj, torch.full_like(adj, -1e9))
    vals, idx = top_k_lower_index(neg, k)                     # [B, k]
    in_range = torch.arange(k, device=sims.device)[None, :] < n_valid
    logits = torch.where(in_range, vals, torch.full_like(vals, -1e9))
    scores = torch.softmax(logits, dim=-1)
    scores = torch.where(in_range, scores, torch.zeros_like(scores))
    idx = torch.where(in_range, idx, torch.full_like(idx, -1))
    return scores, idx


def full_scores(
    sims: torch.Tensor,      # [B, C]
    valid: torch.Tensor,     # [C]
    bias: Optional[torch.Tensor] = None,   # [C] per-class calibration logit
) -> torch.Tensor:
    """Softmax of similarities over all valid prototypes — [B, C]; every
    score is 0 when no prototype is valid."""
    logits = torch.where(valid[None, :], sims, torch.full_like(sims, -1e9))
    if bias is not None:
        logits = torch.where(valid[None, :], logits + bias[None, :], logits)
    scores = torch.softmax(logits, dim=-1)
    return torch.where(valid[None, :], scores, torch.zeros_like(scores))
