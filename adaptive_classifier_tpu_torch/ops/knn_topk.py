"""Exact top-k prototype search without the ``[B, C]`` similarity matrix.

Counterpart of ``adaptive_classifier_tpu/ops/knn_topk.py``.  At large class
counts the materialized path (``knn.masked_sims`` + ``knn.topk_scores``)
writes and re-reads a ``[B, C]`` similarity matrix; kernel B5 never does.

- ``topk_sims_ref``: the plain version — masked similarities, bias, invalid
  prototypes at −1e9, top-k with ties to the lower index — returning
  ``(vals [B, k], idx [B, k] int32)``.  The CPU path, and the yardstick the
  kernel is held to on the GPU.
- ``topk_sims``: the wrapper.  A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel in ``csrc/knn_topk.cu`` or raises.  The
  kernel's dot products run on the tensor cores in three TF32 products
  (f32-level error); its selection keeps each query's current k-th value
  and inserts only the candidates above it.
- ``topk_scores_fused``: ``topk_sims`` plus the reference's scoring tail:
  softmax over the k, id −1 and score 0 past the number of valid prototypes,
  and optionally the raw bias-free similarity of each neighbor.
- ``topk_scores_auto``: the JAX package's dispatch — the fused search at
  ``C >= fused_min_classes`` and ``k <= 128`` on the accelerator (here: a
  CUDA tensor), the materialized path otherwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from . import _build, knn, count_launch

#: the kernel's largest k (the Pallas kernel's running-buffer width)
KPAD = 128
_NEG = -1e9


def _bias_or_zeros(protos: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return torch.zeros((protos.shape[0],), dtype=torch.float32, device=protos.device)
    return bias.to(torch.float32)


def topk_sims_ref(
    queries: torch.Tensor,     # [B, D] float32
    protos: torch.Tensor,      # [C, D] float32
    valid: torch.Tensor,       # [C] bool
    k: int,
    bias: Optional[torch.Tensor] = None,   # [C] pre-selection shift
):
    """Plain version of kernel B5 → ``(vals [B, k] f32, idx [B, k] int32)``:
    the k largest ``sim + bias`` (invalid prototypes at −1e9), ties to the
    lower prototype index."""
    sims = knn.masked_sims_ref(queries, protos, valid)
    adj = sims + _bias_or_zeros(protos, bias)[None, :]
    neg = torch.where(valid[None, :], adj, torch.full_like(adj, _NEG))
    vals, idx = knn.top_k_lower_index(neg, k)
    return vals, idx.to(torch.int32)


@lru_cache(maxsize=None)
def topk_info(k: int, device_index: int = 0) -> dict:
    """Kernel B5's first pass for k on a CUDA device, as the CUDA runtime
    reports its instantiation: registers per thread, shared bytes per block,
    threads per block, blocks resident per SM, local (spill) bytes per
    thread, query rows a block, prototypes a tile, the sorted lists a block
    keeps for each query (merged into one before it writes them), and the
    most splits the second pass merges.  Launches nothing."""
    info = (ctypes.c_int * 9)()
    with torch.cuda.device(device_index):
        _build.check(_build.library().ac_topk_sims_info(k, info), "knn_topk info")
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm",
                     "local_bytes", "rows", "tile", "lists", "max_splits"), info))


def _splits(B: int, C: int, info: dict, device: torch.device):
    """(splits, tiles_per_split): one wave of pass-1 blocks that fills the
    card, every split non-empty, within the splits pass 2 merges."""
    n_tiles = -(-C // info["tile"])
    row_tiles = -(-B // info["rows"])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_tiles, info["max_splits"],
                      info["blocks_per_sm"] * sms // row_tiles))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def topk_sims_cuda(queries, protos, valid, k: int, bias=None):
    """Kernel B5 on the GPU → ``(vals [B, k] f32, idx [B, k] int32)``."""
    if queries.device.type != "cuda":
        raise ValueError(f"topk_sims_cuda takes CUDA tensors, got {queries.device}")
    b = _bias_or_zeros(protos, bias).contiguous()
    knn.check_knn_inputs(queries, protos, valid, b)
    B, D = queries.shape
    C = protos.shape[0]
    if not 1 <= k <= min(KPAD, C):
        raise ValueError(f"fused top-k takes 1 <= k <= min({KPAD}, C={C}), got {k}")
    dev = queries.device
    info = topk_info(k, dev.index if dev.index is not None else torch.cuda.current_device())
    splits, per = _splits(B, C, info, dev)
    queries, protos = knn.staged(queries), knn.staged(protos)
    D = queries.shape[1]
    part_v = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ac_topk_sims(queries.data_ptr(), protos.data_ptr(),
                               valid.data_ptr(), b.data_ptr(),
                               part_v.data_ptr(), part_i.data_ptr(),
                               vals.data_ptr(), idx.data_ptr(),
                               B, C, D, k, splits, per, stream)
    _build.check(err, "knn_topk launch")
    count_launch("knn_topk")
    return vals, idx


def topk_sims(queries, protos, valid, k: int, bias=None):
    """The k best ``sim + bias`` per query: the plain version for a CPU
    tensor, kernel B5 for a CUDA tensor."""
    if queries.device.type == "cpu":
        if k > KPAD:
            raise ValueError(f"fused top-k supports k <= {KPAD}, got {k}")
        return topk_sims_ref(queries, protos, valid, k, bias=bias)
    return topk_sims_cuda(queries, protos, valid, k, bias=bias)


def topk_scores_fused(
    queries: torch.Tensor,   # [B, D] float32
    protos: torch.Tensor,    # [C, D] float32
    valid: torch.Tensor,     # [C] bool
    k: int,
    return_raw: bool = False,
    bias: Optional[torch.Tensor] = None,   # [C] pre-selection shift
):
    """Fused exact top-k search → ``(scores [B, k], idx [B, k])``, the same
    as ``knn.masked_sims`` + ``knn.topk_scores`` without the ``[B, C]``
    matrix.  With ``return_raw`` also the raw ``exp(−d²)`` of each neighbor
    (bias-free; 0 past the valid count)."""
    vals, idx = topk_sims(queries, protos, valid, k, bias=bias)
    idx = idx.to(torch.int64)
    n_valid = valid.sum()
    in_range = torch.arange(k, device=queries.device)[None, :] < n_valid
    logits = torch.where(in_range, vals, torch.full_like(vals, _NEG))
    scores = torch.softmax(logits, dim=-1)
    scores = torch.where(in_range, scores, torch.zeros_like(scores))
    idx = torch.where(in_range, idx, torch.full_like(idx, -1))
    if return_raw:
        raw = vals if bias is None else vals - bias.to(torch.float32)[torch.clamp(idx, min=0)]
        return scores, idx, torch.where(in_range, raw, torch.zeros_like(raw))
    return scores, idx


def topk_scores_auto(
    queries: torch.Tensor,
    protos: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    use_fused: Optional[bool] = None,
    fused_min_classes: int = 16384,
    return_raw: bool = False,
    bias: Optional[torch.Tensor] = None,
):
    """Dispatch: kernel B5 for a CUDA tensor at ``C >= fused_min_classes``
    and ``k <= 128``, the materialized ``masked_sims`` (default threshold) +
    ``topk_scores`` path otherwise.  ``bias`` shifts similarities before
    selection in both paths; raw similarities stay bias-free."""
    C = protos.shape[0]
    if use_fused is None:
        use_fused = queries.is_cuda and C >= fused_min_classes and k <= KPAD
    if use_fused:
        return topk_scores_fused(queries, protos, valid, k,
                                 return_raw=return_raw, bias=bias)
    sims = knn.masked_sims(queries, protos, valid)
    scores, idx = knn.topk_scores(sims, valid, k, bias=bias)
    if return_raw:
        raw = torch.gather(sims, 1, torch.clamp(idx, min=0))
        return scores, idx, torch.where(idx >= 0, raw, torch.zeros_like(raw))
    return scores, idx
