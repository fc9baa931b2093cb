"""Prediction fusion — prototype/head score combination on the device.

Counterpart of ``adaptive_classifier_tpu/ops/fusion.py``:

- ``fuse_full``: prototype softmax over all valid classes plus head softmax
  over all active classes, per-label weights, sum-normalized, top-k (the
  ``predict`` semantics).
- ``fuse_topk``: prototype softmax over only the top-k neighbors, head
  probabilities truncated to their top-k, fixed scalar weights (the
  ``predict_batch`` semantics).  At ``C >= fused_topk_min_classes`` a CUDA
  tensor takes the prototype top-k from kernel B5 (``ops/knn_topk.py``)
  without the ``[B, C]`` similarity matrix.
- ``fuse_dist_from_emb``: the ``fuse_full`` distribution returned whole
  (the ``predict_proba`` semantics).

Every top-k here ranks ties by lower index, as ``jax.lax.top_k`` does.
Empty slots get id −1 and score 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import knn, knn_topk
from .knn import top_k_lower_index
from ..models.head import HeadParams, head_forward, masked_probs


def _sims_and_logits(emb, proto, proto_valid, head_params, has_head,
                     pallas_min_classes):
    """Shared *_from_emb preamble: masked kNN sims + head logits."""
    sims = knn.masked_sims(emb, proto, proto_valid,
                           pallas_min_classes=pallas_min_classes)
    logits = head_forward(head_params, emb) if has_head else torch.zeros_like(sims)
    return sims, logits


def _normalize_rows(combined: torch.Tensor) -> torch.Tensor:
    total = combined.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, combined / torch.clamp(total, min=1e-12), combined)


def _combined_dist(sims, logits, proto_valid, active, proto_w, head_w,
                   has_head, proto_bias=None):
    """Per-label-weight combination of prototype scores and head softmax,
    sum-normalized → (combined [B, C], scorable [C])."""
    combined = knn.full_scores(sims, proto_valid, bias=proto_bias) * proto_w[None, :]
    if has_head:
        combined = combined + masked_probs(logits, active) * head_w[None, :]
    scorable = proto_valid | (active if has_head else torch.zeros_like(active))
    return _normalize_rows(combined), scorable


def fuse_full(
    sims: torch.Tensor,          # [B, C] masked exp(−d²) similarities
    logits: torch.Tensor,        # [B, C] raw head logits (ignored if not has_head)
    proto_valid: torch.Tensor,   # [C] bool — classes with prototypes
    active: torch.Tensor,        # [C] bool — registered classes (head slots)
    proto_w: torch.Tensor,       # [C] float — per-label prototype weight
    head_w: torch.Tensor,        # [C] float — per-label head weight
    k: int,
    has_head: bool,
    proto_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (scores [B, k], class ids [B, k]); empty slots get id −1, score 0."""
    combined, scorable = _combined_dist(sims, logits, proto_valid, active,
                                        proto_w, head_w, has_head, proto_bias)
    ranked = torch.where(scorable[None, :], combined,
                         torch.full_like(combined, float("-inf")))
    vals, idx = top_k_lower_index(ranked, k)
    in_range = torch.arange(k, device=sims.device)[None, :] < scorable.sum()
    return (torch.where(in_range, vals, torch.zeros_like(vals)),
            torch.where(in_range, idx, torch.full_like(idx, -1)))


def fuse_full_from_emb(
    emb: torch.Tensor,           # [B, D]
    proto: torch.Tensor,         # [C, D]
    proto_valid: torch.Tensor,   # [C] bool
    head_params: Optional[HeadParams],
    active: torch.Tensor,        # [C] bool
    proto_w: torch.Tensor,       # [C] per-label weights
    head_w: torch.Tensor,        # [C]
    k: int,
    has_head: bool,
    pallas_min_classes: int = 512,
    proto_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN sims + head forward + full-class fusion (the ``predict`` path)."""
    sims, logits = _sims_and_logits(emb, proto, proto_valid, head_params,
                                    has_head, pallas_min_classes)
    return fuse_full(sims, logits, proto_valid, active, proto_w, head_w,
                     k, has_head, proto_bias=proto_bias)


def _fuse_from_proto_topk(
    topk_scores: torch.Tensor,   # [B, kk] softmaxed prototype scores
    topk_idx: torch.Tensor,      # [B, kk] class ids (−1 = padding)
    logits: torch.Tensor,        # [B, C] raw head logits
    active: torch.Tensor,        # [C] bool
    C: int,
    proto_weight: float,
    head_weight: float,
    kk: int,
    has_head: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter proto top-k + head top-k, renormalize, final top-k."""
    B = topk_scores.shape[0]
    dev = topk_scores.device
    proto_vec = torch.zeros((B, C), dtype=torch.float32, device=dev)
    proto_vec.scatter_add_(
        1, torch.clamp(topk_idx, min=0),
        torch.where(topk_idx >= 0, topk_scores, torch.zeros_like(topk_scores)))
    combined = proto_vec * proto_weight
    if has_head:
        hvals, hidx = top_k_lower_index(masked_probs(logits, active), kk)
        head_vec = torch.zeros((B, C), dtype=torch.float32, device=dev)
        head_vec.scatter_add_(1, hidx, hvals)
        combined = combined + head_vec * head_weight
    combined = _normalize_rows(combined)
    ranked = torch.where(combined > 0, combined,
                         torch.full_like(combined, float("-inf")))
    vals, idx = top_k_lower_index(ranked, kk)
    ok = vals > float("-inf")
    return (torch.where(ok, vals, torch.zeros_like(vals)),
            torch.where(ok, idx, torch.full_like(idx, -1)))


def fuse_topk(
    sims: torch.Tensor,
    logits: torch.Tensor,
    proto_valid: torch.Tensor,
    active: torch.Tensor,
    proto_weight: float,
    head_weight: float,
    k: int,
    has_head: bool,
    proto_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k-restricted fusion with fixed scalar weights → (scores, ids)."""
    C = sims.shape[1]
    kk = min(k, C)
    topk_sc, topk_idx = knn.topk_scores(sims, proto_valid, kk, bias=proto_bias)
    return _fuse_from_proto_topk(topk_sc, topk_idx, logits, active, C,
                                 proto_weight, head_weight, kk, has_head)


def fuse_topk_from_emb(
    emb: torch.Tensor,           # [B, D] normalized embeddings
    proto: torch.Tensor,         # [C, D] prototypes
    proto_valid: torch.Tensor,   # [C] bool
    head_params: Optional[HeadParams],
    active: torch.Tensor,        # [C] bool
    proto_weight: float,
    head_weight: float,
    k: int,
    has_head: bool,
    pallas_min_classes: int = 512,
    proto_bias: Optional[torch.Tensor] = None,
    fused_min_classes: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN sims + head forward + top-k fusion (the ``predict_batch`` path).

    At ``C >= fused_min_classes`` (when nonzero) and ``k <= 128`` the JAX
    package routes the prototype stage through its streaming top-k kernel;
    here a CUDA tensor takes kernel B5 there, and a CPU tensor the plain
    materialized path.
    """
    C = proto.shape[0]
    kk = min(k, C)
    if (emb.is_cuda and fused_min_classes and C >= fused_min_classes
            and kk <= knn_topk.KPAD):
        topk_sc, topk_idx = knn_topk.topk_scores_fused(
            emb, proto, proto_valid, kk, bias=proto_bias)
        logits = (head_forward(head_params, emb) if has_head
                  else torch.zeros((emb.shape[0], C), device=emb.device))
        return _fuse_from_proto_topk(topk_sc, topk_idx, logits, active, C,
                                     proto_weight, head_weight, kk, has_head)
    sims, logits = _sims_and_logits(emb, proto, proto_valid, head_params,
                                    has_head, pallas_min_classes)
    return fuse_topk(sims, logits, proto_valid, active, proto_weight,
                     head_weight, k, has_head, proto_bias=proto_bias)


def fuse_dist_from_emb(
    emb: torch.Tensor,           # [B, D] normalized embeddings
    proto: torch.Tensor,         # [C, D]
    proto_valid: torch.Tensor,   # [C] bool
    head_params: Optional[HeadParams],
    active: torch.Tensor,        # [C] bool
    proto_w: torch.Tensor,       # [C] per-label weights
    head_w: torch.Tensor,        # [C]
    has_head: bool,
    pallas_min_classes: int = 512,
    proto_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full fused probability distribution ``[B, C]``: the ``fuse_full``
    combination returned whole.  Rows sum to 1 over scorable classes;
    non-scorable columns are 0."""
    sims, logits = _sims_and_logits(emb, proto, proto_valid, head_params,
                                    has_head, pallas_min_classes)
    combined, scorable = _combined_dist(sims, logits, proto_valid, active,
                                        proto_w, head_w, has_head, proto_bias)
    return torch.where(scorable[None, :], combined, torch.zeros_like(combined))
