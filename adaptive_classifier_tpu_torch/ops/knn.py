"""Exact kNN over class prototypes: similarities and neighbor scoring.

Counterpart of ``adaptive_classifier_tpu/ops/knn.py``.  Similarity is
``exp(−‖q−p‖²)`` over valid prototypes (0 for invalid slots), then a
softmax over the selected neighbors.

The JAX package sends ``masked_sims`` to a Pallas kernel at
``C >= pallas_min_classes`` (``masked_sims_pallas``, kernel B4) and keeps the
plain computation below it.  The port keeps that threshold: below it the
plain computation is the package's own choice; at or above it on a GPU the
call raises until B4 is ported.  It never computes B4's work in plain torch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def masked_sims(
    queries: torch.Tensor,
    protos: torch.Tensor,
    valid: torch.Tensor,
    pallas_min_classes: int = 512,
) -> torch.Tensor:
    """Prototype similarities, dispatched by the JAX package's threshold."""
    if queries.is_cuda and protos.shape[0] >= pallas_min_classes:
        raise NotImplementedError(
            f"masked kNN similarities at C={protos.shape[0]} >= "
            f"pallas_min_classes={pallas_min_classes} run in kernel B4 "
            f"(masked_sims_pallas), which is not yet ported to CUDA")
    return masked_sims_ref(queries, protos, valid)


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
