"""Exact kNN over prototypes sharded on "tp": a top-k per shard, an
all-gather of the candidates, one merge.

Counterpart of ``adaptive_classifier_tpu/parallel/sharded_knn.py``.  Each
rank scores its own ``[C/tp, D]`` prototypes (``ops.knn.masked_sims``:
kernel B4 for a CUDA tensor, at any class count), keeps its top ``k``
with lower-index ties, and only the ``[B, k]`` values and global ids
cross ranks.  ``merge_candidates`` is the merge as a plain function of
the gathered candidates, so it runs without a collective as well.
Scores: similarity ``exp(−d²)``, softmax over the selected k; ``-1e9``
sentinels keep the softmax finite where a shard (or every shard) has no
valid prototype; empty slots get id −1 and score 0.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import knn
from .mesh import all_gather_cat, local, memory_shardings, place, tp_rank

NEG = -1e9


def local_topk(q: torch.Tensor, protos: torch.Tensor, valid: torch.Tensor, k: int,
               offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's candidates: the top ``min(k, C_shard)`` masked
    similarities of ``q [B, D]`` against ``protos [C_shard, D]`` and their
    global ids (``offset`` + local id), ties to the lower id."""
    sims = knn.masked_sims(q, protos, valid, pallas_min_classes=0)
    neg = torch.where(valid[None, :], sims, torch.full_like(sims, NEG))
    vals, idx = knn.top_k_lower_index(neg, min(k, protos.shape[0]))
    return vals, idx + offset


def merge_candidates(vals: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global top-k of the shards' candidates ``[B, n]`` (shard by shard,
    each in its own rank order, so a tie goes to the lower global id)
    → ``(scores, ids, raw)``: softmax over the selected k, −1 / 0 in the
    slots no valid prototype fills, ``raw`` the selected ``exp(−d²)``."""
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    top_vals, pos = knn.top_k_lower_index(vals, k)
    top_ids = torch.gather(ids, 1, pos)
    in_range = top_vals > -1e8
    scores = torch.softmax(torch.where(in_range, top_vals, torch.full_like(top_vals, NEG)),
                           dim=-1)
    zero = torch.zeros_like(top_vals)
    return (torch.where(in_range, scores, zero),
            torch.where(in_range, top_ids, torch.full_like(top_ids, -1)),
            torch.where(in_range, top_vals, zero))


def make_sharded_topk(mesh: DeviceMesh, k: int):
    """→ ``search(queries [B, D], protos, valid) → (scores, ids, raw)``
    over prototypes sharded on "tp" (``DTensor``s from
    ``shard_prototypes``, or full tensors, which each rank slices); the
    queries and the results are the same on every rank."""
    group = mesh.get_group("tp")
    spec = memory_shardings(mesh)

    def search(q: torch.Tensor, protos: torch.Tensor, valid: torch.Tensor):
        p_local = local(mesh, protos, spec["proto"])
        v_local = local(mesh, valid, spec["count"])
        vals, ids = local_topk(q.to(torch.float32).contiguous(), p_local, v_local, k,
                               offset=tp_rank(mesh) * p_local.shape[0])
        # only [B, kk] values and ids cross ranks, shard by shard
        return merge_candidates(all_gather_cat(vals, group, 1),
                                all_gather_cat(ids, group, 1), k)

    return search


def shard_prototypes(mesh: DeviceMesh, protos: torch.Tensor, valid: torch.Tensor):
    """``(protos, valid)`` placed on "tp" by class (each rank keeps its
    rows)."""
    spec = memory_shardings(mesh)
    return place(mesh, protos, spec["proto"]), place(mesh, valid, spec["count"])
