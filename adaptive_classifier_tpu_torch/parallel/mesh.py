"""The ("dp", "tp") device mesh and the placements of the sharded state.

Counterpart of ``adaptive_classifier_tpu/parallel/mesh.py`` on
``torch.distributed``: a 2-D ``DeviceMesh`` with dims ``("dp", "tp")``
over the ranks of the process group, one rank per GPU (NCCL) or per
process on the CPU (gloo).  Layout, as in the JAX package:

- the example buffer ``[C, E, D]``, the prototypes ``[C, D]`` and the
  per-class vectors shard on the class axis over "tp", so similarities
  and each shard's top-k are computed where the rows live, and only the
  small ``[B, k]`` candidate lists cross ranks;
- the head's output layer ``[Dh, C]`` shards its columns over "tp"
  (column parallel); hidden layers are replicated;
- batches shard their rows over "dp"; the encoder is replicated.

A placement is a tuple of ``torch.distributed.tensor`` placements, one
per mesh dim.  ``place`` turns a full tensor, which every rank holds
alike (SPMD), into a ``DTensor`` of the rank's own slice without any
communication; ``full`` gathers one back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

Placements = Tuple


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """``(dp, tp)`` for ``n`` ranks.  By default tp is the largest divisor
    of ``n`` that is at most √n and dp takes the rest (n = 8 → 4 × 2,
    n = 4 → 2 × 2): batch parallelism first, as the JAX package lays it
    out; pass ``tp`` for an index too large for one device."""
    if dp is None and tp is None:
        tp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"mesh {dp} x {tp} does not cover {n} ranks")
    return dp, tp


def _require_group():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "parallel.multihost.initialize_distributed (or "
            "torch.distributed.init_process_group) first")


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> DeviceMesh:
    """A ("dp", "tp") mesh over every rank of the process group (CUDA
    devices under NCCL, the CPU under gloo).  ``n_devices`` must equal the
    world size when given; it raises without a process group."""
    _require_group()
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, "
                         f"world size {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(n, dp, tp),
                            mesh_dim_names=("dp", "tp"))


def memory_shardings(mesh: DeviceMesh) -> dict:
    """Placements of a ``MemoryState``: the class axis over "tp"."""
    by_class = (Replicate(), Shard(0))
    return {"emb": by_class, "count": by_class, "proto": by_class, "pweight": by_class}


def head_shardings(mesh: DeviceMesh, params) -> dict:
    """Column-parallel output layer (and skip probe); hidden layers
    replicated."""
    rep = replicated(mesh)
    out = {"hidden": [{"w": rep, "b": rep} for _ in params["hidden"]],
           "out": {"w": (Replicate(), Shard(1)), "b": (Replicate(), Shard(0))}}
    if "skip" in params:
        out["skip"] = {"w": (Replicate(), Shard(1))}
    return out


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(), Replicate())


def batch_sharding(mesh: DeviceMesh, ndim: int) -> Placements:
    """The first axis over "dp", the rest replicated (``ndim`` is the
    tensor's rank, kept for the JAX package's signature)."""
    return (Shard(0), Replicate())


def place(mesh: DeviceMesh, tensor: torch.Tensor, placements: Placements) -> DTensor:
    """The ``DTensor`` of ``tensor`` (the full value, alike on every rank)
    under ``placements``: each rank keeps its own slice, nothing is sent.
    A sharded axis must divide evenly."""
    if isinstance(tensor, DTensor):
        if tuple(tensor.placements) == tuple(placements):
            return tensor
        return tensor.redistribute(mesh, placements)
    local = tensor
    coord = mesh.get_coordinate()
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(dim)
            if local.shape[p.dim] % n:
                raise ValueError(f"axis {p.dim} of {tuple(tensor.shape)} does not split "
                                 f"into {n} shards")
            local = local.chunk(n, dim=p.dim)[coord[dim]]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False)


def local(mesh: DeviceMesh, x: torch.Tensor, placements: Placements) -> torch.Tensor:
    """This rank's slice of ``x``: a ``DTensor``'s local part, or the
    slice ``place`` would keep of a full tensor."""
    return place(mesh, x, placements).to_local()


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a ``DTensor`` (gathered over its sharded dims);
    a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def tp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("tp")


def dp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("dp")


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is kept)."""
    out = x.clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out
