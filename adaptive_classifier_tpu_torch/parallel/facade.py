"""The sharded classifier: memory and head placed over the mesh's "tp" axis.

Counterpart of ``adaptive_classifier_tpu/parallel/facade.py``.  The
public API is the classifier's; every rank makes the same calls (SPMD)
and gets the same answers.

- ``ShardedPrototypeMemory`` keeps its device state as ``DTensor``s
  sharded by class over "tp": a rank holds ``C / tp`` class rows of the
  example buffer, the prototypes and the counts.  At
  ``shard_knn_min_classes`` classes and more, with tp > 1 and C
  divisible by tp, ``get_nearest_prototypes`` runs shard-local
  (``sharded_knn.make_sharded_topk``: a top-k on each shard, only
  ``[B, k]`` candidates gathered).  Other reads of ``state`` see the
  whole state: the ``[C, D]`` prototypes and the ``[C]`` vectors are
  gathered over tp at their first read and kept until the state is
  placed again; the ``[C, E, D]`` buffer is gathered at each read and not
  kept.  A write (``add_batch_host``, ``restore_class``,
  ``remove_label``, ``reembed``) gathers the whole state once, runs the
  single-device transition on it and places the result again, so a
  write needs the whole buffer on each rank for its duration.
- ``ShardedAdaptiveClassifier`` swaps that memory in and places its head
  after every assignment (each fit): the output layer's class columns over
  "tp", hidden layers replicated.  ``predict`` and ``predict_batch`` run
  shard-local: each rank scores its own classes against the query rows
  (``sharded.fuse_full_local`` / ``fuse_topk_local``; kernel B4 for a
  CUDA tensor) and only row statistics and ``[B, k]`` candidates cross
  ranks.  Every rank embeds the whole request (the encoder is
  replicated; ``sharded.make_sharded_predict`` is the step that splits
  rows over "dp").  The fit, ``predict_proba`` and the other reads of
  ``head_params`` see the head gathered once after each placement.

A class count that does not divide by tp is kept replicated, and its
predicts run on the whole state.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .. import training
from ..classifier import AdaptiveClassifier
from ..memory import MemoryState, PrototypeMemory
from .mesh import (full, head_shardings, make_mesh, memory_shardings, place, replicated,
                   tp_rank)
from .sharded import fuse_full_local, fuse_topk_local

_FIELDS = ("emb", "count", "proto", "pweight")


class _GatheredState:
    """A read view of placed ``MemoryState`` fields: each field is gathered
    at its read, and all but the ``[C, E, D]`` buffer are kept; the
    capacities come from the global shapes."""

    def __init__(self, placed: MemoryState):
        self._placed = placed
        self._full = {}

    def _field(self, name: str) -> torch.Tensor:
        if name == "emb":
            return full(self._placed.emb)
        if name not in self._full:
            self._full[name] = full(getattr(self._placed, name))
        return self._full[name]

    emb = property(lambda self: self._field("emb"))
    count = property(lambda self: self._field("count"))
    proto = property(lambda self: self._field("proto"))
    pweight = property(lambda self: self._field("pweight"))
    class_capacity = property(lambda self: self._placed.emb.shape[0])
    example_capacity = property(lambda self: self._placed.emb.shape[1])
    dim = property(lambda self: self._placed.emb.shape[2])
    valid = property(lambda self: self.count > 0)


class ShardedPrototypeMemory(PrototypeMemory):
    """``PrototypeMemory`` whose device state lives sharded by class over
    the mesh's "tp" axis (``mesh=None``: a plain memory)."""

    #: class capacity from which kNN queries run shard-local
    shard_knn_min_classes = 1024

    def __init__(self, embedding_dim: int, config=None,
                 device: Union[str, torch.device] = "cpu",
                 mesh: Optional[DeviceMesh] = None):
        self.mesh = mesh        # before the base __init__ assigns the state
        self._placed: Optional[MemoryState] = None
        self._view: Optional[_GatheredState] = None
        self._work: Optional[MemoryState] = None
        #: whether the state is placed by class over "tp" (else replicated)
        self.by_class = False
        self._sharded_topk = {}
        super().__init__(embedding_dim, config, device)

    @property
    def state(self):
        if self._work is not None:
            return self._work
        if self.mesh is None:
            return self._placed
        if self._view is None:
            self._view = _GatheredState(self._placed)
        return self._view

    @state.setter
    def state(self, value):
        if self._work is not None:
            self._work = value
            return
        if self.mesh is None:
            self._placed = value
            return
        spec = memory_shardings(self.mesh)
        self.by_class = value.class_capacity % self.mesh.size(1) == 0
        if not self.by_class:
            spec = {f: replicated(self.mesh) for f in _FIELDS}
        self._placed = MemoryState(**{f: place(self.mesh, full(getattr(value, f)), spec[f])
                                      for f in _FIELDS})
        self._view = None

    @contextlib.contextmanager
    def _writing(self):
        """Run a write on the whole state, gathered once and placed again."""
        if self.mesh is None or self._work is not None:
            yield
            return
        with self._write_lock:
            self._work = MemoryState(**{f: full(getattr(self._placed, f)) for f in _FIELDS})
            try:
                yield
            finally:
                work, self._work = self._work, None
                self.state = work

    def add_batch_host(self, *args, **kwargs):
        with self._writing():
            super().add_batch_host(*args, **kwargs)

    def restore_class(self, *args, **kwargs):
        with self._writing():
            super().restore_class(*args, **kwargs)

    def remove_label(self, label: str):
        with self._writing():
            super().remove_label(label)

    def reembed(self, embed_fn):
        with self._writing():
            super().reembed(embed_fn)

    def _use_shard_knn(self) -> bool:
        if self.mesh is None:
            return False
        ntp = self.mesh.size(1)
        C = self.state.class_capacity
        return ntp > 1 and C >= self.shard_knn_min_classes and C % ntp == 0

    def _topk_search(self, q: torch.Tensor, k: int):
        """The search core, shard-local above the threshold; the semantics
        around it (the k clamp, ``min_similarity`` on the raw scores,
        labels) stay in ``PrototypeMemory.get_nearest_prototypes``."""
        if not self._use_shard_knn():
            return super()._topk_search(q, k)
        from .sharded_knn import make_sharded_topk

        if k not in self._sharded_topk:
            self._sharded_topk[k] = make_sharded_topk(self.mesh, k)
        count = self._placed.count
        valid = DTensor.from_local(count.to_local() > 0, self.mesh, count.placements,
                                   run_check=False)
        return self._sharded_topk[k](q, self._placed.proto, valid)


class ShardedAdaptiveClassifier(AdaptiveClassifier):
    """``AdaptiveClassifier`` with its memory and head sharded over the
    mesh (default: ``make_mesh()`` over every rank of the process group,
    which must be running).  Answers equal the single-device classifier's:
    sharding changes where the state lives, not what it computes.

    >>> mesh = make_mesh()                    # after initialize_distributed
    >>> clf = ShardedAdaptiveClassifier("bert-base-uncased", mesh=mesh)
    """

    def __init__(self, model_name: str, mesh: Optional[DeviceMesh] = None, **kwargs):
        self.mesh = mesh if mesh is not None else make_mesh()
        self._head_placed = None
        self._head_full = None
        self._head_by_class = False
        super().__init__(model_name, **kwargs)
        plain = self.memory
        self.memory = ShardedPrototypeMemory(self.embedding_dim, config=self.config,
                                             device=self.device, mesh=self.mesh)
        self.memory.state = plain.state

    @property
    def head_params(self):
        if self._head_full is None and self._head_placed is not None:
            self._head_full = training.tree_map(full, self._head_placed)
        return self._head_full

    @head_params.setter
    def head_params(self, value):
        """Every assignment (each fit) places the head: class columns over
        "tp", hidden layers replicated."""
        self._head_full = None
        if value is None:
            self._head_placed = None
            return
        specs = head_shardings(self.mesh, value)
        self._head_by_class = value["out"]["w"].shape[1] % self.mesh.size(1) == 0
        if not self._head_by_class:
            specs = training.tree_map(lambda _: replicated(self.mesh), value)
        self._head_placed = training.tree_map(
            lambda t, s: place(self.mesh, full(t), s), value, specs)

    def _class_slice(self):
        """This rank's classes for a shard-local predict → (offset,
        prototypes, valid, head with its column slice, or None without a
        head), or None where the memory or the head is not placed by class
        over "tp"."""
        mem, head = self.memory, self._head_placed
        if not mem.by_class:
            return None
        C = mem._placed.proto.shape[0]
        if head is not None and not (self._head_by_class and head["out"]["w"].shape[1] == C):
            return None
        proto = mem._placed.proto.to_local()
        valid = mem._placed.count.to_local() > 0
        head_l = None if head is None else training.tree_map(lambda t: t.to_local(), head)
        return tp_rank(self.mesh) * proto.shape[0], proto, valid, head_l

    def _full_fusion(self, kk: int):
        part = self._class_slice()
        if part is None:
            return super()._full_fusion(kk)
        off, proto, valid, head = part
        cols = slice(off, off + proto.shape[0])
        pw, hw = self._history_weights()
        active = self._active_mask()[cols]
        bias = self._proto_bias_arr()
        bias = None if bias is None else bias[cols]
        group = self.mesh.get_group("tp")

        def fuse(emb):
            return fuse_full_local(group, emb, proto, valid, head, active, pw[cols],
                                   hw[cols], off, kk, head is not None, proto_bias=bias)

        return fuse

    def _topk_fusion(self, kk: int, proto_weight: float):
        part = self._class_slice()
        if part is None:
            return super()._topk_fusion(kk, proto_weight)
        off, proto, valid, head = part
        cols = slice(off, off + proto.shape[0])
        active = self._active_mask()[cols]
        bias = self._proto_bias_arr()
        bias = None if bias is None else bias[cols]
        group = self.mesh.get_group("tp")

        def fuse(emb):
            return fuse_topk_local(group, emb, proto, valid, head, active, proto_weight,
                                   1.0 - proto_weight, off, kk, head is not None,
                                   proto_bias=bias)

        return fuse

    def to(self, device: Union[str, torch.device]) -> "ShardedAdaptiveClassifier":
        """A sharded classifier lives on its mesh's devices: ``self`` for
        that device type, ``ValueError`` for another."""
        if torch.device(device).type != self.device.type:
            raise ValueError(f"a sharded classifier stays on its mesh's "
                             f"{self.device.type} devices")
        return self
