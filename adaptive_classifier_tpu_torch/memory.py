"""Prototype memory — padded device buffers and their state transitions.

Counterpart of ``adaptive_classifier_tpu/memory.py``.  Every stored example
embedding lives in one padded ``[C, E, D]`` buffer on the device; prototypes
are running means per class row; ``valid`` marks the rows that hold at least
one example.  Label slots equal the classifier's label ids, and class and
example capacities grow in the config's buckets.

Semantics kept from the JAX package:
- prototype = running mean of the embeddings a class has seen, weighted by
  ``pweight`` (after a load, the saved prototype's build-time count);
- capacity pruning keeps the examples closest to the class mean, in
  distance order, and recomputes only the pruned classes' prototypes;
- texts stay on the host, aligned row for row with the device buffer.

Unlike the JAX package, whose state transitions are pure functions, the
transitions here update the state's tensors **in place** on the device
(``add_batch``, ``prune``): a copy of the ``[C, E, D]`` buffer per append
would cost its whole size.  ``add_batch_host`` walks the JAX package's
append chunks but sends the chunks between two prunes to the device as one
update: the same state (up to the order of float sums) in fewer launches.
"""

from __future__ import annotations

import logging
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import Example, ModelConfig
from .ops import knn, knn_topk

logger = logging.getLogger(__name__)


@dataclass
class MemoryState:
    """Device-resident memory: example buffer, counts, prototypes."""

    emb: torch.Tensor       # [C, E, D] float32 — example embeddings (padded)
    count: torch.Tensor     # [C] int32 — valid examples per class row
    proto: torch.Tensor     # [C, D] float32 — running mean per class row
    pweight: torch.Tensor   # [C] float32 — embeddings aggregated into proto

    @property
    def class_capacity(self) -> int:
        return self.emb.shape[0]

    @property
    def example_capacity(self) -> int:
        return self.emb.shape[1]

    @property
    def dim(self) -> int:
        return self.emb.shape[2]

    @property
    def valid(self) -> torch.Tensor:
        return self.count > 0


def init_state(class_capacity: int, example_capacity: int, dim: int,
               device: Union[str, torch.device] = "cpu") -> MemoryState:
    return MemoryState(
        emb=torch.zeros((class_capacity, example_capacity, dim), device=device),
        count=torch.zeros((class_capacity,), dtype=torch.int32, device=device),
        proto=torch.zeros((class_capacity, dim), device=device),
        pweight=torch.zeros((class_capacity,), device=device),
    )


# ---------------------------------------------------------------------------
# state transitions
# ---------------------------------------------------------------------------

def recompute_prototypes(state: MemoryState) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (proto, pweight): the masked mean over stored examples and the
    buffer count (the state is not changed)."""
    E = state.example_capacity
    mask = (torch.arange(E, device=state.emb.device)[None, :]
            < state.count[:, None]).to(torch.float32)
    sums = torch.einsum("ce,ced->cd", mask, state.emb)
    denom = torch.clamp(state.count.to(torch.float32), min=1.0)[:, None]
    return sums / denom, state.count.to(torch.float32)


def add_batch(state: MemoryState, emb: torch.Tensor, cls: np.ndarray):
    """Append ``emb [n, D]`` to the class rows ``cls [n]`` (host int32; −1
    marks padding) in order, in place.  Position of example *i* is
    ``count[cls_i]`` plus the number of earlier batch items of its class;
    touched classes get a ``pweight``-weighted running-mean prototype."""
    cls = np.asarray(cls, np.int64)
    keep = cls >= 0
    if not keep.any():
        return
    cls_v = cls[keep]
    uniq, inv = np.unique(cls_v, return_inverse=True)
    # rank of each item within its class inside this batch
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(uniq)))
    rank = np.empty(len(cls_v), np.int64)
    rank[order] = np.arange(len(cls_v)) - starts[inv[order]]
    dev = state.emb.device
    E = state.example_capacity
    cls_t = torch.from_numpy(cls_v).to(dev)
    rows = emb[torch.from_numpy(np.flatnonzero(keep)).to(dev)] if not keep.all() else emb
    pos = torch.clamp(state.count[cls_t].to(torch.int64)
                      + torch.from_numpy(rank).to(dev), 0, E - 1)
    state.emb[cls_t, pos] = rows
    uniq_t = torch.from_numpy(uniq).to(dev)
    inv_t = torch.from_numpy(inv).to(dev)
    adds = torch.from_numpy(np.bincount(inv).astype(np.float32)).to(dev)
    sums = torch.zeros((len(uniq), state.dim), device=dev).index_add_(0, inv_t, rows)
    pw = state.pweight[uniq_t]
    new_pw = pw + adds
    state.proto[uniq_t] = ((state.proto[uniq_t] * pw[:, None] + sums)
                           / torch.clamp(new_pw, min=1.0)[:, None])
    state.pweight[uniq_t] = new_pw
    state.count[uniq_t] = torch.clamp(state.count[uniq_t] + adds.to(torch.int32),
                                      max=E)


def prune(state: MemoryState, max_examples: int) -> torch.Tensor:
    """Keep the ``max_examples`` embeddings closest to each class mean, in
    distance order, in place; recompute the pruned classes' prototypes.
    → ``order [C, E]``: ``order[c, j]`` is the old row now at ``j``."""
    C, E, _ = state.emb.shape
    dev = state.emb.device
    mask = torch.arange(E, device=dev)[None, :] < state.count[:, None]
    mean, _ = recompute_prototypes(state)
    diff = state.emb - mean[:, None, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    dist = torch.where(mask, dist, torch.full_like(dist, float("inf")))
    order = torch.argsort(dist, dim=1, stable=True)
    gathered = torch.gather(state.emb, 1, order[:, :, None].expand_as(state.emb))
    keep_n = torch.clamp(state.count, max=max_examples)
    keep_mask = torch.arange(E, device=dev)[None, :] < keep_n[:, None]
    pruned = keep_n < state.count
    state.emb.copy_(torch.where(keep_mask[:, :, None], gathered,
                                torch.zeros_like(gathered)))
    state.count.copy_(keep_n)
    rec_proto, rec_pw = recompute_prototypes(state)
    state.proto.copy_(torch.where(pruned[:, None], rec_proto, state.proto))
    state.pweight.copy_(torch.where(pruned, rec_pw, state.pweight))
    return order


def clear_class(state: MemoryState, slot: int):
    """Empty one class row in place: no examples, a zero prototype."""
    state.emb[slot] = 0.0
    state.count[slot] = 0
    state.proto[slot] = 0.0
    state.pweight[slot] = 0.0


def gather_training_set(state: MemoryState, n_cap: int):
    """Compact all stored examples into a flat training set
    → ``(emb [n, D], labels [n] int32, valid [n] bool)`` with real rows first
    in class-major order, ``n = min(n_cap, C·E)``."""
    C, E, D = state.emb.shape
    dev = state.emb.device
    mask = torch.arange(E, device=dev)[None, :] < state.count[:, None]
    flat_valid = mask.reshape(-1)
    flat_labels = torch.arange(C, device=dev, dtype=torch.int32)[:, None].expand(C, E).reshape(-1)
    order = torch.argsort((~flat_valid).to(torch.int8), stable=True)[:n_cap]
    return state.emb.reshape(C * E, D)[order], flat_labels[order], flat_valid[order]


# ---------------------------------------------------------------------------
# host facade
# ---------------------------------------------------------------------------

class PrototypeMemory:
    """Label ↔ slot bookkeeping, stored texts, and the device state."""

    def __init__(self, embedding_dim: int, config: Optional[ModelConfig] = None,
                 device: Union[str, torch.device] = "cpu"):
        self.embedding_dim = embedding_dim
        self.config = config or ModelConfig()
        self.device = torch.device(device)
        self._write_lock = threading.RLock()
        self.label_to_index: Dict[str, int] = {}
        self.index_to_label: Dict[int, str] = {}
        self.texts: Dict[str, List[str]] = {}
        self.updates_since_rebuild = 0
        self.state = init_state(self.config.class_capacity(1),
                                self.config.example_capacity(1),
                                embedding_dim, self.device)

    # -- capacity ------------------------------------------------------
    def _ensure_capacity(self, num_classes: int, max_count: int):
        C_need = self.config.class_capacity(num_classes)
        E_need = self.config.example_capacity(max_count)
        C, E, D = self.state.emb.shape
        if C_need > C or E_need > E:
            grown = init_state(max(C_need, C), max(E_need, E), D, self.device)
            grown.emb[:C, :E] = self.state.emb
            grown.count[:C] = self.state.count
            grown.proto[:C] = self.state.proto
            grown.pweight[:C] = self.state.pweight
            self.state = grown
            logger.debug(f"Memory grown to C={grown.class_capacity}, "
                         f"E={grown.example_capacity}")

    def _slot(self, label: str) -> int:
        with self._write_lock:
            if label not in self.label_to_index:
                idx = len(self.label_to_index)
                self._ensure_capacity(idx + 1, 1)
                self.label_to_index[label] = idx
                self.index_to_label[idx] = label
                self.texts[label] = []
            return self.label_to_index[label]

    def register_label(self, label: str) -> int:
        """Register a label so memory slot ids equal classifier label ids
        (the classifier registers new labels in id order)."""
        return self._slot(label)

    # -- mutation ------------------------------------------------------
    def add_example(self, example: Example, label: str):
        """Store one example whose embedding is set."""
        if example.embedding is None:
            raise ValueError("Example must have an embedding")
        emb = np.asarray(example.embedding, dtype=np.float32).reshape(-1)
        if emb.shape[-1] != self.embedding_dim:
            raise ValueError(f"Example embedding dimension {emb.shape[-1]} does not "
                             f"match memory dimension {self.embedding_dim}")
        self.add_batch_host([example.text], emb[None, :], [label])

    def add_batch_host(self, texts: List[str], embs: np.ndarray, labels: List[str]):
        """Append a batch and prune any class past ``max_examples_per_class``,
        keeping the host text lists aligned with the device rows."""
        with self._write_lock:
            self._add_batch_locked(texts, embs, labels)

    def _add_batch_locked(self, texts: List[str], embs: np.ndarray, labels: List[str]):
        slots = np.asarray([self._slot(l) for l in labels], dtype=np.int32)
        counts = {l: len(ts) for l, ts in self.texts.items()}
        adds_per_label = Counter(labels)
        max_after = max((counts.get(l, 0) + n for l, n in adds_per_label.items()),
                        default=1)
        self._ensure_capacity(len(self.label_to_index), max_after)

        E = self.state.example_capacity
        max_ex = min(self.config.max_examples_per_class, E)
        if E <= max_ex and self.config.example_capacity(E + 1) <= E and E > 1:
            # the buffer is at its bucket ceiling and cannot grow: keep one
            # slack row, else an append would land on row E-1 and overwrite
            # a stored example
            max_ex = E - 1
        headroom = max(E - max_ex, 1)
        chunk = max(1, min(max(self.config.example_capacity_slack, 1), headroom))
        embs_t = torch.from_numpy(np.ascontiguousarray(embs, np.float32)).to(self.device)
        # the JAX package's chunk loop; the device append of the chunks
        # since the last prune is deferred until the next prune needs them
        # (or the loop ends), which gives the same state in fewer updates
        flushed = 0
        for s in range(0, len(labels), chunk):
            cs = slice(s, s + chunk)
            for t, l in zip(texts[cs], labels[cs]):
                self.texts[l].append(t)
            self.updates_since_rebuild += len(labels[cs])
            if any(len(self.texts[l]) > max_ex for l in set(labels[cs])):
                end = min(s + chunk, len(labels))
                add_batch(self.state, embs_t[flushed:end], slots[flushed:end])
                flushed = end
                self._prune(max_ex)
        if flushed < len(labels):
            add_batch(self.state, embs_t[flushed:], slots[flushed:])
        if self.updates_since_rebuild >= self.config.prototype_update_frequency:
            self.updates_since_rebuild = 0

    def _prune(self, max_ex: Optional[int] = None):
        max_ex = max_ex if max_ex is not None else self.config.max_examples_per_class
        order_np = prune(self.state, max_ex).cpu().numpy()
        # prune distance-sorts every class's rows: realign every text list
        for label, slot in self.label_to_index.items():
            ts = self.texts[label]
            if ts:
                keep = order_np[slot, : min(len(ts), max_ex)]
                self.texts[label] = [ts[i] for i in keep if i < len(ts)]

    def restore_class(self, label: str, texts: List[str], embs: np.ndarray,
                      prototype: Optional[np.ndarray] = None,
                      prototype_weight: Optional[float] = None):
        """Load-path restore of one class: its saved texts and embeddings and
        its exact saved prototype (or the mean of ``embs`` when none was
        saved).  A class with a prototype but no saved texts keeps the
        prototype as its one stored row.  ``prototype_weight`` is how many
        embeddings the saved prototype aggregates."""
        with self._write_lock:
            slot = self._slot(label)
            n = len(texts)
            self._ensure_capacity(len(self.label_to_index), max(n, 1))
            self.texts[label] = list(texts)
            st = self.state
            if n > 0:
                st.emb[slot, :n] = torch.from_numpy(
                    np.asarray(embs[:n], np.float32)).to(self.device)
                st.count[slot] = n
            elif prototype is not None:
                self.texts[label] = [f"<prototype:{label}>"]
                st.emb[slot, 0] = torch.from_numpy(
                    np.asarray(prototype, np.float32)).to(self.device)
                st.count[slot] = 1
                n = 1
            if prototype is not None:
                st.proto[slot] = torch.from_numpy(
                    np.asarray(prototype, np.float32)).to(self.device)
            elif n > 0:
                st.proto[slot] = st.emb[slot, :n].mean(dim=0)
            st.pweight[slot] = float(max(prototype_weight or 0, n))

    def reembed(self, embed_fn):
        """Embed every stored text again with ``embed_fn(texts) → [N, D]``
        and rebuild the device state from them; label slots stay as they
        are.  (Its caller in the JAX package, encoder fine-tuning, is not
        ported.)"""
        with self._write_lock:
            texts_by_label = {l: list(ts) for l, ts in self.texts.items()}
            C, E, D = self.state.emb.shape
            self.state = init_state(C, E, D, self.device)
            all_texts: List[str] = []
            all_labels: List[str] = []
            for l, ts in texts_by_label.items():
                self.texts[l] = []
                all_texts += ts
                all_labels += [l] * len(ts)
            if all_texts:
                embs = np.asarray(embed_fn(all_texts), np.float32)
                self._add_batch_locked(all_texts, embs, all_labels)

    def clear(self):
        """Forget every label and example; the capacities stay."""
        with self._write_lock:
            C, E, D = self.state.emb.shape
            self.state = init_state(C, E, D, self.device)
            self.label_to_index.clear()
            self.index_to_label.clear()
            self.texts.clear()
            self.updates_since_rebuild = 0

    def remove_label(self, label: str):
        """Forget a label's examples and prototype; its slot stays
        registered."""
        with self._write_lock:
            if label not in self.label_to_index:
                return
            clear_class(self.state, self.label_to_index[label])
            self.texts[label] = []

    # -- host views ----------------------------------------------------
    def class_embeddings(self, label: str) -> np.ndarray:
        """The stored embeddings of ``label`` on the host, ``[n, D]``."""
        slot = self.label_to_index[label]
        n = len(self.texts.get(label, ()))
        return self.state.emb[slot, :n].cpu().numpy()

    def _counts_host(self) -> Dict[str, int]:
        return {label: len(ts) for label, ts in self.texts.items()}

    @property
    def prototypes(self) -> Dict[str, np.ndarray]:
        """Prototypes of the labels that hold at least one example."""
        proto = self.state.proto.cpu().numpy()
        return {label: proto[slot] for label, slot in self.label_to_index.items()
                if self.texts.get(label)}

    @property
    def examples(self) -> Dict[str, List[Example]]:
        """Stored examples as ``Example`` objects, embeddings on the host."""
        emb = self.state.emb.cpu().numpy()
        return {label: [Example(t, label, emb[slot, i].copy()) for i, t in enumerate(ts)]
                for label, slot in self.label_to_index.items()
                if (ts := self.texts.get(label))}

    def get_stats(self) -> Dict[str, object]:
        counts = self._counts_host()
        return {
            "num_classes": sum(1 for v in counts.values() if v > 0),
            "examples_per_class": {label: c for label, c in counts.items() if c > 0},
            "total_examples": sum(counts.values()),
            "prototype_dimensions": self.embedding_dim,
            "updates_since_rebuild": self.updates_since_rebuild,
        }

    # -- queries -------------------------------------------------------
    def sims_for(self, queries: torch.Tensor) -> torch.Tensor:
        """Masked ``exp(−d²)`` similarities ``[B, C]`` against the current
        prototypes (kernel B4 on a GPU at ``pallas_knn_min_classes``)."""
        return knn.masked_sims(queries, self.state.proto, self.state.valid,
                               pallas_min_classes=self.config.pallas_knn_min_classes)

    def _topk_search(self, q: torch.Tensor, k: int):
        """→ (scores [B, k], idx [B, k], raw [B, k]); large indexes go
        through kernel B5 on a GPU.  The materialized branch keeps the
        default B4 threshold, as the JAX package does."""
        return knn_topk.topk_scores_auto(
            q, self.state.proto, self.state.valid, k,
            fused_min_classes=self.config.fused_topk_min_classes,
            return_raw=True)

    def get_nearest_prototypes(self, query_embedding, k: int = 5,
                               min_similarity: Optional[float] = None
                               ) -> List[Tuple[str, float]]:
        """(label, softmax score) of the k nearest prototypes; labels whose
        raw ``exp(−d²)`` is below ``min_similarity`` are dropped."""
        n_valid = sum(1 for v in self.texts.values() if v)
        if n_valid == 0:
            return []
        k = min(k, n_valid)
        q = torch.from_numpy(np.asarray(query_embedding, np.float32).reshape(1, -1))
        scores, idx, raw = (t[0].cpu().numpy() for t in
                            self._topk_search(q.to(self.device), k))
        return [(self.index_to_label[int(i)], float(s))
                for i, s, r in zip(idx, scores, raw)
                if i >= 0 and (min_similarity is None or r >= min_similarity)]
