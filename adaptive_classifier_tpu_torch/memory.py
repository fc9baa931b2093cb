"""Prototype memory — the part that loading and predicting use.

Counterpart of ``adaptive_classifier_tpu/memory.py``.  Label slots equal the
classifier's label ids; prototypes live in a ``[C_cap, D]`` matrix padded to
the config's class-capacity buckets, with ``valid`` marking the slots that
hold one.  The state is assembled on the host while a checkpoint loads and
copied to the device once, on first use.

The example buffer and its updates (``add_batch``, pruning, running-mean
prototype weights, re-embedding) come with ``add_examples`` in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .config import ModelConfig


@dataclass(frozen=True)
class MemoryState:
    """Device-resident prototypes."""

    proto: torch.Tensor     # [C, D] float32 — one prototype per class slot
    valid: torch.Tensor     # [C] bool — slots that hold a prototype

    @property
    def class_capacity(self) -> int:
        return self.proto.shape[0]


class PrototypeMemory:
    """Label ↔ slot bookkeeping, stored texts, and the prototype state."""

    def __init__(self, embedding_dim: int, config: Optional[ModelConfig] = None,
                 device: Union[str, torch.device] = "cpu"):
        self.embedding_dim = embedding_dim
        self.config = config or ModelConfig()
        self.device = torch.device(device)
        self.label_to_index: Dict[str, int] = {}
        self.texts: Dict[str, List[str]] = {}
        C = self.config.class_capacity(1)
        self._proto = np.zeros((C, embedding_dim), np.float32)
        self._valid = np.zeros((C,), bool)
        self._state: Optional[MemoryState] = None

    @property
    def state(self) -> MemoryState:
        if self._state is None:
            self._state = MemoryState(proto=torch.from_numpy(self._proto).to(self.device),
                                      valid=torch.from_numpy(self._valid).to(self.device))
        return self._state

    def register_label(self, label: str) -> int:
        """The slot of ``label``, registering it (and growing the capacity to
        the next bucket) if it is new.  The classifier registers labels in id
        order, so slots equal label ids."""
        if label not in self.label_to_index:
            idx = len(self.label_to_index)
            self.label_to_index[label] = idx
            self.texts[label] = []
            grow = self.config.class_capacity(idx + 1) - self._proto.shape[0]
            if grow > 0:
                self._proto = np.pad(self._proto, ((0, grow), (0, 0)))
                self._valid = np.pad(self._valid, (0, grow))
                self._state = None
        return self.label_to_index[label]

    def restore_class(self, label: str, texts: List[str], embs: np.ndarray,
                      prototype: Optional[np.ndarray] = None):
        """Load-path restore of one class: its saved texts and its exact saved
        prototype, or the mean of ``embs`` when none was saved.  A class with
        a prototype but no saved texts keeps the prototype as its one stored
        row, as the JAX package does."""
        slot = self.register_label(label)
        self.texts[label] = list(texts) or (
            [f"<prototype:{label}>"] if prototype is not None else [])
        if prototype is not None:
            self._proto[slot] = np.asarray(prototype, np.float32)
        elif texts:
            self._proto[slot] = np.asarray(embs[:len(texts)], np.float32).mean(axis=0)
        self._valid[slot] = bool(self.texts[label])
        self._state = None
