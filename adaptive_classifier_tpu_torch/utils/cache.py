"""Embedding caches: a host LRU and a ring buffer on the device.

Counterpart of ``adaptive_classifier_tpu/utils/cache.py``.  The encoder is
frozen, so the embedding of a text at a given ``max_length`` never changes
and a repeated text need not be tokenized or run through the encoder again.

- ``EmbeddingCache`` keeps rows on the host, keyed by ``(text,
  max_length)``, least recently used out first.  ``_get_embeddings`` reads
  it (``add_examples`` and the other host callers).
- ``DeviceEmbeddingCache`` keeps rows in one ``[capacity, D]`` float32
  buffer on the classifier's device, with the ``text → slot`` dict on the
  host; the predict path stores each chunk it embeds and gathers the rows
  of repeated texts, so the rows never leave the device and only the slot
  indices are uploaded.  Slots are reused in ring order, oldest first.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch


class EmbeddingCache:
    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._data: "OrderedDict[Tuple[str, int], np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, texts: List[str], max_length: int):
        """→ (cached rows, ``None`` where missing; miss indices)."""
        out: List[Optional[np.ndarray]] = []
        misses: List[int] = []
        with self._lock:
            for i, t in enumerate(texts):
                key = (t, max_length)
                row = self._data.get(key)
                if row is None:
                    misses.append(i)
                    out.append(None)
                    self.misses += 1
                else:
                    self._data.move_to_end(key)
                    out.append(row)
                    self.hits += 1
        return out, misses

    def store(self, texts: List[str], max_length: int, rows: np.ndarray):
        if self.capacity <= 0:
            return
        with self._lock:
            for t, row in zip(texts, rows):
                self._data[(t, max_length)] = np.asarray(row)
                self._data.move_to_end((t, max_length))
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def clear(self):
        with self._lock:
            self._data.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._data), "hits": self.hits, "misses": self.misses}


class DeviceEmbeddingCache:
    """Embedding rows in one ``[capacity, dim]`` float32 buffer on
    ``device``; the host keeps only the ``text → slot`` dict.

    Construct it outside ``torch.inference_mode()``: the buffer is written
    in place by every ``store``, and a tensor made in inference mode cannot
    be written in place outside it.  ``store`` enqueues its device write
    while it holds the lock that publishes the new slots, on the current
    stream, so a ``gather`` that finds a slot is queued after the write
    that filled it.
    """

    def __init__(self, capacity: int, dim: int,
                 device: Union[str, torch.device] = "cpu"):
        self.capacity = max(int(capacity), 1)
        self.dim = dim
        self.device = torch.device(device)
        self._buf = torch.zeros((self.capacity, dim), dtype=torch.float32,
                                device=self.device)
        self._slot_of: Dict[Tuple[str, int], int] = {}
        self._text_at: List[Optional[Tuple[str, int]]] = [None] * self.capacity
        self._next = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, texts: List[str], max_length: int):
        """→ (hit pairs ``[(index in texts, slot)]``, miss indices)."""
        hits: List[Tuple[int, int]] = []
        misses: List[int] = []
        with self._lock:
            for i, t in enumerate(texts):
                slot = self._slot_of.get((t, max_length))
                if slot is None:
                    misses.append(i)
                    self.misses += 1
                else:
                    hits.append((i, slot))
                    self.hits += 1
        return hits, misses

    def gather(self, slots: List[int]) -> torch.Tensor:
        """The rows at ``slots`` as a ``[n, dim]`` device tensor; only the
        indices are uploaded."""
        idx = torch.tensor(slots, dtype=torch.int64).to(self.device, non_blocking=True)
        with self._lock:
            return self._buf.index_select(0, idx)

    def store(self, texts: List[str], max_length: int, emb: torch.Tensor):
        """Write the first ``len(texts)`` rows of ``emb [m, dim]`` (on the
        device; ``m >= n`` for a padded chunk) into the next ring slots.
        Only those ``n`` rows are written: the padding rows have no slot."""
        n = len(texts)
        if n == 0:
            return
        with self._lock:
            slots = []
            for t in texts:
                s = self._next
                self._next = (self._next + 1) % self.capacity
                old = self._text_at[s]
                if old is not None:
                    self._slot_of.pop(old, None)
                self._text_at[s] = (t, max_length)
                self._slot_of[(t, max_length)] = s
                slots.append(s)
            if n > self.capacity:
                # the ring wrapped within this call: the last write of a
                # slot is the one the dict points at
                slots, rows = slots[-self.capacity:], emb[n - self.capacity:n]
            else:
                rows = emb[:n]
            idx = torch.tensor(slots, dtype=torch.int64).to(self.device, non_blocking=True)
            self._buf.index_copy_(0, idx, rows.to(torch.float32))

    def clear(self):
        with self._lock:
            self._slot_of.clear()
            self._text_at = [None] * self.capacity
            self._next = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._slot_of), "hits": self.hits, "misses": self.misses}
