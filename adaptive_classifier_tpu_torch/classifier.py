"""AdaptiveClassifier — loading a saved classifier and predicting with it.

Counterpart of ``adaptive_classifier_tpu/classifier.py`` for the serving
path: ``load``, ``predict_batch`` and ``predict``.  Texts are tokenized (and,
with the lexical channel on, hashed into TF-IDF features) on the host; the
encoder forward, channel composition, prototype similarities, head logits
and fusion run on the device, and one packed ``[N, 2k]`` block of scores and
ids comes back per call.

``add_examples`` and the training paths, strategic mode, the embedding
cache (``embedding_cache_size`` is read and ignored), saving and the other
surfaces come with later slices.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .config import ModelConfig
from .memory import PrototypeMemory
from .models.encoder import Encoder
from .models.head import HeadParams
from .ops import fusion

Predictions = List[List[Tuple[str, float]]]


class AdaptiveClassifier:
    """A saved adaptive classifier, served from PyTorch.

    ``device`` defaults to ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        model_name: str,
        device: Optional[Union[str, torch.device]] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        self.config = ModelConfig(config)
        if self.config.enable_strategic_mode:
            raise NotImplementedError("strategic mode comes with a later slice")
        self.model_name = model_name
        self.device = resolve_device(device)
        self.encoder = Encoder(model_name, compute_dtype=self.config.compute_dtype,
                               device=self.device,
                               quantization=self.config.quantization)
        #: hashed TF-IDF lexical channel; None = encoder embedding only
        self.lexical = None
        if self.config.lexical_dim:
            from .lexical import HashedTfidf

            self.lexical = HashedTfidf(self.config.lexical_dim,
                                       self.config.lexical_weight,
                                       self.config.lexical_grams)
        self.embedding_dim = self.encoder.hidden_size + (
            self.lexical.dim if self.lexical is not None else 0)
        self.memory = PrototypeMemory(self.embedding_dim, config=self.config,
                                      device=self.device)
        self.head_params: Optional[HeadParams] = None
        self.label_to_id: Dict[str, int] = {}
        self.id_to_label: Dict[int, str] = {}
        self.training_history: Dict[str, int] = {}
        #: per-class prototype bias from incremental training; None = none
        self._proto_bias: Optional[np.ndarray] = None
        #: fitted prototype share of the fusion; None = reference weighting
        self._fusion_alpha: Optional[float] = None

    @classmethod
    def load(cls, save_dir: Union[str, Path],
             device: Optional[Union[str, torch.device]] = None) -> "AdaptiveClassifier":
        from . import persistence

        return persistence.load_classifier(cls, Path(save_dir), device=device)

    def add_examples(self, texts: List[str], labels: List[str]):
        raise NotImplementedError("add_examples (prototype update, ridge fit, "
                                  "fusion fit) comes with a later slice")

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def _tokenize_chunk(self, part: List[str], pad_to: int):
        """→ (ids, mask, lex) for ``part`` padded with empty texts to
        ``pad_to`` rows; ``lex`` is None with the lexical channel off."""
        padded = list(part) + [""] * (max(pad_to, len(part)) - len(part))
        ids, mask = self.encoder.tokenizer(
            padded, max_length=self.config.max_length,
            pad_to_buckets=self.encoder.SEQ_BUCKETS)
        lex = None
        if self.lexical is not None:
            if not self.lexical.ready:
                raise RuntimeError("lexical channel not ready: load a checkpoint "
                                   "that carries lexical.json")
            lex = self.lexical.transform(padded)
        return ids, mask, lex

    def _compose_channels(self, enc: torch.Tensor, lex: Optional[np.ndarray]) -> torch.Tensor:
        """``[enc, w*lex] / sqrt(1+w²)`` on the device; identity without lex."""
        if lex is None:
            return enc
        w = float(self.lexical.weight)
        s = 1.0 / math.sqrt(1.0 + w * w)
        lex_t = torch.from_numpy(lex).to(enc.device, non_blocking=True)
        return torch.cat([enc * s, lex_t * (w * s)], dim=1)

    # ------------------------------------------------------------------
    # masks / weights
    # ------------------------------------------------------------------
    @property
    def _class_capacity(self) -> int:
        return self.memory.state.class_capacity

    def _active_mask(self) -> torch.Tensor:
        return torch.arange(self._class_capacity, device=self.device) < len(self.label_to_id)

    def _history_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-label fusion weights: a fitted fusion share applies uniformly;
        otherwise <10 trained examples → proto 0.3 / head 0.7, else 0.7/0.3."""
        C = self._class_capacity
        if self._fusion_alpha is not None:
            pw = np.full((C,), self._fusion_alpha, np.float32)
        else:
            pw = np.full((C,), 0.3, np.float32)
            for label, idx in self.label_to_id.items():
                pw[idx] = 0.3 if self.training_history.get(label, 0) < 10 else 0.7
        pw_t = torch.from_numpy(pw).to(self.device)
        return pw_t, 1.0 - pw_t

    def _proto_bias_arr(self) -> Optional[torch.Tensor]:
        """Calibration bias padded to the class capacity (or None)."""
        if self._proto_bias is None:
            return None
        b = np.zeros((self._class_capacity,), np.float32)
        n = min(len(self._proto_bias), b.shape[0])
        b[:n] = self._proto_bias[:n]
        return torch.from_numpy(b).to(self.device)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def predict(self, text: str, k: int = 5) -> List[Tuple[str, float]]:
        """Top-k labels for one text, with the full-distribution fusion of
        the JAX package's ``predict`` (per-label history weights)."""
        if not text:
            raise ValueError("Empty input text")
        if not self.label_to_id:
            return []
        pw, hw = self._history_weights()
        kk = min(max(k, 1), self._class_capacity)
        state = self.memory.state
        active = self._active_mask()
        proto_bias = self._proto_bias_arr()
        has_head = self.head_params is not None

        def fuse(emb):
            return fusion.fuse_full_from_emb(
                emb, state.proto, state.valid, self.head_params, active, pw, hw,
                kk, has_head, pallas_min_classes=self.config.pallas_knn_min_classes,
                proto_bias=proto_bias)

        return self._predict_rows([text], fuse, kk, k)[0]

    def predict_batch(self, texts: List[str], k: int = 5,
                      batch_size: Optional[int] = None) -> Predictions:
        """Top-k labels per text: prototype top-k fused with the head's top-k
        at a fixed prototype share (the fitted one, else 0.7).

        ``batch_size`` caps the rows per device chunk (default
        ``config.embed_chunk_size``)."""
        if not texts:
            raise ValueError("Empty input batch")
        if not self.label_to_id:
            return [[] for _ in texts]
        kk = min(max(k, 1), self._class_capacity)
        state = self.memory.state
        active = self._active_mask()
        proto_bias = self._proto_bias_arr()
        pw = 0.7 if self._fusion_alpha is None else float(self._fusion_alpha)
        has_head = self.head_params is not None

        def fuse(emb):
            return fusion.fuse_topk_from_emb(
                emb, state.proto, state.valid, self.head_params, active,
                pw, 1.0 - pw, kk, has_head,
                pallas_min_classes=self.config.pallas_knn_min_classes,
                proto_bias=proto_bias,
                fused_min_classes=self.config.fused_topk_min_classes)

        return self._predict_rows(texts, fuse, kk, k, chunk_override=batch_size)

    def _predict_rows(self, texts: List[str],
                      fuse: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                      kk: int, k: int,
                      chunk_override: Optional[int] = None) -> Predictions:
        """Shared predict pipeline.  Chunks are padded to the batch buckets
        {1, 8, 64, chunk} so the device sees few shapes; each chunk's
        ``[pad, 2·kk]`` block of scores and ids stays on the device until one
        copy to the host at the end, and no step in between waits for the
        device, so the host tokenizes chunk N+1 while the device runs N."""
        CH = max(chunk_override, 1) if chunk_override else max(
            self.config.embed_chunk_size, 64)

        def bucket(n):
            return 1 if n == 1 else 8 if n <= 8 else 64 if n <= 64 else CH

        packed, spans = [], []
        with torch.inference_mode():
            for s in range(0, len(texts), CH):
                part = texts[s:s + CH]
                ids, mask, lex = self._tokenize_chunk(part, bucket(len(part)))
                emb = self._compose_channels(self.encoder.embed_ids(ids, mask), lex)
                scores, idx = fuse(emb)
                packed.append(torch.cat([scores, idx.float()], dim=1))
                spans.append((len(part), scores.shape[0]))
            host = torch.cat(packed, dim=0).cpu().numpy()
        keep = np.zeros(host.shape[0], bool)
        off = 0
        for n, pad in spans:
            keep[off:off + n] = True
            off += pad
        host = host[keep]
        id2l = self.id_to_label
        return [
            [(id2l[i], s) for s, i in zip(srow, irow) if i >= 0 and i in id2l][:k]
            for srow, irow in zip(host[:, :kk].tolist(),
                                  host[:, kk:].astype(np.int64).tolist())
        ]

