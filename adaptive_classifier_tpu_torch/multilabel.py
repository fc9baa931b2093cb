"""Multi-label classification.

Counterpart of ``adaptive_classifier_tpu/multilabel.py``: a sigmoid head
trained with multi-hot BCE over the unique stored texts, an adaptive
threshold by label count, per-label thresholds by label frequency, a cap
on the labels returned and a below-threshold backfill up to
``min_predictions``, and encoder fine-tuning with multi-hot SupCon
(``finetune_encoder``).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import training
from .classifier import AdaptiveClassifier
from .models import head as head_lib
from .models.encoder import Encoder

logger = logging.getLogger(__name__)


class MultiLabelAdaptiveClassifier(AdaptiveClassifier):
    """Each text may carry several labels; ``predict_multilabel`` returns
    every label whose sigmoid clears its threshold."""

    def __init__(
        self,
        model_name: str,
        device: Optional[Union[str, torch.device]] = None,
        config: Optional[Dict[str, Any]] = None,
        seed: int = 42,
        default_threshold: float = 0.5,
        min_predictions: int = 1,
        max_predictions: Optional[int] = None,
        encoder: Optional[Encoder] = None,
    ):
        super().__init__(model_name, device, config, seed, encoder=encoder)
        self.default_threshold = default_threshold
        self.min_predictions = min_predictions
        self.max_predictions = max_predictions
        self.label_thresholds: Dict[str, float] = {}
        self.head_params = None

    def _get_adaptive_threshold(self, num_labels: int) -> float:
        """The threshold for a classifier of ``num_labels`` labels."""
        if num_labels <= 2:
            return self.default_threshold
        elif num_labels <= 5:
            return self.default_threshold * 0.8
        elif num_labels <= 10:
            return self.default_threshold * 0.6
        elif num_labels <= 20:
            return self.default_threshold * 0.4
        else:
            return self.default_threshold * 0.2

    def _head_sigmoid(self, emb: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            logits = head_lib.head_forward(self.head_params, emb)
            return torch.sigmoid(logits).cpu().numpy()

    def predict_multilabel(
        self,
        text: str,
        threshold: Optional[float] = None,
        max_labels: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """``(label, probability)`` of every label over its threshold (its
        per-label one, else ``threshold``, else the adaptive one), highest
        first, at most ``max_labels``; below ``min_predictions`` the best
        remaining labels are added whatever their probability."""
        if not text:
            raise ValueError("Empty input text")
        num_labels = len(self.label_to_id)
        if num_labels == 0:
            return []
        if threshold is None:
            threshold = self._get_adaptive_threshold(num_labels)
        max_labels = max_labels or self.max_predictions

        emb = self._embed_device([text])
        if self.head_params is not None:
            probs = self._head_sigmoid(emb)[0]
            predictions = []
            for i in range(num_labels):
                label = self.id_to_label[i]
                if probs[i] >= self.label_thresholds.get(label, threshold):
                    predictions.append((label, float(probs[i])))
            predictions.sort(key=lambda x: x[1], reverse=True)
            if max_labels and len(predictions) > max_labels:
                predictions = predictions[:max_labels]
        else:
            k = min(num_labels, max_labels) if max_labels else num_labels
            proto_preds = self.memory.get_nearest_prototypes(emb[0].cpu().numpy(), k=k)
            predictions = [(l, s) for l, s in proto_preds if s >= threshold]

        if len(predictions) < self.min_predictions and self.head_params is not None:
            probs = self._head_sigmoid(emb)[0]
            order = np.argsort(-probs[:num_labels])[:min(self.min_predictions, num_labels)]
            have = {l for l, _ in predictions}
            extra = []
            for i in order:
                label = self.id_to_label[int(i)]
                if label not in have:
                    extra.append((label, float(probs[int(i)])))
            predictions.extend(extra[:self.min_predictions - len(predictions)])
            predictions.sort(key=lambda x: x[1], reverse=True)

        return predictions

    def predict(self, text: str, k: int = 5) -> List[Tuple[str, float]]:
        """``predict_multilabel`` capped at ``k``; the single-label fusion
        when it returns nothing."""
        preds = self.predict_multilabel(text, max_labels=k)
        if preds:
            return preds[:k]
        return super().predict(text, k)

    def add_examples(self, texts: List[str], labels: List[List[str]]):
        """Store each ``(text, label)`` pair of the label lists, refit, and
        update the per-label thresholds.  A text with no labels is
        skipped."""
        if not texts or not labels:
            raise ValueError("Empty input lists")
        if len(texts) != len(labels):
            raise ValueError("Mismatched text and label lists")
        flattened_texts: List[str] = []
        flattened_labels: List[str] = []
        for text, text_labels in zip(texts, labels):
            for label in text_labels or ():
                flattened_texts.append(text)
                flattened_labels.append(label)
        if flattened_texts:
            super().add_examples(flattened_texts, flattened_labels)
        self._update_label_thresholds()

    def finetune_encoder(self, steps: int = 200, lr: float = 3e-5, batch: int = 32,
                         temperature: float = 0.1, view_mask_prob: float = 0.08,
                         chunk_steps: int = 50, augment: Optional[str] = None):
        """Multi-label encoder fine-tuning (``finetune.supcon_chunk_multihot``):
        over the unique stored texts with multi-hot label rows, so a text
        stored under {a, b} (two memory rows) is not its own negative;
        positives are pairs sharing at least one label.  A typo'd copy
        keeps its source's row."""
        import random

        from . import finetune as ft

        self._finetune_guard(steps)
        text_labels: Dict[str, set] = {}
        for lbl, ts in self.memory.texts.items():
            for t in ts:
                text_labels.setdefault(t, set()).add(lbl)
        if not text_labels:
            raise ValueError("no stored examples to fine-tune on")
        texts = list(text_labels)
        rows = np.zeros((len(texts), max(len(self.label_to_id), 1)), np.float32)
        for i, t in enumerate(texts):
            for lbl in text_labels[t]:
                rows[i, self.label_to_id[lbl]] = 1.0
        if augment == "typo":
            texts, idx = ft.typo_augment(texts, list(range(len(texts))),
                                         random.Random(self.seed))
            rows = rows[np.asarray(idx)]
        elif augment is not None:
            raise ValueError(f"unknown augment {augment!r} (use 'typo')")
        return self._finetune_run(ft.supcon_chunk_multihot, texts, rows, steps, lr,
                                  batch, temperature, view_mask_prob, chunk_steps)

    def _update_label_thresholds(self):
        """Per-label thresholds by the label's share of stored examples."""
        counts = {l: len(t) for l, t in self.memory.texts.items() if t}
        total = sum(counts.values())
        if not total:
            return
        for label, count in counts.items():
            freq = count / total
            if freq < 0.05:
                self.label_thresholds[label] = self.default_threshold * 0.3
            elif freq < 0.1:
                self.label_thresholds[label] = self.default_threshold * 0.5
            elif freq > 0.3:
                self.label_thresholds[label] = self.default_threshold * 1.2
            else:
                self.label_thresholds[label] = self.default_threshold
        logger.debug(f"Updated label thresholds: {self.label_thresholds}")

    def _train_adaptive_head(self, epochs: Optional[int] = None):
        """Multi-hot BCE fit over the unique stored texts (each text's row
        taken from its first stored occurrence), with a generator seeded
        from ``(seed, train_steps)``."""
        counts = {l: len(t) for l, t in self.memory.texts.items() if t}
        if not counts:
            return
        if self.head_params is None:
            self._initialize_adaptive_head()

        text_to_labels: Dict[str, set] = defaultdict(set)
        text_to_loc: Dict[str, Tuple[int, int]] = {}
        for label, slot in self.memory.label_to_index.items():
            for pos, text in enumerate(self.memory.texts.get(label, ())):
                text_to_labels[text].add(label)
                text_to_loc.setdefault(text, (slot, pos))

        uniq = list(text_to_labels.keys())
        n = len(uniq)
        if n == 0:
            return
        C = self._class_capacity
        n_cap = self.config.train_capacity(n)
        slots = np.zeros((n_cap,), np.int64)
        poss = np.zeros((n_cap,), np.int64)
        multihot = np.zeros((n_cap, C), np.float32)
        for i, text in enumerate(uniq):
            slots[i], poss[i] = text_to_loc[text]
            for label in text_to_labels[text]:
                multihot[i, self.label_to_id[label]] = 1.0
        dev = self.device
        emb = self.memory.state.emb[torch.from_numpy(slots).to(dev),
                                    torch.from_numpy(poss).to(dev)]
        valid = torch.arange(n_cap, device=dev) < n

        self.last_fit = training.fit_head(
            self.head_params, emb, torch.from_numpy(multihot).to(dev), valid,
            self._active_mask(), self._generator(self.train_steps),
            lr=self.config.learning_rate, loss_type="bce",
            max_epochs=epochs or self.config.epochs,
            patience=self.config.early_stopping_patience, use_scheduler=False)
        self.head_params = self.last_fit.params
        self.train_steps += 1

    def get_label_statistics(self) -> Dict[str, Any]:
        stats = super().get_example_statistics()
        stats["label_thresholds"] = dict(self.label_thresholds)
        stats["adaptive_threshold"] = self._get_adaptive_threshold(len(self.label_to_id))
        stats["default_threshold"] = self.default_threshold
        stats["min_predictions"] = self.min_predictions
        stats["max_predictions"] = self.max_predictions
        return stats
