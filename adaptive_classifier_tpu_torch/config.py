"""Configuration and example containers.

Counterpart of ``adaptive_classifier_tpu/config.py``: the same public keys,
defaults and serialization, so a ``config.json`` written by either package
loads in the other.  Keys that only tune the JAX build (capacity buckets,
kernel thresholds) keep their names and defaults here; the port reads the
ones its slice uses and carries the rest through unchanged.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_capacity(n: int, buckets: List[int]) -> int:
    """Smallest bucket >= n (last bucket is rounded up in steps of itself)."""
    for b in buckets:
        if n <= b:
            return b
    step = buckets[-1]
    return _round_up(n, step)


@dataclass
class Example:
    """A single training example; ``embedding`` is a host float32 array."""

    text: str
    label: str
    embedding: Optional[np.ndarray] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "text": self.text,
            "label": self.label,
            "embedding": self.embedding.tolist() if self.embedding is not None else None,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Example":
        emb = data.get("embedding")
        return cls(
            text=data["text"],
            label=data["label"],
            embedding=np.asarray(emb, dtype=np.float32) if emb is not None else None,
        )


#: (key, default) of every setting, in serialization order.  The first block
#: is the reference-compatible set that :meth:`ModelConfig.to_dict` writes.
_REFERENCE_DEFAULTS = (
    ("max_length", 512),
    ("batch_size", 32),
    ("learning_rate", 0.001),
    ("warmup_steps", 0),
    ("max_examples_per_class", 1000),
    ("prototype_update_frequency", 100),
    ("similarity_threshold", 0.6),
    ("ewc_lambda", 100.0),
    ("num_representative_examples", 5),
    ("epochs", 10),
    ("early_stopping_patience", 3),
    ("min_examples_per_class", 3),
    ("prototype_weight", 0.7),
    ("neural_weight", 0.3),
    ("min_confidence", 0.1),
    ("device_map", "auto"),
    ("quantization", None),
    ("gradient_checkpointing", False),
    ("enable_strategic_mode", False),
    ("cost_function_type", "separable"),
    ("strategic_lambda", 0.1),
    ("cost_coefficients", {}),
    ("strategic_training_frequency", 10),
    ("strategic_blend_regular_weight", 0.6),
    ("strategic_blend_strategic_weight", 0.4),
    ("strategic_robust_proto_weight", 0.8),
    ("strategic_robust_head_weight", 0.2),
    ("strategic_prediction_proto_weight", 0.5),
    ("strategic_prediction_head_weight", 0.5),
)

#: settings beyond the reference set, written by :meth:`to_full_dict`
_EXTENDED_DEFAULTS = (
    ("compute_dtype", "bfloat16"),
    ("class_capacity_buckets", [8, 16, 32, 64, 128, 256]),
    ("example_capacity_buckets", [32, 128, 512, 1024, 2048]),
    ("example_capacity_slack", 256),
    ("train_size_buckets", [64, 256, 1024, 4096, 16384]),
    ("pallas_knn_min_classes", 512),
    ("fused_topk_min_classes", 16384),
    ("strategic_num_candidates", 50),
    ("strategic_ridge_rounds", 3),
    ("strategic_ridge_ext_weight", 0.5),
    ("head_typo_augment", False),
    ("head_typo_weight", 0.5),
    ("embedding_cache_size", 4096),
    ("incremental_ewc_lambda", 5.0),
    ("incremental_distill_lambda", 1.0),
    ("incremental_distill_temperature", 2.0),
    ("incremental_freeze_on_lossy_replay", True),
    ("prototype_recalibration", True),
    ("lexical_dim", 0),
    ("lexical_weight", "auto"),
    ("lexical_grams", "auto"),
    ("head_type", "mlp"),
    ("ridge_lambda", 1.0),
    ("fusion_weights", "history"),
)

#: read but not serialized, as in the JAX package
_UNSERIALIZED_DEFAULTS = (
    ("embed_chunk_size", 256),
)


class ModelConfig:
    """Configuration for the adaptive classifier.

    Attribute names and defaults match ``adaptive_classifier_tpu.ModelConfig``
    key for key.  Mutable defaults are copied per instance.
    """

    _REFERENCE_KEYS = tuple(k for k, _ in _REFERENCE_DEFAULTS)

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        for key, default in (_REFERENCE_DEFAULTS + _EXTENDED_DEFAULTS
                             + _UNSERIALIZED_DEFAULTS):
            if isinstance(default, (list, dict)):
                default = type(default)(default)
            setattr(self, key, self.config.get(key, default))

    def update(self, **kwargs):
        for key, value in kwargs.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                logger.warning(f"Unknown configuration parameter: {key}")

    def to_dict(self) -> Dict[str, Any]:
        """Reference-compatible serialization."""
        return {k: getattr(self, k) for k in self._REFERENCE_KEYS}

    def to_full_dict(self) -> Dict[str, Any]:
        """Serialization including the extended keys."""
        d = self.to_dict()
        d.update({k: getattr(self, k) for k, _ in _EXTENDED_DEFAULTS})
        return d

    # -- capacity helpers ------------------------------------------------
    def class_capacity(self, num_classes: int) -> int:
        return bucket_capacity(max(num_classes, 1), self.class_capacity_buckets)

    def example_capacity(self, max_count: int) -> int:
        cap_limit = self.max_examples_per_class + max(self.example_capacity_slack, 1)
        return min(bucket_capacity(max(max_count, 1), self.example_capacity_buckets), cap_limit)

    def train_capacity(self, n: int) -> int:
        return bucket_capacity(max(n, 1), self.train_size_buckets)
