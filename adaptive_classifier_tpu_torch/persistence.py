"""Checkpoints in the reference on-disk format: saving and loading.

Counterpart of ``save_classifier``, ``load_classifier``, ``from_pretrained``
(a local directory only) and
``generate_model_card`` in ``adaptive_classifier_tpu/persistence.py``:
``config.json`` (label maps, train_steps, training_history, config, the
seed and the fitted fusion share),
``examples.json`` (``num_representative_examples`` k-means-selected
examples per class), ``model.safetensors`` (``prototype_{label}`` vectors,
``adaptive_head_model.*`` tensors in torch ``[out, in]`` layout, optional
``proto_calibration_bias``), with the lexical channel on ``lexical.json``,
a model card ``README.md``, a fine-tuned encoder's weights as an HF-layout
BERT checkpoint ``encoder/`` (``pretrain.save_hf_checkpoint``; a load
builds the encoder from it) and, unless left out, the int8 encoder export
``quantized/``.  A save is lossy by design (a few examples per class) but
prototypes and head round-trip exactly, so predictions match the
classifier that was saved; a checkpoint either package writes loads in
the other.

When the encoder's checkpoint is not on this machine but the checkpoint's
``quantized/`` export captured a pretrained encoder, the encoder is built
from the export (``Encoder.from_quantized_export``): as the int8 state when
the classifier's ``quantization`` resolves to int8, else as dequantized
float weights.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import io_safetensors
from .config import ModelConfig
from .models import head as head_lib
from .models.encoder import Encoder, _find_local_checkpoint

logger = logging.getLogger(__name__)


def _resolve_model_name(model_path: Path, model_name: str) -> str:
    """A checkpoint's encoder: its embedded fine-tuned ``encoder/`` dir if it
    has one, else ``model_name``, resolved against the checkpoint's ancestors
    when it is a relative path (the zoo names ``checkpoints/ac-base-v2``)."""
    embedded = model_path / "encoder"
    if (embedded / "config.json").exists():
        return str(embedded)
    if "/" in model_name and not Path(model_name).exists():
        for anc in [model_path, *list(model_path.parents)[:4]]:
            cand = anc / model_name
            if (cand / "config.json").exists():
                return str(cand)
    return model_name


def save_classifier(clf, save_directory: Union[str, Path],
                    include_quantized: bool = True) -> Dict[str, str]:
    """Write ``clf`` to ``save_directory`` → the files written, by role."""
    save_directory = Path(save_directory)
    os.makedirs(save_directory, exist_ok=True)
    config_dict: Dict[str, Any] = {
        "model_name": clf.model_name,
        "embedding_dim": clf.embedding_dim,
        "label_to_id": clf.label_to_id,
        "id_to_label": {str(k): v for k, v in clf.id_to_label.items()},
        "train_steps": clf.train_steps,
        "training_history": clf.training_history,
        "config": clf.config.to_full_dict(),
        # an offline encoder's weights derive from (seed, model_name): a
        # load with another seed would build another embedding space
        "ac_seed": clf.seed,
        "library_name": "adaptive-classifier",
    }
    if clf._fusion_alpha is not None:
        config_dict["ac_fusion_alpha"] = float(clf._fusion_alpha)

    saved_examples = {
        label: [ex.to_dict() for ex in clf.select_representative_examples(
            examples, k=clf.config.num_representative_examples)]
        for label, examples in clf.memory.examples.items()}

    tensors: Dict[str, np.ndarray] = {
        f"prototype_{label}": np.asarray(proto, np.float32)
        for label, proto in clf.memory.prototypes.items()}
    if clf.head_params is not None:
        sd = head_lib.to_torch_state_dict(clf.head_params, max(len(clf.label_to_id), 1))
        tensors.update({f"adaptive_head_{name}": t for name, t in sd.items()})
    if clf._proto_bias is not None:
        tensors["proto_calibration_bias"] = np.ascontiguousarray(clf._proto_bias, np.float32)
    if clf.lexical is not None and clf.lexical.fitted:
        clf.lexical.save(save_directory / "lexical.json")

    (save_directory / "config.json").write_text(
        json.dumps(config_dict, indent=2, sort_keys=True), encoding="utf-8")
    (save_directory / "examples.json").write_text(
        json.dumps(saved_examples, indent=2, sort_keys=True), encoding="utf-8")
    io_safetensors.save_file(tensors, save_directory / "model.safetensors")
    card = save_directory / "README.md"
    if not card.exists():
        card.write_text(generate_model_card(clf), encoding="utf-8")
    saved = {"config": "config.json", "examples": "examples.json",
             "model": "model.safetensors", "model_card": "README.md"}

    if clf.encoder._finetuned:
        # without its fine-tuned weights, a load would rebuild the base
        # encoder under prototypes and a head of the fine-tuned space
        from .pretrain import save_hf_checkpoint

        vocab = getattr(clf.encoder.tokenizer, "vocab", None)
        if clf.encoder.config.arch != "bert" or not vocab:
            raise ValueError(
                f"cannot persist the fine-tuned '{clf.encoder.config.arch}' encoder "
                f"(the HF export takes arch 'bert' with a WordPiece vocab); saving "
                f"without it would write a checkpoint whose prototypes and head "
                f"disagree with the encoder on load")
        tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
        save_hf_checkpoint(
            clf.encoder.float_tree(), clf.encoder.config, save_directory / "encoder",
            tokens, extra_config={"ac_finetuned_from": clf.model_name,
                                  "ac_pooling": clf.encoder.config.pooling,
                                  "ac_pool_layer": clf.encoder.config.pool_layer})
        saved["encoder"] = "encoder/"

    if include_quantized:
        if not clf.encoder.params:
            logger.warning("Skipping the quantized export: the encoder has no "
                           "params to export")
        else:
            from .quantization import save_quantized_encoder

            save_quantized_encoder(clf.encoder, save_directory / "quantized")
            saved["quantized"] = "quantized/"
    return saved


def generate_model_card(clf) -> str:
    """The checkpoint's ``README.md``."""
    stats = clf.get_memory_stats()
    total = sum(stats["examples_per_class"].values()) or 1
    dist = "\n".join(f"{label}: {count} examples ({count / total * 100:.1f}%)"
                     for label, count in sorted(stats["examples_per_class"].items()))
    return f"""---
language: multilingual
tags:
- adaptive-classifier
- text-classification
- continuous-learning
license: apache-2.0
---

# Adaptive Classifier

This model is an instance of an adaptive classifier supporting continuous
learning and dynamic class addition, saved by the PyTorch/CUDA build
`adaptive_classifier_tpu_torch`; the JAX build `adaptive_classifier_tpu`
loads it too.

## Model Details

- Base Model: {clf.model_name}
- Number of Classes: {stats['num_classes']}
- Total Examples: {stats['total_examples']}
- Embedding Dimension: {clf.embedding_dim}

## Class Distribution

```
{dist or "No examples stored"}
```

## Usage

```python
from adaptive_classifier_tpu_torch import AdaptiveClassifier

classifier = AdaptiveClassifier.load("path")
predictions = classifier.predict("Your text here")

classifier.add_examples(["Example 1", "Example 2"], ["class1", "class2"])
```

## Training Details

- Training Steps: {clf.train_steps}
- Prototype Memory: Active
- Neural Adaptation: {"Active" if clf.head_params is not None else "Inactive"}

## Limitations

This model:
- Requires at least {clf.config.min_examples_per_class} examples per class
- Has a maximum of {clf.config.max_examples_per_class} examples per class
"""


def load_classifier(cls, model_path: Union[str, Path],
                    device: Optional[Union[str, torch.device]] = None):
    model_path = Path(model_path)
    config_dict = json.loads((model_path / "config.json").read_text(encoding="utf-8"))
    examples_file = model_path / "examples.json"
    if examples_file.exists():
        saved_examples = json.loads(examples_file.read_text(encoding="utf-8"))
    else:
        # older layout: examples embedded in config.json
        saved_examples = config_dict.get("examples", {})

    model_name = _resolve_model_name(model_path, config_dict["model_name"])
    encoder = None
    qdir = model_path / "quantized"
    if (_find_local_checkpoint(model_name) is None
            and (qdir / "model_int8.safetensors").exists()
            and json.loads((qdir / "quantize_config.json").read_text())
            .get("encoder_pretrained", False)):
        # an export of the offline random-weight encoder is not used: the
        # model name rebuilds the same weights from the saved seed
        cfg = ModelConfig(config_dict.get("config", None))
        encoder = Encoder.from_quantized_export(
            qdir, model_name, compute_dtype=cfg.compute_dtype, device=device,
            quantization=cfg.quantization)
        logger.info("Restored encoder weights from the int8 checkpoint export")
    clf = cls(model_name, device=device, config=config_dict.get("config", None),
              seed=config_dict.get("ac_seed", 42), encoder=encoder)
    if model_name == str(model_path / "encoder"):
        # the base model's name stays the classifier's; the encoder is the
        # fine-tuned one, and a later save writes it again
        clf.model_name = config_dict["model_name"]
        clf.encoder._finetuned = True
    if "ac_fusion_alpha" in config_dict:
        clf._fusion_alpha = float(config_dict["ac_fusion_alpha"])
    lex_file = model_path / "lexical.json"
    if lex_file.exists() and clf.lexical is not None:
        from .lexical import HashedTfidf

        clf.lexical = HashedTfidf.load(lex_file)

    saved_dim = config_dict.get("embedding_dim")
    if saved_dim is not None and saved_dim != clf.embedding_dim:
        raise ValueError(
            f"Checkpoint at {model_path} was built with a {saved_dim}-dim "
            f"encoder ('{config_dict['model_name']}'), but the resolved "
            f"encoder produces {clf.embedding_dim}-dim embeddings")

    # label maps in id order so memory slots == label ids
    clf.label_to_id = dict(config_dict["label_to_id"])
    clf.id_to_label = {int(k): v for k, v in config_dict["id_to_label"].items()}
    for idx in sorted(clf.id_to_label):
        clf.memory.register_label(clf.id_to_label[idx])
    clf.train_steps = config_dict.get("train_steps", 0)
    clf.training_history = dict(config_dict.get("training_history", {}))

    tensors_path = model_path / "model.safetensors"
    if not tensors_path.exists() and (model_path / "tensors.safetensors").exists():
        tensors_path = model_path / "tensors.safetensors"   # legacy layout
    tensors = io_safetensors.load_file(tensors_path)

    # examples + the exact saved prototypes
    for label in clf.label_to_id:
        ex_data = saved_examples.get(label, [])
        texts = [d["text"] for d in ex_data]
        proto = tensors.get(f"prototype_{label}")
        if ex_data and ex_data[0].get("embedding") is not None:
            embs = np.asarray([d["embedding"] for d in ex_data], np.float32)
        else:
            embs = np.zeros((len(texts), clf.embedding_dim), np.float32)
        if texts or proto is not None:
            # the saved prototype aggregates every example the class trained
            # on; later adds update it as a running mean at that weight
            clf.memory.restore_class(
                label, texts, embs, prototype=proto,
                prototype_weight=clf.training_history.get(label, 0))

    head_sd = {k[len("adaptive_head_"):]: v for k, v in tensors.items()
               if k.startswith("adaptive_head_")}
    if head_sd:
        clf.head_params, _ = head_lib.from_torch_state_dict(
            head_sd, clf._class_capacity, device=clf.device)
        clf._ensure_head_capacity()

    if "proto_calibration_bias" in tensors:
        clf._proto_bias = np.asarray(tensors["proto_calibration_bias"], np.float32)

    # back-compat training-history estimate
    if not clf.training_history:
        for label, examples in saved_examples.items():
            clf.training_history[label] = len(examples) * 20

    return clf


def from_pretrained(cls, model_id: Union[str, Path],
                    device: Optional[Union[str, torch.device]] = None):
    """A checkpoint in a local directory (one holding ``config.json``).
    The JAX package also downloads a model id from the Hugging Face Hub;
    that is not ported, and nothing here reaches the network."""
    path = Path(model_id)
    if path.is_dir() and (path / "config.json").exists():
        return load_classifier(cls, path, device=device)
    raise ValueError(f"{model_id!r} is not a local checkpoint directory; loading "
                     f"from the Hugging Face Hub is not ported, download the "
                     f"checkpoint and pass its directory")
