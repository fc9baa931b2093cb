"""Checkpoint loading — the reference on-disk format.

Counterpart of ``load_classifier`` in ``adaptive_classifier_tpu/persistence.py``:
``config.json`` (label maps, train_steps, training_history, config),
``examples.json`` (representative examples per class), ``model.safetensors``
(``prototype_{label}`` vectors, ``adaptive_head_model.*`` tensors in torch
``[out, in]`` layout, optional ``proto_calibration_bias``) and, with the
lexical channel on, ``lexical.json``.  Prototypes and head load exactly, so
predictions match the classifier that was saved.

When the encoder's checkpoint is not on this machine but the checkpoint's
``quantized/`` export captured a pretrained encoder, the encoder is built
from the export (``Encoder.from_quantized_export``): as the int8 state when
the classifier's ``quantization`` resolves to int8, else as dequantized
float weights.  Saving comes with a later slice.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional, Union

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
            and (qdir / "model_int8.safetensors").exists()):
        cfg = ModelConfig(config_dict.get("config", None))
        encoder = Encoder.from_quantized_export(
            qdir, model_name, compute_dtype=cfg.compute_dtype, device=device,
            quantization=cfg.quantization)
        logger.info("Restored encoder weights from the int8 checkpoint export")
    clf = cls(model_name, device=device, config=config_dict.get("config", None),
              seed=config_dict.get("ac_seed", 42), encoder=encoder)
    if model_name == str(model_path / "encoder"):
        clf.model_name = config_dict["model_name"]
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

    if "proto_calibration_bias" in tensors:
        clf._proto_bias = np.asarray(tensors["proto_calibration_bias"], np.float32)

    # back-compat training-history estimate
    if not clf.training_history:
        for label, examples in saved_examples.items():
            clf.training_history[label] = len(examples) * 20

    return clf
