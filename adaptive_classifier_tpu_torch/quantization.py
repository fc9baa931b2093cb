"""Int8 encoder weights: quantizing them, and loading a checkpoint's export.

Counterpart of ``quantize_weight`` and ``quantize_encoder_for_inference``
in ``adaptive_classifier_tpu/models/encoder_int8.py`` and of the load half
of ``adaptive_classifier_tpu/quantization.py``.

- ``quantize_weight``: per-output-channel symmetric int8 of a ``[in, out]``
  float32 matrix (scale ``max(absmax, 1e-8) / 127`` per column, round half
  to even, clip ±127).  From the same float32 weights it gives the JAX
  package's int8 values and scales bit for bit, so quantize the float32
  checkpoint, never the bf16 matrices the float path keeps.
- ``quantize_encoder_for_inference``: the port's float32 encoder state →
  its int8 state: every layer's four matrices as ``{name}.int8`` plus
  ``{name}.scale``, Q, K and V already fused into ``qkv_w`` (quantizing the
  concatenation is concatenating the per-matrix quantizations, the scales
  being per column); embeddings, biases and norms stay float32.
- ``load_quantized_encoder_params``: a ``quantized/`` export
  (``model_int8.safetensors`` + ``quantize_config.json``), in either of its
  two formats, as float weights or as the int8 state;
- ``save_quantized_encoder``: writes that export, in the ``standard``
  format (``quantize_tree`` of the float32 weights) from a float encoder,
  and as the ``runtime_int8_tree`` (the int8 state, stacked over layers)
  from an int8 one, with ``quantize_config.json`` and the tokenizer:
  ``vocab.txt`` for WordPiece, the checkpoint's ``tokenizer.json`` (and
  ``tokenizer_config.json``) for a ``tokenizer.json`` tokenizer (the JAX
  package writes a BPE vocabulary into ``vocab.txt``, which no loader reads
  as BPE).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from . import io_safetensors
from .convert import encoder_int8_params_from_jax
from .models.encoder import _MATRICES, _VECTORS, Params, Tree, params_from_tree

#: weights smaller than this stay float32 in a ``standard`` export
_MIN_QUANT_SIZE = 1024

def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w [in, out]`` float32 → (int8 ``[in, out]``, row-major as the
    kernels take it, float32 scale ``[out]``)."""
    w = w.float()
    absmax = w.abs().amax(dim=0).clamp_min(1e-8)
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def quantize_encoder_for_inference(params: Params) -> Params:
    """The port's float encoder state (matrices in float32) → its int8
    state, on the same device."""
    out: Params = {}
    for key, v in params.items():
        if key.startswith("layers.") and key.rsplit(".", 1)[1] in _MATRICES:
            if v.dtype != torch.float32:
                raise ValueError(f"{key} is {v.dtype}: quantize the float32 "
                                 f"weights, not a rounded copy")
            out[f"{key}.int8"], out[f"{key}.scale"] = quantize_weight(v)
        else:
            out[key] = v
    return out


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists → ``{"a/b/0": array}``."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """``{"a/b/0": x}`` → nested dicts, with all-digit keys as lists."""
    root: Dict[str, Any] = {}
    for name, value in flat.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def quantize_tree(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """A float32 tree → (tensors, manifest) of the ``standard`` export:
    every array of rank >= 2 and >= ``_MIN_QUANT_SIZE`` values becomes
    ``name.int8`` + ``name.scale``, symmetric per output channel (the
    absmax over axis ``ndim - 2``, the scale squeezed there); the rest
    stays float32."""
    tensors: Dict[str, np.ndarray] = {}
    manifest: Dict[str, List[str]] = {"quantized": [], "passthrough": []}
    for name, w in _flatten(tree).items():
        w = np.asarray(w, np.float32)
        if w.ndim >= 2 and w.size >= _MIN_QUANT_SIZE:
            axis = w.ndim - 2
            absmax = np.maximum(np.abs(w).max(axis=axis, keepdims=True), 1e-8)
            scale = (absmax / 127.0).astype(np.float32)
            tensors[f"{name}.int8"] = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            tensors[f"{name}.scale"] = np.squeeze(scale, axis=axis)
            manifest["quantized"].append(name)
        else:
            tensors[name] = w
            manifest["passthrough"].append(name)
    return tensors, manifest


def runtime_int8_tree(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's int8 state → the JAX package's runtime int8 tree:
    ``embeddings/*`` and ``layers/{qkv_w,o_w,ffn_in_w,ffn_out_w}.{int8,scale}``
    plus the float vectors, stacked over layers (numpy)."""
    def np_(t):
        return t.detach().cpu().numpy()

    n_layers = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("layers."))
    layers: Dict[str, np.ndarray] = {}
    for name in _MATRICES:
        for part in ("int8", "scale"):
            layers[f"{name}.{part}"] = np.stack(
                [np_(params[f"layers.{i}.{name}.{part}"]) for i in range(n_layers)])
    for name in _VECTORS:
        layers[name] = np.stack([np_(params[f"layers.{i}.{name}"]) for i in range(n_layers)])
    emb = {k.split(".", 1)[1]: np_(v) for k, v in params.items()
           if k.startswith("embeddings.")}
    return {"embeddings": emb, "layers": layers}


def save_quantized_encoder(encoder, directory: Union[str, Path]) -> Path:
    """Write ``model_int8.safetensors``, ``quantize_config.json`` and the
    tokenizer's files into ``directory``: the ``standard`` format from a float
    encoder (quantized from its float32 weights, ``Encoder.float_tree``),
    the ``runtime_int8_tree`` from an int8 one (its int8 state as it is;
    quantizing it again would corrupt it)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    runtime = encoder.quantization == "int8"
    if runtime:
        tensors = _flatten(runtime_int8_tree(encoder.params))
        manifest = {"quantized": sorted(n for n in tensors if ".int8" in n),
                    "passthrough": sorted(n for n in tensors if ".int8" not in n)}
    else:
        tensors, manifest = quantize_tree(encoder.float_tree())
    io_safetensors.save_file(tensors, directory / "model_int8.safetensors")
    (directory / "quantize_config.json").write_text(json.dumps({
        "scheme": "int8_symmetric_per_channel",
        "format": "runtime_int8_tree" if runtime else "standard",
        "encoder_config": encoder.config.__dict__,
        "encoder_pretrained": bool(encoder.pretrained),
        "manifest": manifest,
    }, indent=2))
    source = getattr(encoder.tokenizer, "source", None)
    vocab = getattr(encoder.tokenizer, "vocab", None)
    if source is not None:
        # a tokenizer.json tokenizer: the file itself (and its config)
        for src in (source, source.parent / "tokenizer_config.json"):
            if src.exists():
                shutil.copyfile(src, directory / src.name)
    elif vocab:
        tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
        (directory / "vocab.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return directory


def dequantize_tree(tensors: Dict[str, np.ndarray]) -> Tree:
    """A ``standard`` export (``name.int8`` + ``name.scale``, the scale
    squeezed at the weight's axis ``ndim - 2``) → float32 tree."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in tensors.items():
        if name.endswith(".int8"):
            base = name[: -len(".int8")]
            scale = tensors[f"{base}.scale"]
            flat[base] = value.astype(np.float32) * np.expand_dims(
                scale, axis=value.ndim - 2)
        elif name.endswith(".scale"):
            continue
        else:
            flat[name] = value
    return _unflatten(flat)


def dequantize_runtime_tree(params: Dict[str, Dict[str, Any]]) -> Tree:
    """Float tree from a runtime int8 tree; the fused ``qkv_w`` is split
    back into ``q_w``, ``k_w``, ``v_w`` (and ``qkv_b`` likewise)."""
    layers = dict(params["layers"])
    out: Dict[str, np.ndarray] = {}
    for name, v in layers.items():
        if name.endswith(".int8"):
            base = name[: -len(".int8")]
            s = layers[f"{base}.scale"]
            out[base] = np.asarray(v, np.float32) * np.asarray(s)[:, None, :]
        elif name.endswith(".scale"):
            continue
        else:
            out[name] = np.asarray(v)
    if "qkv_w" in out:
        w = out.pop("qkv_w")          # [L, D, 3D]
        b = out.pop("qkv_b")          # [L, 3D]
        D = w.shape[1]
        for i, nm in enumerate(("q", "k", "v")):
            out[f"{nm}_w"] = np.ascontiguousarray(w[:, :, i * D:(i + 1) * D])
            out[f"{nm}_b"] = np.ascontiguousarray(b[:, i * D:(i + 1) * D])
    return {"embeddings": {k: np.asarray(v) for k, v in params["embeddings"].items()},
            "layers": out}


def load_quantized_encoder_params(
    directory: Union[str, Path], want: str = "float",
) -> Tuple[Union[Tree, Params], Dict[str, Any], Dict[str, Any]]:
    """→ ``(params, encoder_config_dict, quantize_config)``.

    ``want="float"`` returns the float32 stacked-layer tree (numpy), from
    which the float path builds its state; ``want="int8"`` returns the
    port's int8 state (CPU tensors).  Whichever format the export stores,
    the other form is derived, as in the JAX package."""
    if want not in ("float", "int8"):
        raise ValueError(f"want={want!r}: 'float' or 'int8'")
    directory = Path(directory)
    tensors = io_safetensors.load_file(directory / "model_int8.safetensors")
    cfg = json.loads((directory / "quantize_config.json").read_text())
    if cfg.get("format", "standard") == "runtime_int8_tree":
        tree = _unflatten(tensors)
        params = (encoder_int8_params_from_jax(tree) if want == "int8"
                  else dequantize_runtime_tree(tree))
    else:
        params = dequantize_tree(tensors)
        if want == "int8":
            params = quantize_encoder_for_inference(params_from_tree(params))
    return params, cfg["encoder_config"], cfg
