"""State of the JAX package → the port's state, numpy in and torch out.

- ``encoder_params_from_jax``: the stacked-layer encoder tree of any
  family (``embeddings/*``, ``layers/*`` with a leading layer axis, and
  ModernBERT's ``final_ln_scale``);
- ``encoder_int8_params_from_jax``: the runtime int8 tree of the JAX
  int8 forward (``layers/qkv_w.int8``, ``layers/qkv_w.scale``, …, stacked
  over layers) → the port's int8 state;
- ``head_params_from_jax``: head params (``hidden`` layers, ``out``,
  optional ``skip``);
- ``memory_state_from_jax``: the prototype memory's buffers.

Feeding the same state to both packages, or converting one package's state
to compare with the other's, is how the tests hold the port to the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .memory import MemoryState
from .models.encoder import _MATRICES, _VECTORS, Params, params_from_tree
from .models.head import HeadParams


def encoder_params_from_jax(params: Dict[str, Dict[str, Any]],
                            device: Union[str, torch.device] = "cpu",
                            matrix_dtype: torch.dtype = torch.float32) -> Params:
    """``{"embeddings": {...}, "layers": {...}}`` (ModernBERT: and
    ``"final_ln_scale"``) of numpy-convertible arrays (numpy or JAX
    arrays) → the port's encoder state dict on ``device``."""
    tree = {group: ({name: np.asarray(arr, np.float32) for name, arr in sub.items()}
                    if isinstance(sub, dict) else np.asarray(sub, np.float32))
            for group, sub in params.items()}
    return params_from_tree(tree, device=device, matrix_dtype=matrix_dtype)


def encoder_int8_params_from_jax(params: Dict[str, Dict[str, Any]],
                                 device: Union[str, torch.device] = "cpu") -> Params:
    """The JAX package's runtime int8 encoder tree (``embeddings/*``, and
    ``layers/{qkv_w,o_w,ffn_in_w,ffn_out_w}.{int8,scale}`` plus the float
    vectors, stacked over layers; numpy or JAX arrays) → the port's int8
    state on ``device``: row-major int8 matrices, float32 scales and
    everything else float32, values unchanged."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype, order="C")).to(device)

    lay = params["layers"]
    out: Params = {f"embeddings.{k}": t(v, np.float32)
                   for k, v in params["embeddings"].items()}
    for i in range(np.shape(lay["qkv_w.int8"])[0]):
        for name in _MATRICES:
            out[f"layers.{i}.{name}.int8"] = t(lay[f"{name}.int8"][i], np.int8)
            out[f"layers.{i}.{name}.scale"] = t(lay[f"{name}.scale"][i], np.float32)
        for name in _VECTORS:
            out[f"layers.{i}.{name}"] = t(lay[name][i], np.float32)
    return out


def _t(a, device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(device)


def head_params_from_jax(params: Dict[str, Any],
                         device: Union[str, torch.device] = "cpu") -> HeadParams:
    """JAX head params ``{"hidden": [{"w", "b"}, ...], "out": {"w", "b"},
    "skip"?}`` (numpy or JAX arrays) → the port's head params on
    ``device``, values unchanged."""
    def layer(d):
        return {k: _t(v, device) for k, v in d.items()}

    out: HeadParams = {"hidden": [layer(h) for h in params["hidden"]],
                       "out": layer(params["out"])}
    if "skip" in params:
        out["skip"] = layer(params["skip"])
    return out


def memory_state_from_jax(state: Any,
                          device: Union[str, torch.device] = "cpu") -> MemoryState:
    """A JAX ``MemoryState`` (``emb``, ``count``, ``proto``, ``pweight``) →
    the port's ``MemoryState`` on ``device``."""
    return MemoryState(emb=_t(state.emb, device), count=_t(state.count, device, np.int32),
                       proto=_t(state.proto, device), pweight=_t(state.pweight, device))
