"""Classification head over padded class slots — linear heads.

Counterpart of ``adaptive_classifier_tpu/models/head.py`` for the linear
(``head_type: ridge``) head.  Weights are stored ``[in, out]`` for
``x @ W``, the output layer padded to the class capacity; columns beyond the
class count are masked off by the caller.

``init_head`` and ``grow_capacity`` start linear heads at zero, where the
JAX package draws Xavier-uniform weights from ``jax.random``: the ridge fit
that follows every init or growth overwrites all of them, so the draw never
reaches a prediction.  MLP heads (hidden layers) and gradient training come
with a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

HeadParams = Dict[str, Any]


def head_forward(params: HeadParams, x: torch.Tensor) -> torch.Tensor:
    """Raw logits over all class slots ``[B, C_cap]``."""
    logits = x @ params["out"]["w"] + params["out"]["b"]
    if "skip" in params:
        # per-class linear probe on the raw embedding (incrementally added
        # classes after a lossy load)
        logits = logits + x @ params["skip"]["w"]
    return logits


def from_torch_state_dict(
    sd: Dict[str, np.ndarray], class_capacity: int,
    device: torch.device | str = "cpu",
) -> Tuple[HeadParams, List[int]]:
    """Load reference-format head tensors (``model.0.weight`` as a torch
    ``[out, in]`` matrix, ``skip.weight`` optional) into padded params.

    Returns (params, hidden_dims) with ``hidden_dims == []``."""
    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    indices = sorted({int(k.split(".")[1]) for k in sd
                      if k.endswith(".weight") and k.startswith("model.")})
    if len(indices) != 1:
        raise NotImplementedError(
            f"head with {len(indices) - 1} hidden layers: MLP heads come with "
            f"a later slice; the port loads linear (ridge) heads")
    last = indices[0]
    w = np.asarray(sd[f"model.{last}.weight"], np.float32).T    # [D_h, n]
    b = np.asarray(sd[f"model.{last}.bias"], np.float32)
    n = w.shape[1]
    cap = max(class_capacity, n)
    out_w = np.zeros((w.shape[0], cap), np.float32)
    out_w[:, :n] = w
    out_b = np.zeros((cap,), np.float32)
    out_b[:n] = b
    params: HeadParams = {"hidden": [], "out": {"w": t(out_w), "b": t(out_b)}}
    if "skip.weight" in sd:
        sw = np.asarray(sd["skip.weight"], np.float32).T         # [D_in, n]
        skip = np.zeros((sw.shape[0], cap), np.float32)
        skip[:, :n] = sw
        params["skip"] = {"w": t(skip)}
    return params, []



def _require_linear(hidden_dims):
    if hidden_dims:
        raise NotImplementedError(
            f"heads with hidden layers {list(hidden_dims)} (MLP heads) come "
            f"with a later slice; the port trains linear (ridge) heads")


def init_head(input_dim: int, class_capacity: int,
              hidden_dims=(), device: torch.device | str = "cpu") -> HeadParams:
    """A linear head ``[input_dim, class_capacity]`` at zero."""
    _require_linear(hidden_dims)
    return {"hidden": [],
            "out": {"w": torch.zeros((input_dim, class_capacity), device=device),
                    "b": torch.zeros((class_capacity,), device=device)}}


def grow_capacity(params: HeadParams, new_capacity: int) -> HeadParams:
    """Repad the output layer (and the ``skip`` probe) to ``new_capacity``
    columns; existing columns are kept, new ones start at zero."""
    _require_linear(params["hidden"])
    old = params["out"]["w"].shape[1]
    if new_capacity <= old:
        return params
    grow = new_capacity - old
    out = dict(params)
    out["out"] = {"w": torch.nn.functional.pad(params["out"]["w"], (0, grow)),
                  "b": torch.nn.functional.pad(params["out"]["b"], (0, grow))}
    if "skip" in params:
        out["skip"] = {"w": torch.nn.functional.pad(params["skip"]["w"], (0, grow))}
    return out
