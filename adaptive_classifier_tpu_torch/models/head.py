"""Classification head over padded class slots — inference, linear heads.

Counterpart of ``adaptive_classifier_tpu/models/head.py`` for the linear
(``head_type: ridge``) head.  Weights are stored ``[in, out]`` for
``x @ W``, the output layer padded to the class capacity; columns beyond the
saved class count are zero and masked off by the caller.  MLP heads and all
training come with later slices.
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

