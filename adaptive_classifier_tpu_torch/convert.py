"""Weights of the JAX package's encoder → the port's encoder state.

The JAX package keeps encoder parameters as a stacked-layer tree
(``embeddings/*``, and ``layers/*`` with a leading layer axis).  Feeding the
same tree to both packages is how the tests hold the port's forward to the
JAX forward on identical weights.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .models.encoder import Params, params_from_tree


def encoder_params_from_jax(params: Dict[str, Dict[str, Any]],
                            device: Union[str, torch.device] = "cpu",
                            matrix_dtype: torch.dtype = torch.float32) -> Params:
    """``{"embeddings": {...}, "layers": {...}}`` of numpy-convertible arrays
    (numpy or JAX arrays) → the port's encoder state dict on ``device``."""
    tree = {group: {name: np.asarray(arr, np.float32) for name, arr in sub.items()}
            for group, sub in params.items() if group in ("embeddings", "layers")}
    return params_from_tree(tree, device=device, matrix_dtype=matrix_dtype)
