"""Classification head over padded class slots: linear (ridge) and MLP heads.

Counterpart of ``adaptive_classifier_tpu/models/head.py``.  Weights are
stored ``[in, out]`` for ``x @ W``; the output layer is padded to the class
capacity and columns beyond the class count are masked off by the caller.
Hidden layers are Kaiming-uniform (bound ``sqrt(6 / fan_in)``), the output
layer Xavier-uniform sized by the logical class count, biases zero.  The
draws come from a ``torch.Generator`` where the JAX package threads a
``jax.random`` key, so the two packages draw different values from the same
bounds; a ridge head's draw never reaches a prediction, the closed-form fit
overwrites it.

Train mode applies inverted dropout at ``DROPOUT_RATE`` after every hidden
ReLU.  The keep masks come from ``_keep_mask`` (or are handed in), so a
test can give the port the JAX package's own draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

HeadParams = Dict[str, Any]

NEG_INF = -1e9
DROPOUT_RATE = 0.1


def _generator(generator: Optional[torch.Generator],
               device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """``generator``, or a fresh one seeded 0 on ``device``."""
    return generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * bound) - bound


def _kaiming_uniform(generator, fan_in: int, shape) -> torch.Tensor:
    # kaiming_uniform_(mode='fan_in', nonlinearity='relu'): sqrt(2)·sqrt(3/fan_in)
    return _uniform(generator, shape, float(np.sqrt(6.0 / fan_in)))


def _xavier_uniform(generator, fan_in: int, fan_out: int, shape) -> torch.Tensor:
    return _uniform(generator, shape, float(np.sqrt(6.0 / (fan_in + fan_out))))


def _keep_mask(generator: torch.Generator, shape) -> torch.Tensor:
    """One dropout draw: True where a unit is kept (probability 0.9)."""
    return torch.rand(shape, generator=generator, device=generator.device) \
        < (1.0 - DROPOUT_RATE)


def init_head(input_dim: int, class_capacity: int, num_classes: int = 1,
              hidden_dims: Optional[Sequence[int]] = None,
              generator: Optional[torch.Generator] = None,
              device: Union[str, torch.device] = "cpu") -> HeadParams:
    """A head ``input_dim → hidden_dims → class_capacity`` on the
    generator's device (``hidden_dims=None`` is one hidden layer of
    ``input_dim``, ``[]`` a linear head).  The output layer's Xavier bound
    uses the logical class count ``num_classes``."""
    g = _generator(generator, device)
    if hidden_dims is None:
        hidden_dims = [input_dim]
    hidden = []
    prev = input_dim
    for dim in hidden_dims:
        hidden.append({"w": _kaiming_uniform(g, prev, (prev, dim)),
                       "b": torch.zeros((dim,), device=g.device)})
        prev = dim
    out_w = _xavier_uniform(g, prev, max(num_classes, 1), (prev, class_capacity))
    return {"hidden": hidden,
            "out": {"w": out_w, "b": torch.zeros((class_capacity,), device=g.device)}}


def head_forward(params: HeadParams, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Raw logits over all class slots ``[B, C_cap]``.  In train mode each
    hidden layer's output goes through inverted dropout: with the masks
    ``keep`` (one per hidden layer) when given, else drawn from
    ``generator``; with neither, train mode is eval mode, as in the JAX
    package without a dropout key."""
    h = x
    for i, layer in enumerate(params["hidden"]):
        h = torch.clamp_min(h @ layer["w"] + layer["b"], 0.0)
        if train and (keep is not None or generator is not None):
            k = keep[i] if keep is not None else _keep_mask(generator, h.shape)
            h = torch.where(k, h / (1.0 - DROPOUT_RATE), torch.zeros((), device=h.device))
    logits = h @ params["out"]["w"] + params["out"]["b"]
    if "skip" in params:
        # per-class linear probe on the raw embedding, trained only for the
        # classes added after a lossy load (zero elsewhere)
        logits = logits + x @ params["skip"]["w"]
    return logits


def masked_probs(logits: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Softmax over active class slots; inactive slots get probability 0."""
    masked = torch.where(active[None, :], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(masked, dim=-1)
    return torch.where(active[None, :], probs, torch.zeros_like(probs))


def grow_capacity(params: HeadParams, new_capacity: int,
                  generator: Optional[torch.Generator] = None,
                  num_classes: int = 1) -> HeadParams:
    """Cross a class-capacity bucket: repad the output layer.  Existing
    columns are copied; new columns are fresh Xavier draws; the ``skip``
    probe is padded with zeros."""
    out = params["out"]
    fan_in, old_cap = out["w"].shape
    if new_capacity <= old_cap:
        return params
    g = _generator(generator, out["w"].device)
    new_w = _xavier_uniform(g, fan_in, max(num_classes, 1), (fan_in, new_capacity))
    new_w[:, :old_cap] = out["w"]
    new_b = torch.zeros((new_capacity,), device=out["b"].device)
    new_b[:old_cap] = out["b"]
    grown = {**params, "out": {"w": new_w, "b": new_b}}
    if "skip" in params:
        grown["skip"] = {"w": torch.nn.functional.pad(params["skip"]["w"],
                                                      (0, new_capacity - old_cap))}
    return grown


def ensure_skip(params: HeadParams, input_dim: int) -> HeadParams:
    """Add a zero skip-probe block if absent (zero: the function is unchanged)."""
    if "skip" in params:
        return params
    w = params["out"]["w"]
    return {**params, "skip": {"w": torch.zeros((input_dim, w.shape[1]), device=w.device)}}


class AdaptiveHead(torch.nn.Module):
    """Module facade over the functional head, for standalone use: ``forward``
    returns logits over the logical classes; ``update_num_classes`` grows
    the output layer, keeping the trained columns.  Draws come from a
    generator seeded with ``seed`` on ``device`` (the GPU unless the caller
    names another)."""

    def __init__(self, input_dim: int, num_classes: int,
                 hidden_dims: Optional[Sequence[int]] = None, seed: int = 42,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        from .._device import resolve_device

        self.input_dim = input_dim
        self.num_classes = num_classes
        self.hidden_dims = list(hidden_dims) if hidden_dims is not None else [input_dim]
        self.seed = seed
        self.device = resolve_device(device)
        self.params = init_head(input_dim, num_classes, num_classes,
                                hidden_dims=self.hidden_dims,
                                generator=self._seeded_generator())

    def _seeded_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _rows(self, x) -> torch.Tensor:
        x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        return x.reshape(-1, x.shape[-1])

    def forward(self, x) -> torch.Tensor:
        return head_forward(self.params, self._rows(x))[:, :self.num_classes]

    def update_num_classes(self, num_classes: int):
        if num_classes > self.num_classes:
            self.params = grow_capacity(self.params, num_classes,
                                        self._seeded_generator(), num_classes)
            self.num_classes = num_classes


class MultiLabelAdaptiveHead(AdaptiveHead):
    """Sigmoid outputs, one hidden layer of ``input_dim // 2`` by default."""

    def __init__(self, input_dim: int, num_classes: int,
                 hidden_dims: Optional[Sequence[int]] = None, seed: int = 42,
                 device: Optional[Union[str, torch.device]] = None):
        if hidden_dims is None:
            hidden_dims = [input_dim // 2]
        super().__init__(input_dim, num_classes, hidden_dims, seed, device)

    def forward(self, x) -> torch.Tensor:
        return torch.sigmoid(super().forward(x))


# ---------------------------------------------------------------------------
# (de)serialization: the reference's torch nn.Sequential names
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def to_torch_state_dict(params: HeadParams, num_classes: int) -> Dict[str, np.ndarray]:
    """``model.{0,3,...}.weight`` as torch ``[out, in]`` matrices, the output
    layer trimmed to the class count; ``skip.weight`` only when nonzero, so
    a checkpoint that never took the lossy-replay path keeps the reference
    layout."""
    sd: Dict[str, np.ndarray] = {}
    idx = 0
    for layer in params["hidden"]:
        sd[f"model.{idx}.weight"] = np.ascontiguousarray(_np(layer["w"]).T)
        sd[f"model.{idx}.bias"] = _np(layer["b"]).copy()
        idx += 3  # Linear, ReLU, Dropout
    sd[f"model.{idx}.weight"] = np.ascontiguousarray(_np(params["out"]["w"]).T[:num_classes])
    sd[f"model.{idx}.bias"] = _np(params["out"]["b"])[:num_classes].copy()
    if "skip" in params:
        skip = _np(params["skip"]["w"]).T[:num_classes]
        if np.any(skip):
            sd["skip.weight"] = np.ascontiguousarray(skip)
    return sd


def from_torch_state_dict(
    sd: Dict[str, np.ndarray], class_capacity: int,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[HeadParams, List[int]]:
    """Reference-format head tensors (``model.{i}.weight`` as torch
    ``[out, in]`` matrices, the last one the output layer; ``skip.weight``
    optional) → padded params and the hidden widths.  Output columns
    beyond the saved class count are zero."""
    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    indices = sorted({int(k.split(".")[1]) for k in sd
                      if k.endswith(".weight") and k.startswith("model.")})
    hidden, hidden_dims = [], []
    for i in indices[:-1]:
        w = np.asarray(sd[f"model.{i}.weight"], np.float32).T
        hidden.append({"w": t(w), "b": t(sd[f"model.{i}.bias"])})
        hidden_dims.append(w.shape[1])
    last = indices[-1]
    w = np.asarray(sd[f"model.{last}.weight"], np.float32).T    # [D_h, n]
    b = np.asarray(sd[f"model.{last}.bias"], np.float32)
    n = w.shape[1]
    cap = max(class_capacity, n)
    out_w = np.zeros((w.shape[0], cap), np.float32)
    out_w[:, :n] = w
    out_b = np.zeros((cap,), np.float32)
    out_b[:n] = b
    params: HeadParams = {"hidden": hidden, "out": {"w": t(out_w), "b": t(out_b)}}
    if "skip.weight" in sd:
        sw = np.asarray(sd["skip.weight"], np.float32).T         # [D_in, n]
        skip = np.zeros((sw.shape[0], cap), np.float32)
        skip[:, :n] = sw
        params["skip"] = {"w": t(skip)}
    return params, hidden_dims
