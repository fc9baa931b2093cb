"""Confidence calibration: temperature scaling of the fused probabilities.

Counterpart of ``adaptive_classifier_tpu/calibration.py``.  The
classifier's fused scores are a normalized mixture of two softmaxes, so the
temperature acts on log-probabilities: ``p_T ∝ p^(1/T)``, renormalized, zero
columns kept at zero.  ``T`` is the NLL minimizer on held-out labeled data
over a 64-point log grid on [0.05, 20], refined by a 33-point grid around
the winner at ``best · 10^[−0.12, 0.12]``; each grid is scored in one
vectorized pass on the device.

Usage::

    probs, labels = clf.predict_proba(texts)            # uncalibrated
    clf.calibrate(holdout_texts, holdout_labels)         # fits T
    probs, labels = clf.predict_proba(texts, calibrated=True)

``expected_calibration_error`` measures the gap before and after.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device

_EPS = 1e-12


def scale_probs(probs: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """``p^(1/T)`` renormalized along the last axis; zero columns stay
    zero.  ``temperature`` may be a tensor that broadcasts against
    ``probs``' leading axes (one temperature per grid point)."""
    p = probs.to(torch.float32)
    logp = torch.log(torch.clamp(p, min=_EPS)) / temperature
    logp = torch.where(p > 0, logp, torch.full_like(logp, -torch.inf))
    out = torch.softmax(logp, dim=-1)
    return torch.where(p > 0, out, torch.zeros_like(out))


def _nll_curve(probs: torch.Tensor, labels: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``scale_probs(probs, t)`` for every ``t`` of ``temps``:
    one ``[T, N, C]`` pass."""
    p = scale_probs(probs[None], temps[:, None, None])
    idx = labels[None, :, None].expand(temps.shape[0], -1, 1)
    row = torch.gather(p, 2, idx)[:, :, 0]
    return -torch.mean(torch.log(torch.clamp(row, min=_EPS)), dim=1)


def log_grid(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``10 ** linspace(start, stop, num)`` in float32, formed as
    ``jnp.logspace`` forms it (``start·(1−s) + stop·s`` at ``s = i/(num−1)``,
    the last point ``stop``, then the power).  XLA fuses these steps and
    rounds its float32 power its own way, so points differ from the JAX
    package's grid in the last bit (at most ~3e-7 relative)."""
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    lin = torch.cat([a * (1 - step) + b * step, b[None]])
    return torch.pow(torch.tensor(10.0, dtype=torch.float32, device=device), lin)


class TemperatureScaler:
    """Single-parameter probability-space temperature scaling, fitted and
    applied on ``device`` (the GPU unless the caller names another)."""

    def __init__(self, temperature: float = 1.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.temperature = float(temperature)
        self.device = resolve_device(device)
        #: index of the winner in the last grid ``fit`` scored
        self.grid_index: Optional[int] = None

    def fit(self, probs: np.ndarray, label_idx: np.ndarray,
            grid: Optional[Sequence[float]] = None) -> "TemperatureScaler":
        """The NLL-minimizing temperature on held-out data: the coarse
        grid, then the fine grid around its winner (``grid`` replaces both
        with one grid of the caller's)."""
        dev = self.device
        p = torch.as_tensor(np.asarray(probs, np.float32)).to(dev)
        y = torch.as_tensor(np.asarray(label_idx, np.int64)).to(dev)
        if grid is None:
            temps = log_grid(float(np.log10(np.float32(0.05))),
                             float(np.log10(np.float32(20.0))), 64, dev)
        else:
            temps = torch.tensor(list(grid), dtype=torch.float32, device=dev)
        i = int(torch.argmin(_nll_curve(p, y, temps)))
        best = temps[i]
        if grid is None:
            temps = best * log_grid(-0.12, 0.12, 33, dev)
            i = int(torch.argmin(_nll_curve(p, y, temps)))
            best = temps[i]
        self.grid_index = i
        self.temperature = float(best)
        return self

    def transform(self, probs: np.ndarray) -> np.ndarray:
        p = torch.as_tensor(np.asarray(probs, np.float32)).to(self.device)
        return scale_probs(p, self.temperature).cpu().numpy()


def expected_calibration_error(
    probs: np.ndarray,        # [N, C]
    label_idx: np.ndarray,    # [N] int
    n_bins: int = 15,
) -> float:
    """|accuracy − confidence| averaged over equal-width confidence bins,
    weighted by how many rows each bin holds."""
    probs = np.asarray(probs)
    label_idx = np.asarray(label_idx)
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == label_idx).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        if not in_bin.any():
            continue
        ece += in_bin.mean() * abs(correct[in_bin].mean() - conf[in_bin].mean())
    return float(ece)


def fit_classifier_temperature(classifier, texts: List[str], labels: List[str]
                               ) -> Tuple[TemperatureScaler, dict]:
    """A scaler fitted on held-out ``(texts, labels)`` through the
    classifier's own ``predict_proba``, on the classifier's device →
    ``(scaler, report)``: the temperature, NLL and ECE before and after."""
    probs, ordered = classifier.predict_proba(texts)
    l2i = {l: i for i, l in enumerate(ordered)}
    unknown = [l for l in labels if l not in l2i]
    if unknown:
        raise ValueError(f"labels not known to the classifier: {unknown[:5]}")
    idx = np.asarray([l2i[l] for l in labels], np.int32)

    scaler = TemperatureScaler(device=classifier.device).fit(probs, idx)
    after = scaler.transform(probs)

    def nll(p):
        rows = p[np.arange(len(idx)), idx]
        return float(-np.mean(np.log(np.maximum(rows, _EPS))))

    report = {
        "temperature": scaler.temperature,
        "nll_before": nll(probs),
        "nll_after": nll(after),
        "ece_before": expected_calibration_error(probs, idx),
        "ece_after": expected_calibration_error(after, idx),
        "n_holdout": len(texts),
    }
    return scaler, report
