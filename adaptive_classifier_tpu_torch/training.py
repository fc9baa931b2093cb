"""Head fitting for linear (ridge) heads, fusion weights and the prototype
recalibration after new classes.

Counterpart of the parts of ``adaptive_classifier_tpu/training.py`` that
``add_examples`` on the production config runs:

- ``ridge_solve`` / ``ridge_head_params``: the closed-form multi-class ridge
  head, dual form when rows ≤ dims and primal otherwise, through a Cholesky
  solve in f32 (dense linear algebra, left to torch as the JAX package left
  it to XLA);
- ``select_ridge_lambda``: ``ridge_lambda="auto"`` by 2-fold CV balanced
  accuracy;
- ``fit_fusion_alpha``: ``fusion_weights="auto"``, the prototype/head share
  fitted on the same folds (host numpy, as in the JAX package);
- ``fit_new_class_penalty``: the per-new-class similarity penalty fitted by
  exact evaluation of the argmax rule.  The JAX package evaluates its
  41-point grid with one ``vmap`` (a ``[G, N, C]`` tensor); here the grid
  runs in chunks sized so that no chunk's ``[g, N, C]`` block passes
  ``max_block`` elements (44 GB at N = C = 16,384 for the whole grid).

Gradient training (MLP heads, EWC) comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .lexical import _fold_machinery
from .models.head import HeadParams


# ---------------------------------------------------------------------------
# closed-form ridge head
# ---------------------------------------------------------------------------

def _spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(A)
    z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, z, upper=True)


def ridge_solve(
    emb: torch.Tensor,            # [N_cap, D] float32 (invalid rows arbitrary)
    labels: torch.Tensor,         # [N_cap] int
    valid: torch.Tensor,          # [N_cap] bool
    class_capacity: int,
    lam: float = 1.0,
    sample_weight: Optional[torch.Tensor] = None,   # [N_cap] >= 0
) -> torch.Tensor:
    """``argmin_W Σ_valid wᵢ‖xᵢW − yᵢ‖² + λ‖W‖²`` with one-hot targets →
    ``W [D, C_cap]``.  Invalid rows are zeroed in features and targets, so
    they are exact no-ops.  Dual form (``K = FFᵀ``) when rows ≤ dims,
    primal (``G = FᵀF``) otherwise; in the primal form ``FᵀY`` is a
    per-class sum of rows, so no ``[N, C]`` one-hot matrix is built."""
    F = torch.where(valid[:, None], emb.to(torch.float32), torch.zeros((), device=emb.device))
    s = valid.to(torch.float32)
    if sample_weight is not None:
        s = s * torch.sqrt(torch.clamp(sample_weight.to(torch.float32), min=0.0))
        F = F * s[:, None]
    lab = torch.clamp(labels.to(torch.int64), min=0)
    N, D = F.shape
    if N <= D:
        Y = torch.zeros((N, class_capacity), device=F.device)
        Y[torch.arange(N, device=F.device), lab] = s
        K = F @ F.T
        A = _spd_solve(K + lam * torch.eye(N, device=F.device), Y)
        return F.T @ A
    G = F.T @ F
    FtY = torch.zeros((D, class_capacity), device=F.device).index_add_(
        1, lab, (F * s[:, None]).T)
    return _spd_solve(G + lam * torch.eye(D, device=F.device), FtY)


def ridge_head_params(emb, labels, valid, class_capacity: int, lam: float = 1.0,
                      keep_from: Optional[HeadParams] = None,
                      sample_weight=None) -> HeadParams:
    """``ridge_solve`` as linear head params (zero bias, as the intercept-free
    probe); ``keep_from`` carries a ``skip`` probe block over."""
    W = ridge_solve(emb, labels, valid, class_capacity, lam,
                    sample_weight=sample_weight)
    params: HeadParams = {"hidden": [], "out": {
        "w": W, "b": torch.zeros((class_capacity,), device=W.device)}}
    if keep_from is not None and "skip" in keep_from:
        params["skip"] = keep_from["skip"]
    return params


#: λ grid for ridge_lambda="auto" (ties prefer 1.0)
RIDGE_LAMBDA_GRID = (0.1, 0.3, 1.0, 3.0)


def _balanced_acc(pred: np.ndarray, y: np.ndarray) -> float:
    accs = [float((pred[y == c] == c).mean()) for c in np.unique(y)]
    return float(np.mean(accs)) if accs else 0.0


def select_ridge_lambda(
    emb: torch.Tensor,            # [N_cap, D] (valid rows front-sorted)
    labels: torch.Tensor,         # [N_cap]
    valid: torch.Tensor,          # [N_cap] bool
    class_capacity: int,
    grid: Sequence[float] = RIDGE_LAMBDA_GRID,
) -> Tuple[float, dict]:
    """Resolve ``ridge_lambda="auto"`` by 2-fold CV balanced accuracy of the
    ridge-head rule on the training rows (the per-class alternating split of
    the lexical probe).  Ties prefer the λ nearest 1.0."""
    n = int(valid.sum())
    y = labels[:n].cpu().numpy()
    if n < 8 or len(np.unique(y)) < 2:
        return 1.0, {"note": "too few rows to sweep; reference default"}
    e = emb[:n].to(torch.float32)
    dev = e.device
    half_a, half_b, _ = _fold_machinery(y)
    cap = max(int(half_a.sum()), int(half_b.sum()))
    cap = ((cap + 255) // 256) * 256   # one shape for both folds
    accs = []
    for lam in grid:
        sc = []
        for fit_m, val_m in ((half_a, half_b), (half_b, half_a)):
            nf = int(fit_m.sum())
            if nf == 0 or not val_m.any():
                continue
            fit_t = torch.from_numpy(np.flatnonzero(fit_m)).to(dev)
            fe = torch.zeros((cap, e.shape[1]), device=dev)
            fy = torch.zeros((cap,), dtype=torch.int64, device=dev)
            fe[:nf] = e[fit_t]
            fy[:nf] = torch.from_numpy(y[fit_m]).to(dev)
            W = ridge_solve(fe, fy, torch.arange(cap, device=dev) < nf,
                            class_capacity, float(lam))
            val_t = torch.from_numpy(np.flatnonzero(val_m)).to(dev)
            pred = torch.argmax(e[val_t] @ W, dim=1).cpu().numpy()
            sc.append(_balanced_acc(pred, y[val_m]))
        accs.append(float(np.mean(sc)) if sc else 0.0)
    order = sorted(range(len(grid)), key=lambda i: abs(np.log(grid[i] / 1.0)))
    best = order[0]
    for i in order:
        if accs[i] > accs[best] + 1e-9:
            best = i
    return float(grid[best]), {
        "grid": [float(g) for g in grid],
        "val_acc": [round(a, 4) for a in accs],
        "chosen": float(grid[best]),
    }


# ---------------------------------------------------------------------------
# fold-fitted fusion weights
# ---------------------------------------------------------------------------

#: prototype-share grid for fusion_weights="auto" (0.0 = head only, 0.7 =
#: the reference's fixed weighting, 1.0 = prototypes only)
FUSION_ALPHA_GRID = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _fold_fusion_accs(
    fit_emb: np.ndarray, fit_lbl: np.ndarray,
    val_emb: np.ndarray, val_lbl: np.ndarray,
    val_logits: np.ndarray,                 # [Nv, >= n_classes] head logits
    n_classes: int, alphas: Sequence[float],
) -> np.ndarray:
    """Balanced accuracy per α of both served decision rules on one fold —
    the full per-label fusion and the ``predict_batch(k=1)`` rule —
    averaged.  Prototypes are fit-fold class means only."""
    D = fit_emb.shape[1]
    protos = np.zeros((n_classes, D), np.float32)
    pvalid = np.zeros((n_classes,), bool)
    for c in np.unique(fit_lbl):
        protos[c] = fit_emb[fit_lbl == c].mean(axis=0)
        pvalid[c] = True
    d2 = np.maximum(
        (val_emb * val_emb).sum(1, keepdims=True)
        + (protos * protos).sum(1)[None, :]
        - 2.0 * val_emb @ protos.T, 0.0)
    sims = np.where(pvalid[None, :], np.exp(-d2), 0.0)
    plogits = np.where(pvalid[None, :], sims, -1e9)
    proto_full = np.exp(plogits - plogits.max(1, keepdims=True))
    proto_full /= proto_full.sum(1, keepdims=True)
    hl = val_logits[:, :n_classes].astype(np.float64)
    head_probs = np.exp(hl - hl.max(1, keepdims=True))
    head_probs /= head_probs.sum(1, keepdims=True)

    pnn = plogits.argmax(1)
    ha = head_probs.argmax(1)
    hp = head_probs.max(1)
    out = np.zeros(len(alphas))
    for i, a in enumerate(alphas):
        full_pred = (a * proto_full + (1.0 - a) * head_probs).argmax(1)
        # predict_batch(k=1): α at the nearest prototype, (1−α)·p at the head's top-1
        topk_pred = np.where(pnn == ha, pnn, np.where(a >= (1.0 - a) * hp, pnn, ha))
        out[i] = 0.5 * (_balanced_acc(full_pred, val_lbl)
                        + _balanced_acc(topk_pred, val_lbl))
    return out


def fit_fusion_alpha(
    emb: np.ndarray,            # [N, D] real training rows (host)
    labels: np.ndarray,         # [N] int class ids
    n_classes: int,
    head_fold_fit: Callable,    # (fit_emb, fit_lbl, val_emb) → val logits
    alphas: Sequence[float] = FUSION_ALPHA_GRID,
    prefer: float = 0.7,
) -> Tuple[float, dict]:
    """Fit the prototype/head fusion share on the alternating per-class
    2-fold split → ``(alpha, report)``; ties prefer the α nearest 0.7."""
    half_a, half_b, _ = _fold_machinery(labels)
    accs = np.zeros(len(alphas))
    folds = 0
    for fit_m, val_m in ((half_a, half_b), (half_b, half_a)):
        if not fit_m.any() or not val_m.any():
            continue
        val_logits = np.asarray(
            head_fold_fit(emb[fit_m], labels[fit_m], emb[val_m]), np.float32)
        accs += _fold_fusion_accs(emb[fit_m], labels[fit_m],
                                  emb[val_m], labels[val_m],
                                  val_logits, n_classes, alphas)
        folds += 1
    if folds == 0:
        return float(prefer), {"alphas": list(alphas), "val_acc": None}
    accs /= folds
    order = sorted(range(len(alphas)), key=lambda i: abs(alphas[i] - prefer))
    best = order[0]
    for i in order:
        if accs[i] > accs[best] + 1e-9:
            best = i
    return float(alphas[best]), {
        "alphas": [float(a) for a in alphas],
        "val_acc": [float(a) for a in accs],
        "chosen": float(alphas[best]),
        "probe_val_acc": float(accs[list(alphas).index(0.0)])
        if 0.0 in alphas else None,
    }


# ---------------------------------------------------------------------------
# prototype recalibration after incremental class addition
# ---------------------------------------------------------------------------

def penalty_grid(device: torch.device | str = "cpu") -> torch.Tensor:
    """0 then 40 log-spaced penalties from 1e-3 to 0.5, float32."""
    return torch.cat([torch.zeros(1), torch.from_numpy(
        np.geomspace(1e-3, 0.5, 40).astype(np.float32))]).to(device)


def fit_new_class_penalty(
    sims: torch.Tensor,          # [N, C] masked exp(−d²) similarities
    labels: torch.Tensor,        # [N] int class ids
    vmask: torch.Tensor,         # [N] bool — real rows
    proto_valid: torch.Tensor,   # [C] bool
    new_ids,                     # sequence of int — the just-added class ids
    grid: Optional[torch.Tensor] = None,
    refine_rounds: int = 2,
    max_block: int = 1 << 26,
) -> torch.Tensor:
    """Per-class penalty on the new classes' similarities, applied before
    top-k selection, that maximizes class-balanced top-1 accuracy of the
    argmax rule on the val half of a per-class fit/val split, under the
    constraint that no new class loses val recall against zero penalty.  A
    shared penalty over the grid first, then ``refine_rounds`` rounds of
    per-class coordinate refinement.  Zero penalty wins ties.

    → ``bias [C]`` (≤ 0 on new classes, 0 elsewhere)."""
    N, C = sims.shape
    dev = sims.device
    grid = penalty_grid(dev) if grid is None else grid.to(dev, torch.float32)

    # per-class alternating fit/val split; single-row classes keep their row
    # in both halves
    lab_np = labels.cpu().numpy()
    vm_np = vmask.cpu().numpy()
    idx_in_class = np.zeros((N,), np.int64)
    seen: dict = {}
    for i in range(N):
        if not vm_np[i]:
            continue
        c = int(lab_np[i])
        idx_in_class[i] = seen.get(c, 0)
        seen[c] = idx_in_class[i] + 1
    single = np.asarray([seen.get(int(c), 0) <= 1 for c in lab_np])
    val_mask = torch.from_numpy(vm_np & ((idx_in_class % 2 == 1) | single)).to(dev)

    lab = labels.to(dev, torch.int64)
    new_ids = [int(i) for i in new_ids]
    new_sel = torch.zeros((C,), dtype=torch.bool, device=dev)
    new_sel[torch.tensor(new_ids, device=dev)] = True
    counts_val = torch.zeros((C,), device=dev).index_add_(0, lab, val_mask.to(torch.float32))
    present_val = counts_val > 0
    n_present = torch.clamp(present_val.to(torch.float32).sum(), min=1.0)
    base = torch.where(proto_valid[None, :], sims, torch.full_like(sims, float("-inf")))
    chunk = max(1, max_block // max(N * C, 1))

    def per_class_acc(bias: torch.Tensor) -> torch.Tensor:     # [g, C] → [g, C]
        pred = torch.argmax(base[None, :, :] + bias[:, None, :], dim=2)
        hit = ((pred == lab[None, :]) & val_mask[None, :]).to(torch.float32)
        corr = torch.zeros((bias.shape[0], C), device=dev).index_add_(1, lab, hit)
        return corr / torch.clamp(counts_val, min=1.0)

    base_acc = per_class_acc(torch.zeros((1, C), device=dev))[0]

    def best_of(variants: torch.Tensor) -> int:              # [G, C] → argmax
        scores = []
        for s in range(0, variants.shape[0], chunk):
            acc = per_class_acc(variants[s:s + chunk])
            bal = torch.where(present_val[None, :], acc,
                              torch.zeros_like(acc)).sum(1) / n_present
            ok = torch.where((new_sel & present_val)[None, :], acc >= base_acc[None, :],
                             torch.ones_like(acc, dtype=torch.bool)).all(1)
            scores.append(torch.where(ok, bal, torch.full_like(bal, -1.0)))
        return int(torch.argmax(torch.cat(scores)))

    onehots = torch.zeros((len(new_ids), C), device=dev)
    onehots[torch.arange(len(new_ids), device=dev), torch.tensor(new_ids, device=dev)] = 1.0
    shared = onehots.sum(0)

    best = best_of(-grid[:, None] * shared[None, :])
    bias = -float(grid[best]) * shared
    for _ in range(refine_rounds):
        for j in range(len(new_ids)):
            others = bias * (1.0 - onehots[j])
            best = best_of(others[None, :] - grid[:, None] * onehots[j][None, :])
            bias = others - float(grid[best]) * onehots[j]
    return torch.where(proto_valid, bias, torch.zeros_like(bias))
