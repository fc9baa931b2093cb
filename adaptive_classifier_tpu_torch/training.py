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

- ``fit_head``: the gradient fit of MLP heads and of the frozen probe
  after a lossy load: shuffled batches of 32, a hand-rolled AdamW, global
  norm clipping, the plateau schedule and early stopping, with an EWC
  penalty, logit distillation and a gradient mask as options.  The JAX
  package runs the whole loop as one device program; here the batches run
  from Python and the epoch's mean loss comes to the host once an epoch,
  for the stopping rule.  The shuffles and dropout masks come from
  ``_epoch_permutation`` and ``head._keep_mask``, which a test can replace
  with the JAX package's own draws.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .lexical import _fold_machinery
from .models import head as head_lib
from .models.head import NEG_INF, HeadParams

BATCH_SIZE = 32


# ---------------------------------------------------------------------------
# parameter trees: the leaf order of jax.tree.leaves (dict keys sorted)
# ---------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW, clipping, losses
# ---------------------------------------------------------------------------

class AdamW(NamedTuple):
    m: Any
    v: Any
    step: int


def adamw_init(params) -> AdamW:
    return AdamW(m=tree_map(torch.zeros_like, params),
                 v=tree_map(torch.zeros_like, params), step=0)


def adamw_update(params, grads, opt: AdamW, lr: float, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One AdamW step with the decay inside the step, as the JAX package
    writes it: ``p - lr·(m̂ / (sqrt(v̂) + eps) + wd·p)``.  The bias
    corrections are float32 scalars."""
    step = opt.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt.v, grads)
    new = tree_map(
        lambda p, m_, v_: p - lr * (m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
                                    + weight_decay * p), params, m, v)
    return new, AdamW(m=m, v=v, step=step)


def clip_global_norm(grads, max_norm: float = 1.0):
    """Scale every gradient by ``min(1, max_norm / ‖g‖)`` (global norm),
    on the device."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[None, :], logits, torch.full_like(logits, NEG_INF))


def _ce_loss(logits, y, vmask, active) -> torch.Tensor:
    """Cross-entropy over active class slots; mean over valid rows."""
    logp = torch.log_softmax(_masked(logits, active), dim=-1)
    nll = -torch.gather(logp, 1, torch.clamp(y.to(torch.int64), min=0)[:, None])[:, 0]
    return torch.sum(nll * vmask) / torch.clamp(torch.sum(vmask), min=1.0)


def _bce_loss(logits, y_multihot, vmask, active) -> torch.Tensor:
    """Sigmoid BCE over active class slots; mean over valid rows × active
    columns."""
    p = torch.clamp(torch.sigmoid(logits), 1e-7, 1 - 1e-7)
    bce = -(y_multihot * torch.log(p) + (1 - y_multihot) * torch.log(1 - p))
    elems = bce * active[None, :].to(torch.float32) * vmask[:, None]
    denom = torch.clamp(torch.sum(vmask) * torch.sum(active.to(torch.float32)), min=1.0)
    return torch.sum(elems) / denom


def _distill_loss(logits, old_logits, vmask, old_active, T: float) -> torch.Tensor:
    """Logit distillation over the old classes:
    ``KL(softmax(old/T) ‖ softmax(new/T))·T²``, mean over valid rows."""
    lp_new = torch.log_softmax(_masked(logits / T, old_active), dim=-1)
    p_old = torch.softmax(_masked(old_logits / T, old_active), dim=-1)
    kl = torch.where(old_active[None, :],
                     p_old * (torch.log(torch.clamp(p_old, 1e-9, 1.0)) - lp_new),
                     torch.zeros((), device=logits.device)).sum(dim=-1)
    return torch.sum(kl * vmask) * (T * T) / torch.clamp(torch.sum(vmask), min=1.0)


def ewc_penalty(params, ewc_old, ewc_fisher, ewc_lambda: float, batch_n) -> torch.Tensor:
    """``λ·Σ F·(θ−θ_old)² / batch_n``."""
    sq = sum(torch.sum(f * (p - o) ** 2) for f, p, o in
             zip(tree_leaves(ewc_fisher), tree_leaves(params), tree_leaves(ewc_old)))
    return ewc_lambda * sq / torch.clamp(batch_n, min=1.0)


# ---------------------------------------------------------------------------
# the gradient fit
# ---------------------------------------------------------------------------

class TrainResult(NamedTuple):
    params: Any
    final_loss: float
    epochs_run: int


def _epoch_permutation(generator: torch.Generator, valid: torch.Tensor) -> torch.Tensor:
    """One epoch's shuffle: valid rows first, each block in a uniform
    random order (the JAX package's ``argsort(where(valid, u, 2 + u))``)."""
    u = torch.rand(valid.shape, generator=generator, device=generator.device)
    return torch.argsort(torch.where(valid, u, 2.0 + u), stable=True)


def _batch_rows(perm: torch.Tensor, b: int) -> torch.Tensor:
    """Batch ``b``'s rows of ``perm``; a slice past the end starts earlier,
    as ``lax.dynamic_slice`` clamps it."""
    start = max(min(b * BATCH_SIZE, perm.shape[0] - BATCH_SIZE), 0)
    return perm[start:start + BATCH_SIZE]


def fit_head(
    params: HeadParams,
    emb: torch.Tensor,            # [N_cap, D] float32
    labels: torch.Tensor,         # [N_cap] int (ce) or [N_cap, C_cap] float (bce)
    valid: torch.Tensor,          # [N_cap] bool: real rows
    active: torch.Tensor,         # [C_cap] bool: active class slots
    generator: torch.Generator,
    lr: float = 1e-3,
    loss_type: str = "ce",
    max_epochs: int = 10,
    patience: int = 3,
    use_scheduler: bool = True,
    ewc_old=None, ewc_fisher=None, ewc_lambda: float = 0.0,
    distill_logits: Optional[torch.Tensor] = None,   # [N_cap, C_cap] old head, eval mode
    distill_active: Optional[torch.Tensor] = None,   # [C_cap] bool: old class slots
    distill_lambda: float = 0.0, distill_temperature: float = 2.0,
    grad_mask=None,               # params-shaped 0/1 floats; 0 freezes a weight
) -> TrainResult:
    """The multi-epoch gradient fit.  Each epoch shuffles the valid rows to
    the front and runs ⌈n_real/32⌉ batches; per batch one train-mode
    forward (one dropout draw) feeds the loss and the distillation term,
    the gradient is masked, clipped to norm 1 and taken by AdamW, and
    frozen entries are copied back unchanged.  After each epoch the mean
    batch loss drives the plateau schedule (factor 0.5, patience 2,
    relative threshold 1e-4) and early stopping (``patience``)."""
    N = emb.shape[0]
    vmask_f = valid.to(torch.float32)
    n_batches = max(math.ceil(int(valid.sum()) / BATCH_SIZE), 1)
    loss_fn = _ce_loss if loss_type == "ce" else _bce_loss
    params = tree_map(lambda p: p.detach().clone(), params)
    opt = adamw_init(params)
    best = sched_best = np.float32(np.inf)
    pc = sc = 0
    lr_scale = np.float32(1.0)
    last = np.float32(0.0)
    epoch = 0
    while epoch < max_epochs:
        perm = _epoch_permutation(generator, valid)
        loss_sum = torch.zeros((), device=emb.device)
        step_lr = float(np.float32(lr) * lr_scale)
        for b in range(n_batches):
            idx = _batch_rows(perm, b)
            x, y, v = emb[idx], labels[idx], vmask_f[idx]
            keep = [head_lib._keep_mask(generator, (x.shape[0], layer["w"].shape[1]))
                    for layer in params["hidden"]]
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                logits = head_lib.head_forward(params, x, train=True, keep=keep)
                loss = loss_fn(logits, y, v, active)
                if ewc_fisher is not None:
                    loss = loss + ewc_penalty(params, ewc_old, ewc_fisher, ewc_lambda,
                                              torch.sum(v))
                if distill_logits is not None:
                    loss = loss + distill_lambda * _distill_loss(
                        logits, distill_logits[idx], v, distill_active,
                        distill_temperature)
                grads = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
            by_leaf = {id(p): g for p, g in zip(leaves, grads)}
            grads = tree_map(lambda p: by_leaf[id(p)], params)
            if grad_mask is not None:
                grads = tree_map(lambda g, m: g * m, grads, grad_mask)
            grads = clip_global_norm(grads, 1.0)
            new, opt = adamw_update(params, grads, opt, step_lr)
            if grad_mask is not None:
                # weight decay moves zero-gradient weights too: frozen
                # entries are copied back, so they stay bit-identical
                new = tree_map(lambda n, p, m: torch.where(m > 0, n, p), new, params,
                               grad_mask)
            params = new
            loss_sum = loss_sum + loss.detach()
        # the one host read of the epoch
        avg = np.float32((loss_sum / np.float32(n_batches)).item())
        if use_scheduler:
            if avg < sched_best * np.float32(1 - 1e-4):
                sched_best, sc = avg, 0
            else:
                sc += 1
            if sc > 2:
                lr_scale, sc = lr_scale * np.float32(0.5), 0
        if avg < best:
            best, pc = avg, 0
        else:
            pc += 1
        last = avg
        epoch += 1
        if pc >= patience:
            break
    return TrainResult(params=params, final_loss=float(last), epochs_run=epoch)


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
