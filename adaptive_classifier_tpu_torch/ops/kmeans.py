"""K-means for the representative examples a checkpoint keeps.

Counterpart of ``adaptive_classifier_tpu/ops/kmeans.py`` (plain ``jnp``
there, no Pallas kernel): k-means++ seeding over the valid rows, Lloyd
iterations, the best of ``n_init`` restarts by inertia, and per centroid
the nearest valid row.  The restarts run side by side as one batch.  The
draws come from a ``torch.Generator``, so the selection is reproducible
for a seed but not the JAX package's bit pattern.
"""

from __future__ import annotations

import torch


def _sq_dists(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """``‖x − c‖²`` expanded as ``|x|² − 2x·c + |c|²``: ``[R, N, k]``."""
    return ((x * x).sum(1)[None, :, None] - 2.0 * torch.einsum("nd,rkd->rnk", x, cents)
            + (cents * cents).sum(2)[:, None, :])


def _plusplus_init(generator: torch.Generator, x: torch.Tensor, valid: torch.Tensor,
                   k: int, restarts: int) -> torch.Tensor:
    """k-means++ seeding over valid rows, one seeding per restart: ``[R, k, D]``."""
    vf = valid.to(torch.float32)
    uniform = (vf / torch.clamp(vf.sum(), min=1.0)).expand(restarts, -1)
    idx = torch.multinomial(uniform, 1, generator=generator)[:, 0]
    cents = torch.zeros((restarts, k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[:, 0] = x[idx]
    d2 = ((x[None, :, :] - x[idx][:, None, :]) ** 2).sum(-1)         # [R, N]
    for i in range(1, k):
        p = torch.where(valid[None, :], d2, torch.zeros_like(d2))
        total = p.sum(1, keepdim=True)
        p = torch.where(total > 0, p / torch.clamp(total, min=1e-12), uniform)
        idx = torch.multinomial(p, 1, generator=generator)[:, 0]
        c = x[idx]
        cents[:, i] = c
        d2 = torch.minimum(d2, ((x[None, :, :] - c[:, None, :]) ** 2).sum(-1))
    return cents


def _lloyd(x: torch.Tensor, valid: torch.Tensor, cents: torch.Tensor, iters: int):
    """``iters`` Lloyd steps from ``cents [R, k, D]`` → (centroids, inertia [R])."""
    vmask = valid.to(torch.float32)
    k = cents.shape[1]
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(x, cents), dim=2)               # [R, N]
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) * vmask[None, :, None]
        sums = torch.einsum("rnk,nd->rkd", onehot, x)
        counts = onehot.sum(1)[:, :, None]
        cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents)
    inertia = (torch.amin(_sq_dists(x, cents), dim=2) * vmask[None, :]).sum(1)
    return cents, inertia


def kmeans_fit(x: torch.Tensor, valid: torch.Tensor, generator: torch.Generator,
               k: int, n_init: int = 10, iters: int = 50) -> torch.Tensor:
    """Best-of-``n_init`` k-means centroids ``[k, D]`` of the valid rows of
    ``x [N, D]``."""
    cents = _plusplus_init(generator, x, valid, k, n_init)
    cents, inertia = _lloyd(x, valid, cents, iters)
    return cents[torch.argmin(inertia)]


def representative_indices(x: torch.Tensor, valid: torch.Tensor,
                           generator: torch.Generator, k: int) -> torch.Tensor:
    """Indices ``[k]`` of the valid rows nearest to the k-means centroids."""
    cents = kmeans_fit(x, valid, generator, k)
    d = _sq_dists(x, cents[None])[0].T                                   # [k, N]
    d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
    return torch.argmin(d, dim=1)
