"""Elastic Weight Consolidation: Fisher information of the old head.

Counterpart of ``adaptive_classifier_tpu/ewc.py``.  The Fisher estimate is
the mean over ⌈n/32⌉ batches of the squared gradient of the batch-mean
NLL, with labels sampled from the head's own eval-mode softmax.  The rows
are shuffled valid-first (``training._epoch_permutation``) and the labels
drawn by ``_sample_labels``; a test can hand the port the JAX package's
draws through either.  The quadratic penalty is ``training.ewc_penalty``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from . import training
from .models.head import head_forward
from .training import BATCH_SIZE, tree_leaves, tree_map


class EWCBundle(NamedTuple):
    """Old parameters, their Fisher information, and the strength."""
    old_params: Any
    fisher: Any
    ewc_lambda: float


def _sample_labels(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One label per row from ``softmax(logits)``."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def compute_fisher(params, emb: torch.Tensor, valid: torch.Tensor,
                   active: torch.Tensor, generator: torch.Generator):
    """Fisher = mean over batches of (batch-mean NLL gradient)², labels
    sampled from the model's own eval-mode distribution over ``active``."""
    vmask_f = valid.to(torch.float32)
    n_batches = max(math.ceil(int(valid.sum()) / BATCH_SIZE), 1)
    perm = training._epoch_permutation(generator, valid)
    params = tree_map(lambda p: p.detach(), params)
    leaves = tree_leaves(params)
    fisher = [torch.zeros_like(p) for p in leaves]
    for b in range(n_batches):
        idx = training._batch_rows(perm, b)
        x, v = emb[idx], vmask_f[idx]
        with torch.no_grad():
            sampled = _sample_labels(generator, training._masked(
                head_forward(params, x), active))
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            lg = training._masked(head_forward(params, x), active)
            logp = torch.log_softmax(lg, dim=-1)
            per = -torch.gather(logp, 1, sampled[:, None])[:, 0]
            nll = torch.sum(per * v) / torch.clamp(torch.sum(v), min=1.0)
            grads = torch.autograd.grad(nll, leaves)
        for p in leaves:
            p.requires_grad_(False)
        fisher = [f + g * g / float(n_batches) for f, g in zip(fisher, grads)]
    by_leaf = {id(p): f for p, f in zip(leaves, fisher)}
    return tree_map(lambda p: by_leaf[id(p)], params)


def make_ewc_bundle(old_params, emb, valid, active, generator,
                    ewc_lambda: float) -> EWCBundle:
    fisher = compute_fisher(old_params, emb, valid, active, generator)
    return EWCBundle(old_params=old_params, fisher=fisher, ewc_lambda=ewc_lambda)


class EWC:
    """Object facade: ``EWC(params, embeddings, ...)`` snapshots the
    parameters and their Fisher information; ``ewc_loss(current_params,
    batch_size)`` is ``λ·Σ F·(θ−θ_old)² / batch_size``."""

    def __init__(self, params, embeddings, active=None, ewc_lambda: float = 100.0,
                 generator: Optional[torch.Generator] = None):
        dev = params["out"]["w"].device
        emb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(dev)
        n = emb.shape[0]
        n_cap = max(BATCH_SIZE, math.ceil(n / BATCH_SIZE) * BATCH_SIZE)
        padded = torch.zeros((n_cap, emb.shape[1]), device=dev)
        padded[:n] = emb
        valid = torch.arange(n_cap, device=dev) < n
        if active is None:
            active = torch.ones((params["out"]["w"].shape[1],), dtype=torch.bool,
                                device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(42)
        self.ewc_lambda = ewc_lambda
        self.old_params = params
        self.fisher = compute_fisher(params, padded, valid,
                                     torch.as_tensor(active, device=dev), generator)

    def ewc_loss(self, current_params=None, batch_size: Optional[int] = None) -> torch.Tensor:
        params = current_params if current_params is not None else self.old_params
        dev = self.old_params["out"]["w"].device
        bn = torch.tensor(float(batch_size) if batch_size is not None else 1.0, device=dev)
        return training.ewc_penalty(params, self.old_params, self.fisher,
                                    self.ewc_lambda, bn)

    @property
    def bundle(self) -> EWCBundle:
        return EWCBundle(self.old_params, self.fisher, self.ewc_lambda)
