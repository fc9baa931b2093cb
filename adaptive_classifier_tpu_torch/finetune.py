"""Supervised-contrastive fine-tuning of a classifier's encoder on its own
stored examples.

Counterpart of ``adaptive_classifier_tpu/finetune.py``.  Two
token-corruption views of each sentence (``pretrain.two_views``, BERT
masking at ``view_mask_prob``) are embedded with the pooling the
classifier uses at inference, and the SupCon "out" loss pulls same-label
embeddings together: for anchor ``i`` with positives ``P(i)`` (the other
rows of either view that share its label),

    L_i = -1/|P(i)| * sum_{p in P(i)} log( exp(s_ip/t) / sum_{a != i} exp(s_ia/t) )

and anchors without a positive in the batch count zero.  The multi-label
form takes pairs sharing at least one label as positives.  A chunk runs
``n_steps`` steps, each on ``batch`` rows drawn on the device from the
staged ``[N, S]`` corpus (``pretrain.run_chunk``: gradient, clip to
global norm 1, AdamW).  Each loss also takes pre-drawn views
(``supcon_loss_on_views``, ``supcon_loss_multihot_on_views``).

The forward is the plain torch path, in bf16 with f32 sums, whatever the
encoder's compute dtype, as the JAX package fine-tunes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import training
from .models.encoder import EncoderConfig, Params
from .pretrain import _mean_pool_embed, _train_forward, run_chunk, two_views


def _pooled_embed(params: Params, ids: torch.Tensor, attn: torch.Tensor,
                  cfg: EncoderConfig) -> torch.Tensor:
    """Normalized sentence embedding with the classifier's own pooling
    (``cfg.pooling``): training a different pooled vector than the one the
    memory and head read would train the wrong geometry."""
    if cfg.pooling == "mean":
        return _mean_pool_embed(params, ids, attn, cfg)
    e = _train_forward(params, ids, attn, cfg, torch.bfloat16)[:, 0, :].float()
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)


def _supcon(e: torch.Tensor, pos_same: torch.Tensor, temperature: float) -> torch.Tensor:
    """The SupCon loss of ``[2B, D]`` embeddings given the ``[2B, 2B]``
    same-label matrix (the diagonal is excluded here)."""
    n = e.shape[0]
    sims = (e @ e.t()) / temperature
    not_self = 1.0 - torch.eye(n, dtype=sims.dtype, device=sims.device)
    logits = torch.where(not_self > 0, sims, torch.full_like(sims, -1e9))
    logp = torch.log_softmax(logits, dim=1)
    pos = pos_same.to(sims.dtype) * not_self
    n_pos = pos.sum(dim=1)
    per_anchor = -(pos * logp).sum(dim=1) / torch.clamp(n_pos, min=1.0)
    has_pos = (n_pos > 0).to(sims.dtype)
    return (per_anchor * has_pos).sum() / torch.clamp(has_pos.sum(), min=1.0)


def _embed_views(params, v1, v2, attn, cfg) -> torch.Tensor:
    """``[2B, D]``: the two views' embeddings, rows of ``v1`` first, in one
    forward (each row's embedding is its own, so this is the JAX
    package's two forwards at half the launches)."""
    return _pooled_embed(params, torch.cat([v1, v2]), torch.cat([attn, attn]), cfg)


def supcon_loss_on_views(params: Params, v1: torch.Tensor, v2: torch.Tensor,
                         attn: torch.Tensor, labels: torch.Tensor, cfg: EncoderConfig,
                         temperature: float = 0.1) -> torch.Tensor:
    """Two-view SupCon over one batch, given its two masked views."""
    y = torch.cat([labels, labels])
    return _supcon(_embed_views(params, v1, v2, attn, cfg),
                   y[:, None] == y[None, :], temperature)


def supcon_loss(params: Params, ids: torch.Tensor, attn: torch.Tensor,
                labels: torch.Tensor, generator: torch.Generator, cfg: EncoderConfig,
                mask_id: int, temperature: float = 0.1,
                view_mask_prob: float = 0.08) -> torch.Tensor:
    """Two-view supervised-contrastive loss over one ``[B, S]`` batch."""
    v1, v2 = two_views(generator, ids, attn, mask_id, cfg.vocab_size, view_mask_prob)
    return supcon_loss_on_views(params, v1, v2, attn, labels, cfg, temperature)


def supcon_loss_multihot_on_views(params: Params, v1: torch.Tensor, v2: torch.Tensor,
                                  attn: torch.Tensor, y_multihot: torch.Tensor,
                                  cfg: EncoderConfig,
                                  temperature: float = 0.1) -> torch.Tensor:
    """Multi-label SupCon given the two views: positives are the pairs of
    ``[B, L]`` multi-hot rows sharing at least one label."""
    y = torch.cat([y_multihot, y_multihot]).float()
    return _supcon(_embed_views(params, v1, v2, attn, cfg), (y @ y.t()) > 0, temperature)


def supcon_loss_multihot(params: Params, ids: torch.Tensor, attn: torch.Tensor,
                         y_multihot: torch.Tensor, generator: torch.Generator,
                         cfg: EncoderConfig, mask_id: int, temperature: float = 0.1,
                         view_mask_prob: float = 0.08) -> torch.Tensor:
    """Multi-label SupCon: positives are pairs sharing at least one label,
    so a text stored under {a, b} is never its own negative."""
    v1, v2 = two_views(generator, ids, attn, mask_id, cfg.vocab_size, view_mask_prob)
    return supcon_loss_multihot_on_views(params, v1, v2, attn, y_multihot, cfg, temperature)


def supcon_chunk(params: Params, opt: training.AdamW, ids_all: torch.Tensor,
                 attn_all: torch.Tensor, labels_all: torch.Tensor,
                 generator: torch.Generator, cfg: EncoderConfig, mask_id: int,
                 batch: int, n_steps: int, lr: float = 3e-5, temperature: float = 0.1,
                 view_mask_prob: float = 0.08):
    """``n_steps`` SupCon steps on rows drawn from the staged corpus →
    ``(params, opt, mean loss)``."""
    return run_chunk(params, opt, ids_all.shape[0], batch, n_steps, generator, lr,
                     lambda p, idx: supcon_loss(p, ids_all[idx], attn_all[idx],
                                                labels_all[idx], generator, cfg, mask_id,
                                                temperature, view_mask_prob))


def supcon_chunk_multihot(params: Params, opt: training.AdamW, ids_all: torch.Tensor,
                          attn_all: torch.Tensor, y_all: torch.Tensor,
                          generator: torch.Generator, cfg: EncoderConfig, mask_id: int,
                          batch: int, n_steps: int, lr: float = 3e-5,
                          temperature: float = 0.1, view_mask_prob: float = 0.08):
    """The multi-label ``supcon_chunk``."""
    return run_chunk(params, opt, ids_all.shape[0], batch, n_steps, generator, lr,
                     lambda p, idx: supcon_loss_multihot(p, ids_all[idx], attn_all[idx],
                                                         y_all[idx], generator, cfg,
                                                         mask_id, temperature,
                                                         view_mask_prob))


def typo_augment(texts: Sequence[str], labels: Sequence, rng, copies: int = 1,
                 word_prob: float = 0.3) -> Tuple[List[str], List]:
    """Host-side character typos: in each word of 4 or more characters,
    with probability ``word_prob``, two adjacent inner characters swap.
    ``rng`` is a ``random.Random``; the same seed gives the JAX package's
    output exactly.  Labels are kept, so SupCon pulls a sentence and its
    corrupted twin together."""
    out_t, out_l = list(texts), list(labels)
    for _ in range(copies):
        for t, l in zip(texts, labels):
            words = t.split(" ")
            for i, w in enumerate(words):
                if len(w) >= 4 and rng.random() < word_prob:
                    j = rng.randrange(1, len(w) - 2)
                    words[i] = w[:j] + w[j + 1] + w[j] + w[j + 2:]
            out_t.append(" ".join(words))
            out_l.append(l)
    return out_t, out_l
