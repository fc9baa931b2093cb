"""Masked-language-model and contrastive pretraining of BERT encoders, and
their HF-layout checkpoints.

Counterpart of ``adaptive_classifier_tpu/pretrain.py``:

- ``apply_mlm_masking``: BERT's recipe (15% of the non-special real tokens
  selected; of those 80% become ``[MASK]``, 10% a random id, 10% stay);
- ``MLMParams`` / ``init_mlm``: the transform head (dense, GELU,
  LayerNorm) and the decoder tied to the word embeddings, drawn with
  numpy's ``default_rng(seed + 7)`` as the JAX package draws it;
- ``mlm_logits``, ``mlm_loss`` and ``mlm_loss_sparse`` (logits only at up to
  ``n_pred`` positions a row, the selected ones first);
- ``train_step``, ``train_step_sampled`` and ``train_chunk``: a loss, its
  gradient, clipping to global norm 1 and AdamW with linear warmup then
  cosine decay;
- ``_mean_pool_embed``, ``contrastive_loss`` and ``contrastive_chunk``: the
  unsupervised two-view InfoNCE phase;
- ``to_hf_state_dict`` and ``save_hf_checkpoint``: the stacked tree to HF
  BERT tensor names, written as ``config.json``, ``model.safetensors``
  (through ``io_safetensors``), ``vocab.txt`` and ``tokenizer_config.json``,
  which ``Encoder(path)`` in either package loads.

The JAX package runs a chunk of steps as one XLA program; here each step
runs eagerly, the step's losses staying on the device until the chunk's
mean is read.  The forward is the plain torch path (``attn_impl="einsum"``,
``use_fused_ln=False``), as the JAX package trains on its plain ``jnp``
path: the CUDA kernels have no backward.  Parameters are the port's flat
state dict (``models.encoder.params_from_tree``) in float32; each product
takes bf16 operands with f32 sums, as JAX's forward does.  JAX's
``remat=True`` only trades compute for activation memory and has no
counterpart here.

Random draws come from a ``torch.Generator``: each step's batch rows
(``_batch_rows``), the masking's uniforms and random ids
(``_masking_draws``) and the sparse loss's ranking uniforms
(``_rank_draws``) are module functions, so a test can hand the port the
JAX package's draws.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import io_safetensors, training
from ._device import resolve_device
from .models.encoder import (
    EncoderConfig,
    Params,
    Tree,
    encoder_forward,
    pool_and_normalize,
)
from .ops.layernorm import add_layer_norm_ref


class MLMParams(NamedTuple):
    """BERT's ``cls.predictions`` head: dense → GELU → LayerNorm → decoder
    tied to the word-embedding matrix, plus a free bias."""

    dense_w: torch.Tensor   # [D, D]
    dense_b: torch.Tensor   # [D]
    ln_scale: torch.Tensor  # [D]
    ln_bias: torch.Tensor   # [D]
    dec_bias: torch.Tensor  # [V]


def init_mlm(seed: int, cfg: EncoderConfig,
             device: Optional[Union[str, torch.device]] = None) -> MLMParams:
    """The JAX package's ``init_mlm`` bit for bit, on ``device`` (the GPU
    unless another is named)."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed + 7)
    D = cfg.hidden_size
    return MLMParams(
        dense_w=torch.from_numpy(r.standard_normal((D, D), np.float32) * 0.02).to(dev),
        dense_b=torch.zeros(D, device=dev),
        ln_scale=torch.ones(D, device=dev),
        ln_bias=torch.zeros(D, device=dev),
        dec_bias=torch.zeros(cfg.vocab_size, device=dev),
    )


# ---------------------------------------------------------------------------
# random draws (module functions, so a test can replace them)
# ---------------------------------------------------------------------------

def _batch_rows(generator: torch.Generator, n_rows: int, batch: int) -> torch.Tensor:
    """A step's ``batch`` row indices into the staged corpus, with
    replacement (JAX ``randint``)."""
    return torch.randint(0, n_rows, (batch,), generator=generator, device=generator.device)


def _masking_draws(generator: torch.Generator, shape, special_max_id: int,
                   vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masking's draws: the selection uniforms, the operation uniforms
    and the random replacement ids in ``[special_max_id, vocab_size)``."""
    dev = generator.device
    return (torch.rand(shape, generator=generator, device=dev),
            torch.rand(shape, generator=generator, device=dev),
            torch.randint(special_max_id, vocab_size, shape, generator=generator, device=dev))


def _rank_draws(generator: torch.Generator, shape) -> torch.Tensor:
    """The sparse loss's uniforms that order the selected positions."""
    return torch.rand(shape, generator=generator, device=generator.device)


# ---------------------------------------------------------------------------
# masking and the MLM losses
# ---------------------------------------------------------------------------

def masking_from_draws(ids: torch.Tensor, attention_mask: torch.Tensor, mask_id: int,
                       draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                       special_max_id: int = 4, mask_prob: float = 0.15):
    """BERT masking of ``ids`` from pre-drawn ``(u_sel, u_op, rand_ids)`` →
    ``(masked_ids, target_ids, selected)``.  Ids below ``special_max_id``
    (``[PAD]``, ``[UNK]``, ``[CLS]``, ``[SEP]``) and pad positions are never
    selected."""
    u_sel, u_op, rand_ids = draws
    eligible = (attention_mask > 0) & (ids >= special_max_id)
    sel = (u_sel < mask_prob) & eligible
    masked = torch.where(sel & (u_op < 0.8), torch.full_like(ids, mask_id), ids)
    masked = torch.where(sel & (u_op >= 0.8) & (u_op < 0.9), rand_ids.to(ids.dtype), masked)
    return masked, ids, sel


def apply_mlm_masking(generator: torch.Generator, ids: torch.Tensor,
                      attention_mask: torch.Tensor, mask_id: int, vocab_size: int,
                      special_max_id: int = 4, mask_prob: float = 0.15):
    """BERT masking on the device, drawn from ``generator`` →
    ``(masked_ids, target_ids, selected)``."""
    draws = _masking_draws(generator, tuple(ids.shape), special_max_id, vocab_size)
    return masking_from_draws(ids, attention_mask, mask_id, draws,
                              special_max_id=special_max_id, mask_prob=mask_prob)


def _train_forward(params: Params, ids: torch.Tensor, attention_mask: torch.Tensor,
                   cfg: EncoderConfig, compute_dtype: torch.dtype) -> torch.Tensor:
    """The encoder forward a training step differentiates: plain torch
    attention and LayerNorm, no kernel."""
    return encoder_forward(params, ids, attention_mask, cfg, compute_dtype,
                           attn_impl="einsum", use_fused_ln=False)


def _mlm_head(h: torch.Tensor, params: Params, mlm: MLMParams,
              cfg: EncoderConfig) -> torch.Tensor:
    """Transform and tied decoder of f32 hidden states → f32 logits."""
    h = F.gelu(h @ mlm.dense_w + mlm.dense_b, approximate="none")
    h = add_layer_norm_ref(h, None, mlm.ln_scale, mlm.ln_bias, cfg.layer_norm_eps)
    return h @ params["embeddings.word"].float().t() + mlm.dec_bias


def mlm_logits(params: Params, mlm: MLMParams, ids: torch.Tensor,
               attention_mask: torch.Tensor, cfg: EncoderConfig,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``[B, S, V]`` float32: forward + transform + tied decoder."""
    hidden = _train_forward(params, ids, attention_mask, cfg, compute_dtype)
    return _mlm_head(hidden.float(), params, mlm, cfg)


def _masked_nll(logits: torch.Tensor, targets: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    n = torch.clamp(sel.sum().float(), min=1.0)
    return torch.where(sel, nll, torch.zeros_like(nll)).sum() / n


def mlm_loss(params: Params, mlm: MLMParams, ids: torch.Tensor,
             attention_mask: torch.Tensor, generator: torch.Generator,
             cfg: EncoderConfig, mask_id: int,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Mean negative log-likelihood of the selected tokens, dense logits."""
    masked, targets, sel = apply_mlm_masking(generator, ids, attention_mask, mask_id,
                                             cfg.vocab_size)
    logits = mlm_logits(params, mlm, masked, attention_mask, cfg, compute_dtype)
    return _masked_nll(logits, targets, sel)


def mlm_loss_sparse(params: Params, mlm: MLMParams, ids: torch.Tensor,
                    attention_mask: torch.Tensor, generator: torch.Generator,
                    cfg: EncoderConfig, mask_id: int, n_pred: int,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``mlm_loss`` with logits only at ``n_pred`` positions a row: the
    selected positions first (in the order of a uniform draw), then others,
    which the loss masks out; a row with more than ``n_pred`` selected keeps
    ``n_pred`` of them."""
    masked, targets, sel = apply_mlm_masking(generator, ids, attention_mask, mask_id,
                                             cfg.vocab_size)
    u = _rank_draws(generator, tuple(ids.shape))
    rank_key = torch.where(sel, u, 2.0 + u)
    pos = torch.topk(-rank_key, n_pred, dim=1).indices            # [B, n_pred]
    picked_sel = torch.gather(sel, 1, pos)
    picked_tgt = torch.gather(targets, 1, pos)
    hidden = _train_forward(params, masked, attention_mask, cfg, compute_dtype).float()
    h = torch.gather(hidden, 1, pos[..., None].expand(-1, -1, hidden.shape[-1]))
    return _masked_nll(_mlm_head(h, params, mlm, cfg), picked_tgt, picked_sel)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def scheduled_lr(step: int, lr_peak: float, warmup: int, total_steps: int) -> float:
    """The learning rate at optimizer step ``step`` (0-based), in float32 as
    the JAX package computes it: linear warmup to ``lr_peak`` over
    ``warmup`` steps, then cosine decay to 0 at ``total_steps``."""
    f32 = np.float32
    t = f32(step)
    if t < warmup:
        return float(f32(lr_peak) * (t + f32(1.0)) / f32(warmup))
    frac = min(f32((t - f32(warmup)) / f32(max(total_steps - warmup, 1))), f32(1.0))
    return float(f32(lr_peak) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac)))


def _update(params, opt: training.AdamW, loss_fn, lr: float):
    """One step of ``loss_fn(params)``: gradient, clip to global norm 1,
    AdamW at ``lr`` → ``(params, opt, loss)``."""
    loss, grads = training.value_and_grad(loss_fn, params)
    grads = training.clip_global_norm(grads, 1.0)
    with torch.no_grad():
        params, opt = training.adamw_update(params, grads, opt, lr)
    return params, opt, loss


def run_chunk(params, opt: training.AdamW, n_rows: int, batch: int, n_steps: int,
              generator: torch.Generator, lr, step_loss):
    """``n_steps`` steps of ``step_loss(params, idx)`` on ``batch`` rows
    drawn from ``n_rows`` (``_update``; ``lr`` a float, or a function of
    the optimizer's step count) → ``(params, opt, mean loss)``, the mean a
    device scalar.  The chunk of every objective here and in
    ``finetune.py``."""
    losses = []
    for _ in range(n_steps):
        idx = _batch_rows(generator, n_rows, batch)
        params, opt, loss = _update(params, opt, lambda p: step_loss(p, idx),
                                    lr(opt.step) if callable(lr) else lr)
        losses.append(loss)
    return params, opt, torch.stack(losses).mean()


def train_step(params: Params, mlm: MLMParams, opt: training.AdamW, ids: torch.Tensor,
               attention_mask: torch.Tensor, generator: torch.Generator,
               cfg: EncoderConfig, mask_id: int, lr_peak: float = 1e-3,
               warmup: int = 1000, total_steps: int = 100_000):
    """One dense-logit MLM step → ``(params, mlm, opt, loss)``.  ``opt``
    is ``training.adamw_init({"enc": params, "mlm": mlm})``."""
    bundle, opt, loss = _update(
        {"enc": params, "mlm": mlm}, opt,
        lambda b: mlm_loss(b["enc"], MLMParams(*b["mlm"]), ids, attention_mask, generator,
                           cfg, mask_id),
        scheduled_lr(opt.step, lr_peak, warmup, total_steps))
    return bundle["enc"], MLMParams(*bundle["mlm"]), opt, loss


def train_step_sampled(params: Params, mlm: MLMParams, opt: training.AdamW,
                       ids_all: torch.Tensor, attn_all: torch.Tensor,
                       generator: torch.Generator, cfg: EncoderConfig, mask_id: int,
                       batch: int, lr_peak: float = 1e-3, warmup: int = 1000,
                       total_steps: int = 100_000):
    """``train_step`` on ``batch`` rows drawn on the device from the staged
    corpus."""
    idx = _batch_rows(generator, ids_all.shape[0], batch)
    return train_step(params, mlm, opt, ids_all[idx], attn_all[idx], generator, cfg,
                      mask_id, lr_peak, warmup, total_steps)


def train_chunk(params: Params, mlm: MLMParams, opt: training.AdamW,
                ids_all: torch.Tensor, attn_all: torch.Tensor,
                generator: torch.Generator, cfg: EncoderConfig, mask_id: int,
                batch: int, n_steps: int, lr_peak: float = 1e-3, warmup: int = 1000,
                total_steps: int = 100_000):
    """``n_steps`` sparse-logit MLM steps, each on ``batch`` rows drawn from
    the staged ``[N, S]`` corpus → ``(params, mlm, opt, mean loss)``."""
    n_pred = max(int(ids_all.shape[1] * 0.20), 8)   # budget >= the 15% recipe
    bundle, opt, loss = run_chunk(
        {"enc": params, "mlm": mlm}, opt, ids_all.shape[0], batch, n_steps, generator,
        lambda step: scheduled_lr(step, lr_peak, warmup, total_steps),
        lambda b, idx: mlm_loss_sparse(b["enc"], MLMParams(*b["mlm"]), ids_all[idx],
                                       attn_all[idx], generator, cfg, mask_id, n_pred))
    return bundle["enc"], MLMParams(*bundle["mlm"]), opt, loss


# ---------------------------------------------------------------------------
# contrastive sentence-embedding phase (unsupervised, SimCSE family)
# ---------------------------------------------------------------------------

def _mean_pool_embed(params: Params, ids: torch.Tensor, attn: torch.Tensor,
                     cfg: EncoderConfig,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Masked-mean pooled, L2-normalized ``[B, D]`` f32 embedding of the
    training forward."""
    return pool_and_normalize(_train_forward(params, ids, attn, cfg, compute_dtype),
                              attn, "mean")


def two_views(generator: torch.Generator, ids: torch.Tensor, attn: torch.Tensor,
              mask_id: int, vocab_size: int, view_mask_prob: float):
    """Two independently masked copies of ``ids`` (the SimCSE views)."""
    return tuple(apply_mlm_masking(generator, ids, attn, mask_id, vocab_size,
                                   mask_prob=view_mask_prob)[0] for _ in range(2))


def contrastive_loss_on_views(params: Params, v1: torch.Tensor, v2: torch.Tensor,
                              attn: torch.Tensor, cfg: EncoderConfig,
                              temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE between two views with in-batch negatives, both directions.
    Both views go through one forward (each row's embedding is its own)."""
    e1, e2 = _mean_pool_embed(params, torch.cat([v1, v2]), torch.cat([attn, attn]),
                              cfg).chunk(2)
    sims = e1 @ e2.t() / temperature                    # [B, B]
    nll = -(torch.diagonal(torch.log_softmax(sims, dim=1))
            + torch.diagonal(torch.log_softmax(sims.t(), dim=1))) / 2.0
    return nll.mean()


def contrastive_loss(params: Params, ids: torch.Tensor, attn: torch.Tensor,
                     generator: torch.Generator, cfg: EncoderConfig, mask_id: int,
                     temperature: float = 0.05, view_mask_prob: float = 0.1) -> torch.Tensor:
    """Two token-corruption views of each sentence must embed closer to each
    other than to any other sentence of the batch."""
    v1, v2 = two_views(generator, ids, attn, mask_id, cfg.vocab_size, view_mask_prob)
    return contrastive_loss_on_views(params, v1, v2, attn, cfg, temperature)


def contrastive_chunk(params: Params, opt: training.AdamW, ids_all: torch.Tensor,
                      attn_all: torch.Tensor, generator: torch.Generator,
                      cfg: EncoderConfig, mask_id: int, batch: int, n_steps: int,
                      lr: float = 1e-4, view_mask_prob: float = 0.1):
    """``n_steps`` contrastive steps → ``(params, opt, mean loss)``."""
    return run_chunk(params, opt, ids_all.shape[0], batch, n_steps, generator, lr,
                     lambda p, idx: contrastive_loss(p, ids_all[idx], attn_all[idx],
                                                     generator, cfg, mask_id,
                                                     view_mask_prob=view_mask_prob))


# ---------------------------------------------------------------------------
# HF-layout checkpoint export (the inverse of encoder._map_hf_weights)
# ---------------------------------------------------------------------------

_HF_LAYER_NAMES = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "o": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}


def to_hf_state_dict(tree: Tree, cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """Stacked-layer tree (``models.encoder.tree_from_params`` of the port's
    params) → HF BERT tensor names, torch ``[out, in]`` layout, each array
    contiguous float32 (a writer that serialized a transposed view's buffer
    under its shape would store the weight transposed)."""
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))  # noqa: E731
    emb, lay = tree["embeddings"], tree["layers"]
    sd: Dict[str, np.ndarray] = {
        "bert.embeddings.word_embeddings.weight": f32(emb["word"]),
        "bert.embeddings.position_embeddings.weight": f32(emb["position"]),
        "bert.embeddings.token_type_embeddings.weight": f32(emb["token_type"]),
        "bert.embeddings.LayerNorm.weight": f32(emb["ln_scale"]),
        "bert.embeddings.LayerNorm.bias": f32(emb["ln_bias"]),
    }
    for i in range(cfg.num_layers):
        base = f"bert.encoder.layer.{i}."
        for key in ("q", "k", "v", "o", "ffn_in", "ffn_out"):
            sd[base + _HF_LAYER_NAMES[key] + ".weight"] = f32(np.asarray(lay[f"{key}_w"][i]).T)
            sd[base + _HF_LAYER_NAMES[key] + ".bias"] = f32(lay[f"{key}_b"][i])
        for key in ("attn_ln", "ffn_ln"):
            sd[base + _HF_LAYER_NAMES[key] + ".weight"] = f32(lay[f"{key}_scale"][i])
            sd[base + _HF_LAYER_NAMES[key] + ".bias"] = f32(lay[f"{key}_bias"][i])
    return sd


def save_hf_checkpoint(tree: Tree, cfg: EncoderConfig, out_dir: Union[str, Path],
                       vocab_tokens: Sequence[str],
                       extra_config: Optional[Dict[str, Any]] = None) -> Path:
    """Write an HF-layout BERT checkpoint: ``config.json``,
    ``model.safetensors``, ``vocab.txt`` and ``tokenizer_config.json``.
    ``Encoder(path)`` of either package and ``transformers.BertModel`` load
    it."""
    out = Path(out_dir)
    os.makedirs(out, exist_ok=True)
    config = {
        "model_type": "bert",
        "architectures": ["BertModel"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": max(cfg.type_vocab_size, 1),
        "layer_norm_eps": cfg.layer_norm_eps,
        "pad_token_id": cfg.pad_token_id,
        "hidden_act": "gelu",
    }
    config.update(extra_config or {})
    (out / "config.json").write_text(json.dumps(config, indent=2))
    io_safetensors.save_file(to_hf_state_dict(tree, cfg), out / "model.safetensors")
    (out / "vocab.txt").write_text("\n".join(vocab_tokens) + "\n", encoding="utf-8")
    (out / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "BertTokenizer", "do_lower_case": True,
    }))
    return out
