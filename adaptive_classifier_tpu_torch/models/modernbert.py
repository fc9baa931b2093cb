"""ModernBERT encoder in PyTorch: RoPE, alternating local / global
attention, GeGLU, pre-norm, bias-free.

Counterpart of ``adaptive_classifier_tpu/models/modernbert.py``:

- token embeddings → LayerNorm (no position table: rotary at attention);
- per layer: pre-norm attention (layer 0's attention norm is the identity)
  with fused QKV, RoPE (``global_rope_theta`` on every
  ``global_attn_every_n_layers``-th layer, ``local_rope_theta`` on the
  others), a sliding window of ±``local_attention/2`` on the local layers;
  then the pre-norm GeGLU MLP ``Wo(gelu(input) · gate)``;
- the final LayerNorm; every linear layer and norm without a bias.

Plain torch on every device, as the JAX package computes it in plain
``jnp`` (no Pallas kernel runs here; a fused residual + LayerNorm does not
fit a pre-norm block): products with f32 sums, RoPE, scores and softmax in
f32, the residual stream in the compute dtype.

State names: ``embeddings.word``, ``embeddings.ln_scale``,
``layers.{i}.{name}`` for ``name`` in ``MATRICES + VECTORS``, and
``final_ln_scale``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention_qkv import NEG
from ..ops.layernorm import add_layer_norm_ref
from .encoder import EncoderConfig, Params, Tree, _matmul_f32

MATRICES = ("wqkv", "wo", "wi", "wo_mlp")
VECTORS = ("attn_ln_scale", "mlp_ln_scale")


def _rope_tables(S: int, dh: int, theta: float, device) -> tuple:
    """cos and sin ``[S, dh]`` f32, formed in float64 as the JAX package's."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    freqs = np.outer(np.arange(S, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [B, S, H, Dh]`` rotated by positions: ``x·cos + rotate_half(x)·sin``."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Bias-free LayerNorm with f32 statistics → dtype of ``x``."""
    return add_layer_norm_ref(x, None, scale, torch.zeros_like(scale), eps)


def modernbert_forward(params: Params, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, cfg: EncoderConfig,
                       compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ModernBERT forward → last hidden state ``[B, S, D]`` (float32), the
    JAX package's ``modernbert_forward`` step for step."""
    B, S = input_ids.shape
    D, H = cfg.hidden_size, cfg.num_heads
    Dh = D // H
    eps, cd = cfg.layer_norm_eps, compute_dtype
    dev = input_ids.device
    h = _norm(params["embeddings.word"][input_ids.long()],
              params["embeddings.ln_scale"], eps).to(cd)

    pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG).float()  # [B,1,1,S]
    pos = torch.arange(S, device=dev)
    window = (pos[None, :] - pos[:, None]).abs() <= cfg.local_attention // 2
    local = torch.where(window[None, None], pad, torch.full_like(pad, NEG))    # [B,1,S,S]
    rope = {True: _rope_tables(S, Dh, cfg.global_rope_theta, dev),
            False: _rope_tables(S, Dh, cfg.local_rope_theta, dev)}
    scale = 1.0 / math.sqrt(Dh)

    for i in range(cfg.num_layers):
        p = {n: params[f"layers.{i}.{n}"] for n in MATRICES + VECTORS}
        is_global = i % cfg.global_attn_every_n_layers == 0
        x = h
        attn_in = x if i == 0 else _norm(x, p["attn_ln_scale"], eps)
        qkv = _matmul_f32(attn_in, p["wqkv"]).reshape(B, S, 3, H, Dh)
        cos, sin = rope[is_global]
        q = _apply_rope(qkv[:, :, 0], cos, sin).to(cd).float()
        k = _apply_rope(qkv[:, :, 1], cos, sin).to(cd).float()
        v = qkv[:, :, 2].to(cd).float()
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        logits = logits + (pad if is_global else local)
        probs = torch.softmax(logits, dim=-1).to(cd).float()
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D).to(cd)
        h = x + _matmul_f32(ctx, p["wo"]).to(cd)

        inp, gate = _matmul_f32(_norm(h, p["mlp_ln_scale"], eps), p["wi"]).chunk(2, dim=-1)
        act = F.gelu(inp, approximate="none") * gate
        h = h + _matmul_f32(act.to(cd), p["wo_mlp"]).to(cd)
    return _norm(h, params["final_ln_scale"], eps).float()


def init_modernbert_params(seed: int, cfg: EncoderConfig) -> Tree:
    """The JAX package's offline ModernBERT init, array for array:
    normal(0.02) weights from ``np.random.default_rng(seed)`` in its draw
    order, unit norms."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    rng = np.random.default_rng(seed)

    def nrm(shape):
        return rng.standard_normal(shape, np.float32) * 0.02

    return {
        "embeddings": {"word": nrm((cfg.vocab_size, D)), "ln_scale": np.ones(D, np.float32)},
        "layers": {
            "attn_ln_scale": np.ones((L, D), np.float32),
            "wqkv": nrm((L, D, 3 * D)),
            "wo": nrm((L, D, D)),
            "mlp_ln_scale": np.ones((L, D), np.float32),
            "wi": nrm((L, D, 2 * I)),
            "wo_mlp": nrm((L, I, D)),
        },
        "final_ln_scale": np.ones(D, np.float32),
    }


def map_modernbert_weights(sd: Dict[str, np.ndarray], cfg: EncoderConfig) -> Tree:
    """HF ModernBERT tensors (``model.`` prefix optional) → the stacked-layer
    tree (float32, weights ``[in, out]``); layer 0's missing ``attn_norm``
    becomes a unit scale."""
    def get(name, default=None):
        for p in ("model.", ""):
            if p + name in sd:
                return np.asarray(sd[p + name], np.float32)
        if default is not None:
            return default
        raise KeyError(name)

    D, L = cfg.hidden_size, cfg.num_layers
    ones = np.ones((D,), np.float32)

    def stack(name, transpose=False, first=None):
        rows = [get(f"layers.{i}.{name}", first if i == 0 else None) for i in range(L)]
        return np.stack([r.T for r in rows] if transpose else rows)

    return {
        "embeddings": {"word": get("embeddings.tok_embeddings.weight"),
                       "ln_scale": get("embeddings.norm.weight")},
        "layers": {
            "attn_ln_scale": stack("attn_norm.weight", first=ones),
            "wqkv": stack("attn.Wqkv.weight", transpose=True),
            "wo": stack("attn.Wo.weight", transpose=True),
            "mlp_ln_scale": stack("mlp_norm.weight"),
            "wi": stack("mlp.Wi.weight", transpose=True),
            "wo_mlp": stack("mlp.Wo.weight", transpose=True),
        },
        "final_ln_scale": get("final_norm.weight"),
    }
