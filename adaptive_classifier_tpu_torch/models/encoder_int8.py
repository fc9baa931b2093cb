"""Int8 encoder forward: the encoder's four matrix products per layer in
int8, with float32 epilogues, residual stream and LayerNorms.

Counterpart of ``adaptive_classifier_tpu/models/encoder_int8.py``, for
the families it takes (``encoder.int8_arch``: BERT, DistilBERT, RoBERTa
with its padding-offset positions, and ELECTRA without an embedding
projection; the embeddings are ``encoder.embed_tokens``'s).  Weights
are per-output-channel symmetric int8 (``quantization.py``); activations
are quantized per row on the fly.  Per layer, with
``use_fused_ffn``:

- kernel B2 (``ops.matmul_int8.quant_matmul_int8``): the fused QKV
  projection;
- attention off the packed QKV tensor (``encoder.attention_fn``: kernel B1
  with ``attn_impl="fusedqkv"``, B6 with ``"flash"``, B7 with
  ``"oneshot"``, the plain version of B1 with ``"einsum"``);
- the O-projection as a plain int8 product (``_q_matmul``), residual and
  LayerNorm — or, with ``fuse_o_proj``, kernel B8 (``attn_ffn_block_int8``)
  for the O-projection and everything after it;
- kernel B3 (``ops.ffn_int8.ffn_block_int8``): the FFN with its residual
  and LayerNorm.

Without ``use_fused_ffn`` every product is ``_q_matmul`` and the FFN's
GELU is the exact erf, as in the JAX package.  ``use_fused_ffn=None``
follows the JAX package's policy with "the tensors are on a CUDA device"
in place of "the backend is a TPU": fused from 256 rows (B·S) when D and F
are multiples of 128, so the CPU takes the non-fused path as JAX's CPU
does.  ``use_fused_ffn=True`` on the CPU runs the kernels' plain versions.

Embedding cosine against the bf16 forward stays above 0.99, the envelope
the JAX package accepts for its int8 path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.ffn_int8 import attn_ffn_block_int8, ffn_block_int8
from ..ops.layernorm import add_layer_norm_ref
from ..ops.matmul_int8 import int8_matmul, quant_matmul_int8, quant_rows
from .encoder import (EncoderConfig, Params, _n_layers, attention_fn, embed_tokens,
                      int8_arch, pool_and_normalize)


def _dyn_quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 of f32 ``x [.., D]`` → (int8, f32 row scale
    ``[.., 1]``), scale ``absmax / 127``."""
    return quant_rows(x, divide=True)


def _q_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """``x [.., D]`` float → int8 product → ``[.., out]`` float32."""
    x_q, x_scale = _dyn_quant_rows(x.float())
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
    y = acc.reshape(*x_q.shape[:-1], -1).float() * x_scale * w_scale.float()
    return y + bias.float()


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    return add_layer_norm_ref(x, None, scale, bias, eps)


def encoder_forward_int8(
    qparams: Params,
    input_ids: torch.Tensor,       # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] 1 valid / 0 pad
    cfg: EncoderConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    use_fused_ffn: Optional[bool] = None,
    attn_impl: str = "einsum",
    fuse_o_proj: Optional[bool] = None,
) -> torch.Tensor:
    """The int8 forward → last hidden state ``[B, S, D]`` (float32).
    Raises for a family it does not take (``encoder.check_int8_arch``
    decides that before an encoder is built)."""
    if not int8_arch(cfg):
        raise ValueError(f"the int8 forward does not run arch {cfg.arch!r} "
                         f"(embedding_size={cfg.embedding_size})")
    attend = attention_fn(attn_impl)
    B, S = input_ids.shape
    D = cfg.hidden_size
    if use_fused_ffn is None:
        use_fused_ffn = (input_ids.device.type == "cuda" and B * S >= 256
                         and D % 128 == 0 and cfg.intermediate_size % 128 == 0)
    fuse_o_proj = bool(fuse_o_proj) and use_fused_ffn
    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    cd = compute_dtype
    h = embed_tokens(qparams, input_ids, attention_mask, cfg, cd)
    for i in range(_n_layers(cfg)):
        p = lambda name: qparams[f"layers.{i}.{name}"]   # noqa: E731
        x = h
        if use_fused_ffn:
            qkv = quant_matmul_int8(x.reshape(B * S, D), p("qkv_w.int8"),
                                    p("qkv_w.scale"), p("qkv_b")).reshape(B, S, 3 * D)
        else:
            qkv = _q_matmul(x, p("qkv_w.int8"), p("qkv_w.scale"), p("qkv_b"))
        ctx = attend(qkv.to(cd), attention_mask, H, Dh)
        if fuse_o_proj:
            h = attn_ffn_block_int8(
                ctx.reshape(B * S, D), x.reshape(B * S, D),
                p("o_w.int8"), p("o_w.scale"), p("o_b"),
                p("attn_ln_scale"), p("attn_ln_bias"),
                p("ffn_in_w.int8"), p("ffn_in_w.scale"), p("ffn_in_b"),
                p("ffn_out_w.int8"), p("ffn_out_w.scale"), p("ffn_out_b"),
                p("ffn_ln_scale"), p("ffn_ln_bias"), eps).reshape(B, S, D)
            continue
        attn_out = _q_matmul(ctx, p("o_w.int8"), p("o_w.scale"), p("o_b"))
        h = _layer_norm(attn_out.to(cd) + x, p("attn_ln_scale"), p("attn_ln_bias"), eps)
        if use_fused_ffn:
            h = ffn_block_int8(
                h.reshape(B * S, D),
                p("ffn_in_w.int8"), p("ffn_in_w.scale"), p("ffn_in_b"),
                p("ffn_out_w.int8"), p("ffn_out_w.scale"), p("ffn_out_b"),
                p("ffn_ln_scale"), p("ffn_ln_bias"), eps).reshape(B, S, D)
        else:
            ff = _q_matmul(h, p("ffn_in_w.int8"), p("ffn_in_w.scale"), p("ffn_in_b"))
            ff = F.gelu(ff, approximate="none")
            ff = _q_matmul(ff, p("ffn_out_w.int8"), p("ffn_out_w.scale"), p("ffn_out_b"))
            h = _layer_norm(ff.to(cd) + h, p("ffn_ln_scale"), p("ffn_ln_bias"), eps)
    return h.float()


def embed_texts_device_int8(qparams: Params, input_ids: torch.Tensor,
                            attention_mask: torch.Tensor, cfg: EncoderConfig,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            pooling: str = "cls", attn_impl: str = "einsum",
                            fuse_o_proj: Optional[bool] = None) -> torch.Tensor:
    """Int8 forward + CLS or masked-mean pooling + L2 normalize → ``[B, D]``
    float32."""
    hidden = encoder_forward_int8(qparams, input_ids, attention_mask, cfg,
                                  compute_dtype, attn_impl=attn_impl,
                                  fuse_o_proj=fuse_o_proj)
    return pool_and_normalize(hidden, attention_mask, pooling)
