"""Transformer encoder, BERT family, in PyTorch.

Counterpart of ``adaptive_classifier_tpu/models/encoder.py`` for the
``bert`` architecture: embeddings + LayerNorm, then per layer the fused
``[D, 3D]`` QKV projection, all-heads attention off the packed QKV tensor,
the O-projection, residual + LayerNorm, an exact-erf GELU FFN and residual +
LayerNorm; then pooling and L2 normalization.

Matrix products take compute-dtype inputs (bf16 by default) and accumulate
in f32; biases are added and LayerNorm statistics taken in f32, as the JAX
forward does with ``preferred_element_type=jnp.float32``.  The plain matrix
products stay ``torch.matmul``; attention goes through
``ops.attention_qkv.attention_from_qkv``, whose CUDA kernel serves every
layer on the GPU.

Weights load from a local HuggingFace-layout BERT checkpoint
(``config.json`` + ``model.safetensors``).  Other encoder families, the int8
forward and the offline random-weight mode come with later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import io_safetensors
from .._device import resolve_device
from ..ops.attention_qkv import attention_from_qkv, attention_from_qkv_ref

#: the stacked-layer tree of the JAX package: {"embeddings": {...},
#: "layers": {name: [L, ...]}} of numpy arrays
Tree = Dict[str, Dict[str, np.ndarray]]
#: the port's encoder state: flat names → tensors (see params_from_tree)
Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    arch: str = "bert"
    #: sentence pooling: "cls" or "mean" (masked mean)
    pooling: str = "cls"
    #: pool after this many layers (0 = all layers)
    pool_layer: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

def _find_local_checkpoint(model_name: str) -> Optional[Path]:
    p = Path(model_name)
    if p.is_dir() and (p / "config.json").exists():
        return p
    return None


def _read_hf_config(path: Path) -> EncoderConfig:
    cfg = json.loads((Path(path) / "config.json").read_text())
    model_type = cfg.get("model_type") or ""
    if model_type != "bert":
        raise NotImplementedError(
            f"encoder model_type {model_type!r}: the port loads BERT encoders; "
            f"the other families come with a later slice")
    return EncoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=cfg.get("pad_token_id", 0), arch="bert",
        pooling=cfg.get("ac_pooling", "cls"),
        pool_layer=cfg.get("ac_pool_layer", 0),
    )


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    st = Path(path) / "model.safetensors"
    if not st.exists():
        raise FileNotFoundError(f"No model.safetensors in {path}")
    return io_safetensors.load_file(st)


_LAYER_NAMES = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "o": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}


def _map_hf_weights(sd: Dict[str, np.ndarray], cfg: EncoderConfig) -> Tree:
    """Map HF BERT tensor names into the JAX package's stacked-layer tree
    (float32 numpy, weights ``[in, out]``)."""
    if cfg.arch != "bert":
        raise NotImplementedError(f"weight mapping for arch {cfg.arch!r} comes "
                                  f"with a later slice")

    def get(name: str) -> np.ndarray:
        for p in ("bert.", ""):
            if p + name in sd:
                return np.asarray(sd[p + name], np.float32)
        raise KeyError(name)

    D = cfg.hidden_size
    emb = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": get("embeddings.position_embeddings.weight"),
        "token_type": (get("embeddings.token_type_embeddings.weight")
                       if cfg.type_vocab_size > 0
                       else np.zeros((1, D), np.float32)),
        "ln_scale": get("embeddings.LayerNorm.weight"),
        "ln_bias": get("embeddings.LayerNorm.bias"),
    }

    def stack(n: str, suffix: str, transpose: bool = False) -> np.ndarray:
        rows = [get(f"encoder.layer.{i}.{_LAYER_NAMES[n]}.{suffix}")
                for i in range(cfg.num_layers)]
        return np.stack([r.T for r in rows] if transpose else rows)

    layers: Dict[str, np.ndarray] = {}
    # torch Linear stores [out, in]; transpose to [in, out] for x @ W
    for key in ("q", "k", "v", "o", "ffn_in", "ffn_out"):
        layers[f"{key}_w"] = stack(key, "weight", transpose=True)
        layers[f"{key}_b"] = stack(key, "bias")
    for key in ("attn_ln", "ffn_ln"):
        layers[f"{key}_scale"] = stack(key, "weight")
        layers[f"{key}_bias"] = stack(key, "bias")
    return {"embeddings": emb, "layers": layers}


#: per-layer tensors of the port's state dict, as matrices (cast to the
#: compute dtype on the device) or f32 vectors
_MATRICES = ("qkv_w", "o_w", "ffn_in_w", "ffn_out_w")
_VECTORS = ("qkv_b", "o_b", "attn_ln_scale", "attn_ln_bias",
            "ffn_in_b", "ffn_out_b", "ffn_ln_scale", "ffn_ln_bias")


def params_from_tree(tree: Tree, device: Union[str, torch.device] = "cpu",
                     matrix_dtype: torch.dtype = torch.float32) -> Params:
    """The JAX package's stacked-layer tree → the port's flat state dict.

    Names: ``embeddings.{word,position,token_type,ln_scale,ln_bias}`` and
    ``layers.{i}.{name}`` for ``name`` in ``_MATRICES + _VECTORS``, with
    Q, K and V concatenated into the fused ``[D, 3D]`` projection.  Matrices
    are stored in ``matrix_dtype``; everything else stays float32.
    """
    def t(a, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dtype)

    lay = tree["layers"]
    qkv_w = np.concatenate([lay["q_w"], lay["k_w"], lay["v_w"]], axis=2)
    qkv_b = np.concatenate([lay["q_b"], lay["k_b"], lay["v_b"]], axis=1)
    per_layer = {"qkv_w": qkv_w, "qkv_b": qkv_b,
                 **{n: lay[n] for n in _MATRICES + _VECTORS
                    if n not in ("qkv_w", "qkv_b")}}
    params: Params = {f"embeddings.{k}": t(v) for k, v in tree["embeddings"].items()}
    for i in range(qkv_w.shape[0]):
        for n, arr in per_layer.items():
            params[f"layers.{i}.{n}"] = t(arr[i], matrix_dtype if n in _MATRICES
                                          else torch.float32)
    return params


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------

def _add_layer_norm(x: torch.Tensor, resid: Optional[torch.Tensor],
                    scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """``LayerNorm(x + resid)`` with f32 statistics → dtype of ``x``."""
    s = x.float() if resid is None else x.float() + resid.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    y = (s - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` → f32, the product on compute-dtype inputs.  torch's
    bf16 product accumulates in f32 and rounds once to bf16 before the f32
    bias add; in f32 the two paths are the same."""
    return torch.matmul(x, w.to(x.dtype)).float() + b.float()


def encoder_forward(
    params: Params,
    input_ids: torch.Tensor,       # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] 1 valid / 0 pad
    cfg: EncoderConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "einsum",
) -> torch.Tensor:
    """Full encoder forward → last hidden state ``[B, S, D]`` (float32).

    ``attn_impl``: ``"fusedqkv"`` = ``attention_from_qkv`` (the CUDA kernel
    on a GPU), ``"einsum"`` = its plain torch version.
    """
    if attn_impl not in ("fusedqkv", "einsum"):
        raise NotImplementedError(f"attn_impl={attn_impl!r} comes with a later slice")
    B, S = input_ids.shape
    ids = input_ids.long()
    h = (params["embeddings.word"][ids]
         + params["embeddings.position"][:S][None, :, :])
    if cfg.type_vocab_size > 0:
        h = h + params["embeddings.token_type"][0][None, None, :]
    h = _add_layer_norm(h, None, params["embeddings.ln_scale"],
                        params["embeddings.ln_bias"], cfg.layer_norm_eps)
    h = h.to(compute_dtype)

    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    attend = attention_from_qkv if attn_impl == "fusedqkv" else attention_from_qkv_ref
    n_layers = (cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers
                else cfg.num_layers)
    for i in range(n_layers):
        p = {n: params[f"layers.{i}.{n}"] for n in _MATRICES + _VECTORS}
        x = h
        qkv = _linear(x, p["qkv_w"], p["qkv_b"]).to(compute_dtype)
        ctx = attend(qkv, attention_mask, H, Dh).to(compute_dtype)
        attn_out = _linear(ctx, p["o_w"], p["o_b"])
        h = _add_layer_norm(attn_out.to(compute_dtype), x, p["attn_ln_scale"],
                            p["attn_ln_bias"], eps)
        ff = F.gelu(_linear(h, p["ffn_in_w"], p["ffn_in_b"]),
                    approximate="none").to(compute_dtype)
        ff = _linear(ff, p["ffn_out_w"], p["ffn_out_b"])
        h = _add_layer_norm(ff.to(compute_dtype), h, p["ffn_ln_scale"],
                            p["ffn_ln_bias"], eps)
    return h.float()


def embed_texts_device(params: Params, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, cfg: EncoderConfig,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       attn_impl: str = "einsum") -> torch.Tensor:
    """Encoder forward + CLS or masked-mean pooling + L2 normalize →
    ``[B, D]`` float32."""
    hidden = encoder_forward(params, input_ids, attention_mask, cfg,
                             compute_dtype, attn_impl=attn_impl)
    if cfg.pooling == "mean":
        m = attention_mask[:, :, None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    else:
        pooled = hidden[:, 0, :]
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# Encoder facade
# ---------------------------------------------------------------------------

class Encoder:
    """Owns the encoder's weights on the device, its tokenizer, and the
    attention policy."""

    #: sequence-length buckets: short queries pay for 32 tokens, not 512
    SEQ_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, model_name: str, compute_dtype: str = "bfloat16",
                 device: Optional[Union[str, torch.device]] = None,
                 quantization: Optional[str] = None):
        from .tokenizer import WordPieceTokenizer

        self.device = resolve_device(device)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in {list(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute_dtype]
        # "auto" picks int8 only where the int8 kernels win (the JAX package:
        # only on a TPU); the float path is the port's until int8 is ported
        if quantization not in (None, "auto"):
            raise NotImplementedError(
                f"quantization={quantization!r}: the int8 encoder (kernels B2, "
                f"B3) comes with a later slice")
        self.quantization = None
        self.model_name = model_name
        ckpt = _find_local_checkpoint(model_name)
        if ckpt is None:
            raise NotImplementedError(
                f"no local checkpoint at {model_name!r}: the offline "
                f"random-weight encoder comes with a later slice")
        self.config = _read_hf_config(ckpt)
        self.params = params_from_tree(
            _map_hf_weights(_load_state_dict(ckpt), self.config),
            device=self.device, matrix_dtype=self.compute_dtype)
        self.tokenizer = WordPieceTokenizer.from_pretrained(str(ckpt))
        self.pretrained = True
        #: forces the attention path ("einsum" = plain torch); None = policy
        self.attn_impl: Optional[str] = None

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size

    def _attn_impl(self, seq_len: int) -> str:
        """Attention policy: plain torch on the CPU; on the GPU the packed-QKV
        kernel inside its envelope, and an error outside it until the flash
        kernel (B6) is ported.  ``self.attn_impl`` overrides it."""
        if self.attn_impl is not None:
            return self.attn_impl
        if self.device.type == "cpu":
            return "einsum"
        dh = self.config.head_dim
        if seq_len >= 1024:
            raise NotImplementedError(
                f"S={seq_len} >= 1024 runs in the flash kernel (B6, "
                f"flash_attention_padded), which is not yet ported to CUDA")
        if dh > 128 or dh % 8 or seq_len % 8:
            raise NotImplementedError(
                f"head_dim={dh}, S={seq_len} is outside the packed-QKV kernel's "
                f"envelope (head_dim <= 128, head_dim % 8 == 0, S % 8 == 0)")
        return "fusedqkv"

    def embed_ids(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Padded token ids and mask (host int32) → normalized ``[B, D]``."""
        ids_t = torch.as_tensor(ids).to(self.device, non_blocking=True)
        mask_t = torch.as_tensor(mask).to(self.device, non_blocking=True)
        with torch.inference_mode():
            return embed_texts_device(self.params, ids_t, mask_t, self.config,
                                      self.compute_dtype,
                                      attn_impl=self._attn_impl(ids.shape[1]))

    def embed(self, texts: Sequence[str], max_length: int = 512) -> torch.Tensor:
        """Tokenize on the host, embed on the device → normalized ``[B, D]``."""
        ids, mask = self.tokenizer(texts, max_length=max_length,
                                   pad_to_buckets=self.SEQ_BUCKETS)
        return self.embed_ids(ids, mask)
