"""Transformer encoder, BERT family, in PyTorch.

Counterpart of ``adaptive_classifier_tpu/models/encoder.py`` for the
``bert`` architecture: embeddings + LayerNorm, then per layer the fused
``[D, 3D]`` QKV projection, all-heads attention, the O-projection, residual
+ LayerNorm, an exact-erf GELU FFN and residual + LayerNorm; then pooling
and L2 normalization.

Matrix products take compute-dtype inputs (bf16 by default) and accumulate
in f32; biases are added and LayerNorm statistics taken in f32, as the JAX
forward does with ``preferred_element_type=jnp.float32``.  The plain matrix
products stay ``torch.matmul``.  Attention takes one of four paths
(``attn_impl``): ``"fusedqkv"`` (``ops.attention_qkv``, kernel B1, the
default on the GPU), ``"flash"`` and ``"oneshot"`` (``ops.flash_attention``,
kernels B6 and B7; the GPU default from 1,024 tokens is ``"flash"``), or
``"einsum"``, the plain torch version of B1 (the CPU default).
``AC_ATTN_IMPL`` in the environment forces the path, as in the JAX package.
The two residual LayerNorms per layer run through kernel B10
(``ops.layernorm.add_layer_norm``) when ``use_fused_ln`` is on, which it is
by default on a CUDA device (``_FUSED_LN_ON_CUDA``).

``quantization="int8"`` quantizes the float32 weights once and runs the
int8 forward (``models/encoder_int8.py``: kernels B2 and B3 on the GPU);
``"auto"`` resolves by ``resolve_quantization``.  A checkpoint's int8
export can stand in for a missing base checkpoint
(``Encoder.from_quantized_export``).

Weights load from a local HuggingFace-layout BERT checkpoint
(``config.json`` + ``model.safetensors``).  A model name with no local
checkpoint builds the named BERT architecture offline with deterministic
random weights from a numpy RNG, equal to the JAX package's bit for bit
(``init_params``), and the built-in vocabulary.  Other encoder families
come with later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import io_safetensors
from .._device import resolve_device
from ..ops.attention_qkv import attention_from_qkv, attention_from_qkv_ref
from ..ops.flash_attention import flash_attention, oneshot_attention
from ..ops.layernorm import add_layer_norm, add_layer_norm_ref

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


#: named BERT architectures for offline (weightless) operation: the exact
#: dims of the HF models (the JAX package's ``KNOWN_ARCHS``, BERT entries)
KNOWN_ARCHS: Dict[str, EncoderConfig] = {
    "prajjwal1/bert-tiny": EncoderConfig(hidden_size=128, num_layers=2, num_heads=2,
                                         intermediate_size=512),
    "bert-base-uncased": EncoderConfig(),
    "bert-base-cased": EncoderConfig(vocab_size=28996),
    "google-bert/bert-large-cased": EncoderConfig(
        vocab_size=28996, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096),
    "bert-large-uncased": EncoderConfig(hidden_size=1024, num_layers=24, num_heads=16,
                                        intermediate_size=4096),
}

#: name fragments of the other families the JAX package builds offline, in
#: the order its ``config_for_model_name`` tests them
_OTHER_FAMILIES = (("modernbert", "ModernBERT"), ("mpnet", "MPNet"),
                   ("electra", "ELECTRA"), ("deberta", "DeBERTa"))


def config_for_model_name(name: str) -> EncoderConfig:
    """The architecture an offline model name builds: a ``KNOWN_ARCHS``
    entry, else by name fragment as the JAX package resolves it, else
    bert-base.  The other families raise."""
    if name in KNOWN_ARCHS:
        return KNOWN_ARCHS[name]
    lowered = name.lower()
    for fragment, family in _OTHER_FAMILIES:
        if fragment in lowered:
            raise NotImplementedError(
                f"offline {family} encoder ({name!r}): the port builds BERT "
                f"encoders offline; {family} comes with a later slice")
    if "tiny" in lowered:
        return KNOWN_ARCHS["prajjwal1/bert-tiny"]
    if "large" in lowered:
        return KNOWN_ARCHS["bert-large-uncased"]
    if "distil" in lowered:
        raise NotImplementedError(
            f"offline distilbert encoder ({name!r}): the port builds BERT "
            f"encoders offline; distilbert comes with a later slice")
    return EncoderConfig()


def init_params(seed: int, cfg: EncoderConfig) -> Tree:
    """BERT init as the JAX package draws it: normal(0.02) weights from
    ``np.random.default_rng(seed)`` in the same order, zero biases, unit
    LayerNorms → the stacked-layer tree of float32 numpy arrays, equal to
    the JAX ``init_params`` array for array."""
    if cfg.arch != "bert":
        raise NotImplementedError(f"offline init for arch {cfg.arch!r} comes with "
                                  f"a later slice")
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    rng = np.random.default_rng(seed)

    def nrm(shape):
        return rng.standard_normal(shape, np.float32) * 0.02

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    emb = {"word": nrm((cfg.vocab_size, D)),
           "position": nrm((cfg.max_position_embeddings, D)),
           "token_type": nrm((max(cfg.type_vocab_size, 1), D)),
           "ln_scale": ones(D), "ln_bias": zeros(D)}
    layers = {
        "q_w": nrm((L, D, D)), "q_b": zeros(L, D),
        "k_w": nrm((L, D, D)), "k_b": zeros(L, D),
        "v_w": nrm((L, D, D)), "v_b": zeros(L, D),
        "o_w": nrm((L, D, D)), "o_b": zeros(L, D),
        "attn_ln_scale": ones(L, D), "attn_ln_bias": zeros(L, D),
        "ffn_in_w": nrm((L, D, F)), "ffn_in_b": zeros(L, F),
        "ffn_out_w": nrm((L, F, D)), "ffn_out_b": zeros(L, D),
        "ffn_ln_scale": ones(L, D), "ffn_ln_bias": zeros(L, D),
    }
    return {"embeddings": emb, "layers": layers}


def hash_name(s: str) -> int:
    """Stable string hash, FNV-1a over UTF-8 (Python's ``hash`` is salted
    per process); the JAX package's ``hash_name``."""
    h = 2166136261
    for ch in s.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def offline_seed(seed: int, model_name: str) -> int:
    """The seed of a name's offline weights: same name and seed → same
    weights, as the JAX package derives it."""
    return (seed * 1000003 + (hash_name(model_name) % 65521)) & 0x7FFFFFFF


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


def _product_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2d @ w`` in float32: the exact products of the operands' values
    summed in f32, never rounded to the operands' type.  On CUDA a bf16
    product takes ``torch.mm(..., out_dtype=torch.float32)``; elsewhere the
    operands are upcast (a product of two bf16 values is exact in f32)."""
    if x2d.device.type == "cuda" and x2d.dtype != torch.float32:
        return torch.mm(x2d, w, out_dtype=torch.float32)
    return torch.mm(x2d.float(), w.float())


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` → f32, the product on compute-dtype operands with f32
    sums and an f32 result, then the f32 bias: the caller's cast to the
    compute dtype is the one rounding, as in the JAX package's
    ``einsum(..., preferred_element_type=float32) + b`` (its
    ``models/encoder.py:454-456, 514-515, 523-527``)."""
    y = _product_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return (y + b.float()).reshape(*x.shape[:-1], w.shape[-1])


def _linear_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FFN's first projection: exact (erf) GELU of ``_linear`` → f32."""
    return F.gelu(_linear(x, w, b), approximate="none")


def embed_tokens(params: Params, input_ids: torch.Tensor, cfg: EncoderConfig,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Word + position (+ token type 0) embeddings and their LayerNorm →
    ``[B, S, D]`` in ``compute_dtype``.  Raises past the position table
    (the JAX package's gather clamps there and reuses its last row)."""
    S = input_ids.shape[1]
    if S > cfg.max_position_embeddings:
        raise ValueError(f"S={S} tokens > max_position_embeddings="
                         f"{cfg.max_position_embeddings}: the position table "
                         f"has no row for them")
    h = (params["embeddings.word"][input_ids.long()]
         + params["embeddings.position"][:S][None, :, :])
    if cfg.type_vocab_size > 0:
        h = h + params["embeddings.token_type"][0][None, None, :]
    h = add_layer_norm_ref(h, None, params["embeddings.ln_scale"],
                           params["embeddings.ln_bias"], cfg.layer_norm_eps)
    return h.to(compute_dtype)


def _n_layers(cfg: EncoderConfig) -> int:
    """Layers the forward runs: ``pool_layer`` when it truncates, else all."""
    return cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers


def pool_and_normalize(hidden: torch.Tensor, attention_mask: torch.Tensor,
                       pooling: str) -> torch.Tensor:
    """CLS (``"cls"``) or masked-mean (``"mean"``) pooling of ``[B, S, D]``,
    then L2 normalization → ``[B, D]``."""
    if pooling == "mean":
        m = attention_mask[:, :, None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    else:
        pooled = hidden[:, 0, :]
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


ATTN_IMPLS = ("fusedqkv", "flash", "oneshot", "einsum")


def attention_fn(attn_impl: str):
    """The attention of ``attn_impl`` as ``(qkv [B, S, 3D], mask [B, S], H,
    Dh) → [B, S, D]`` in qkv's type: ``"fusedqkv"`` B1, ``"flash"`` B6,
    ``"oneshot"`` B7 (each its CUDA kernel on a GPU tensor, its plain version
    on a CPU tensor), ``"einsum"`` the plain version of B1."""
    if attn_impl == "fusedqkv":
        return attention_from_qkv
    if attn_impl == "einsum":
        return attention_from_qkv_ref
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} not in {ATTN_IMPLS}")
    heads = flash_attention if attn_impl == "flash" else oneshot_attention

    def attend(qkv, attention_mask, H, Dh):
        B, S, _ = qkv.shape
        D = H * Dh
        # [B, S, H, Dh] views of the packed tensor, no copy
        q, k, v = (qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3))
        return heads(q, k, v, attention_mask).reshape(B, S, D)

    return attend


def encoder_forward(
    params: Params,
    input_ids: torch.Tensor,       # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] 1 valid / 0 pad
    cfg: EncoderConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "einsum",
    use_fused_ln: Optional[bool] = None,
) -> torch.Tensor:
    """Full encoder forward → last hidden state ``[B, S, D]`` (float32).

    ``attn_impl``: one of ``ATTN_IMPLS`` (``attention_fn``).
    ``use_fused_ln``: the two residual LayerNorms of each layer through
    ``ops.layernorm.add_layer_norm`` (kernel B10 on a GPU); ``None`` follows
    ``_FUSED_LN_ON_CUDA`` on a CUDA device and is off elsewhere.
    """
    attend = attention_fn(attn_impl)
    if use_fused_ln is None:
        use_fused_ln = _FUSED_LN_ON_CUDA and input_ids.device.type == "cuda"
    add_ln = add_layer_norm if use_fused_ln else add_layer_norm_ref
    h = embed_tokens(params, input_ids, cfg, compute_dtype)
    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    for i in range(_n_layers(cfg)):
        p = {n: params[f"layers.{i}.{n}"] for n in _MATRICES + _VECTORS}
        x = h
        qkv = _linear(x, p["qkv_w"], p["qkv_b"]).to(compute_dtype)
        ctx = attend(qkv, attention_mask, H, Dh).to(compute_dtype)
        attn_out = _linear(ctx, p["o_w"], p["o_b"])
        h = add_ln(attn_out.to(compute_dtype), x, p["attn_ln_scale"],
                   p["attn_ln_bias"], eps)
        ff = _linear_gelu(h, p["ffn_in_w"], p["ffn_in_b"]).to(compute_dtype)
        ff = _linear(ff, p["ffn_out_w"], p["ffn_out_b"])
        h = add_ln(ff.to(compute_dtype), h, p["ffn_ln_scale"],
                   p["ffn_ln_bias"], eps)
    return h.float()


def embed_texts_device(params: Params, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, cfg: EncoderConfig,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       attn_impl: str = "einsum",
                       use_fused_ln: Optional[bool] = None) -> torch.Tensor:
    """Encoder forward + CLS or masked-mean pooling + L2 normalize →
    ``[B, D]`` float32."""
    hidden = encoder_forward(params, input_ids, attention_mask, cfg,
                             compute_dtype, attn_impl=attn_impl,
                             use_fused_ln=use_fused_ln)
    return pool_and_normalize(hidden, attention_mask, cfg.pooling)


# ---------------------------------------------------------------------------
# Encoder facade
# ---------------------------------------------------------------------------

#: ``quantization="auto"`` resolves to int8 on a CUDA device only where the
#: int8 forward beat the bf16 forward at both zoo chunk shapes on the card
#: (PERF.md, the "auto" decision); elsewhere, and on the CPU, to float
_AUTO_INT8_ON_CUDA = False

#: the float forward's residual LayerNorms go through kernel B10 on a CUDA
#: device: with it the bf16 forward per chunk measured faster at both zoo
#: chunk shapes on an H100 (NVIDIA H100 80GB HBM3, 700 W: 5.19 against
#: 7.34 ms at [256, 32], 19.4 against 28.4 ms at [256, 128]; PERF.md, the
#: fused-LayerNorm decision).  The JAX package's counterpart,
#: ``use_fused_ln`` in its encoder forward, is off on its own TPU record.
_FUSED_LN_ON_CUDA = True


def resolve_quantization(quantization: Optional[str],
                         device: torch.device) -> Optional[str]:
    """``None`` (float), ``"int8"``, or ``"auto"`` resolved for ``device``."""
    if quantization == "auto":
        return "int8" if _AUTO_INT8_ON_CUDA and device.type == "cuda" else None
    if quantization not in (None, "int8"):
        raise NotImplementedError(
            f"quantization={quantization!r}: the port runs None, 'int8' or 'auto'")
    return quantization


def check_int8_arch(cfg: EncoderConfig):
    """The int8 forward is BERT's (the JAX package also takes distilbert,
    roberta and projection-free ELECTRA, which come with a later slice)."""
    if cfg.arch != "bert":
        raise NotImplementedError(
            f"quantization='int8' for arch {cfg.arch!r}: the port's int8 "
            f"forward runs BERT encoders")


def config_from_dict(d: Dict) -> EncoderConfig:
    """An ``EncoderConfig`` from the JAX package's config fields (an int8
    export's ``encoder_config``); fields the port lacks are ignored, and a
    non-BERT arch raises."""
    if d.get("arch", "bert") != "bert":
        raise NotImplementedError(
            f"encoder arch {d.get('arch')!r}: the port loads BERT encoders; "
            f"the other families come with a later slice")
    names = EncoderConfig.__dataclass_fields__
    return EncoderConfig(**{k: v for k, v in d.items() if k in names})


class Encoder:
    """Owns the encoder's weights on the device, its tokenizer, and the
    attention policy.  With ``quantization="int8"`` the weights are the
    int8 state (``quantization.quantize_encoder_for_inference``) and
    ``embed_ids`` runs the int8 forward (``encoder_int8``)."""

    #: sequence-length buckets: short queries pay for 32 tokens, not 512
    SEQ_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, model_name: str, compute_dtype: str = "bfloat16",
                 device: Optional[Union[str, torch.device]] = None,
                 quantization: Optional[str] = None, seed: int = 0):
        from .tokenizer import WordPieceTokenizer

        self._setup(compute_dtype, device, quantization)
        self.model_name = model_name
        ckpt = _find_local_checkpoint(model_name)
        if ckpt is not None:
            self.config = _read_hf_config(ckpt)
            self._read_tree = lambda: _map_hf_weights(_load_state_dict(ckpt), self.config)
            self.tokenizer = WordPieceTokenizer.from_pretrained(str(ckpt))
            self.pretrained = True
        else:
            # offline: the named architecture with the JAX package's random
            # weights for this name and seed, and the built-in vocabulary
            # padded to the arch's size (so the JAX package's shrink of the
            # word table to the vocabulary leaves it as it is)
            self.config = config_for_model_name(model_name)
            self._read_tree = lambda: init_params(offline_seed(seed, model_name),
                                                  self.config)
            self.tokenizer = WordPieceTokenizer.hermetic(self.config.vocab_size)
            self.pretrained = False
        tree = self._read_tree()
        if self.quantization == "int8":
            from ..quantization import quantize_encoder_for_inference

            check_int8_arch(self.config)
            # from the float32 weights, before any cast: the int8 values
            # and scales are then the JAX package's bit for bit
            self.params = self._on_device(
                quantize_encoder_for_inference(params_from_tree(tree)))
        else:
            self.params = params_from_tree(tree, device=self.device,
                                           matrix_dtype=self.compute_dtype)

    def _setup(self, compute_dtype: str, device, quantization: Optional[str]):
        self.device = resolve_device(device)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in {list(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute_dtype]
        self.quantization = resolve_quantization(quantization, self.device)
        #: forces the attention path (one of ``ATTN_IMPLS``; it wins over
        #: ``AC_ATTN_IMPL``); None = policy
        self.attn_impl: Optional[str] = None

    def _on_device(self, params: Params) -> Params:
        """The int8 state on the encoder's device; on a CUDA device with the
        K-contiguous QKV, O and FFN weights that kernels B2, B3 and B8 read,
        made once here."""
        params = {k: v.to(self.device) for k, v in params.items()}
        if self.device.type == "cuda":
            from ..ops.ffn_int8 import prepare_int8_weights

            prepare_int8_weights(params)
        return params

    @classmethod
    def from_quantized_export(cls, directory: Union[str, Path], model_name: str,
                              compute_dtype: str = "bfloat16",
                              device: Optional[Union[str, torch.device]] = None,
                              quantization: Optional[str] = None) -> "Encoder":
        """The encoder a checkpoint's ``quantized/`` export captured, for a
        machine without the base checkpoint: its config and vocabulary, as
        the int8 state (int8 quantization) or dequantized float weights."""
        from ..quantization import load_quantized_encoder_params
        from .tokenizer import WordPieceTokenizer

        directory = Path(directory)
        self = cls.__new__(cls)
        self._setup(compute_dtype, device, quantization)
        self.model_name = model_name
        want = "int8" if self.quantization == "int8" else "float"
        params, enc_cfg, qcfg = load_quantized_encoder_params(directory, want=want)
        if not qcfg.get("encoder_pretrained", False):
            raise NotImplementedError(
                f"the export at {directory} holds a random-weight encoder: the "
                f"offline random-weight encoder comes with a later slice")
        if not (directory / "vocab.txt").exists():
            # pretrained rows paired with another vocabulary's ids would
            # embed confident nonsense
            raise ValueError(
                f"int8 export at {directory} has no vocab.txt and no real "
                f"tokenizer is available: refusing to pair pretrained weights "
                f"with another vocabulary")
        self.config = config_from_dict(enc_cfg)
        self._read_tree = lambda: load_quantized_encoder_params(directory)[0]
        if self.quantization == "int8":
            self.params = self._on_device(params)
        else:
            self.params = params_from_tree(params, device=self.device,
                                           matrix_dtype=self.compute_dtype)
        self.tokenizer = WordPieceTokenizer.from_pretrained(str(directory))
        self.pretrained = True
        return self

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size

    def float_tree(self) -> Tree:
        """The float32 weights as the JAX package's stacked-layer tree, read
        again from where they came from (the local checkpoint, the offline
        seed, or the int8 export), not from the device copy, whose matrices
        may be bf16 or int8."""
        return self._read_tree()

    def _attn_impl(self, seq_len: int) -> str:
        """Attention policy, read on every call: ``self.attn_impl`` if set,
        else ``AC_ATTN_IMPL`` if set (the JAX package's override), else plain
        torch on the CPU; on the GPU the flash kernel (B6) from 1,024 tokens
        and the packed-QKV kernel (B1) below, inside its envelope."""
        if self.attn_impl is not None:
            return self.attn_impl
        forced = os.environ.get("AC_ATTN_IMPL")
        if forced:
            return forced
        if self.device.type == "cpu":
            return "einsum"
        if seq_len >= 1024:
            return "flash"
        dh = self.config.head_dim
        if dh > 128 or dh % 8 or seq_len % 8:
            raise NotImplementedError(
                f"head_dim={dh}, S={seq_len} is outside the packed-QKV kernel's "
                f"envelope (head_dim <= 128, head_dim % 8 == 0, S % 8 == 0)")
        return "fusedqkv"

    def embed_ids(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Padded token ids and mask (host int32) → normalized ``[B, D]``."""
        ids_t = torch.as_tensor(ids).to(self.device, non_blocking=True)
        mask_t = torch.as_tensor(mask).to(self.device, non_blocking=True)
        attn_impl = self._attn_impl(ids.shape[1])
        with torch.inference_mode():
            if self.quantization == "int8":
                from .encoder_int8 import embed_texts_device_int8

                return embed_texts_device_int8(
                    self.params, ids_t, mask_t, self.config, self.compute_dtype,
                    pooling=self.config.pooling, attn_impl=attn_impl)
            return embed_texts_device(self.params, ids_t, mask_t, self.config,
                                      self.compute_dtype, attn_impl=attn_impl)

    def embed(self, texts: Sequence[str], max_length: int = 512) -> torch.Tensor:
        """Tokenize on the host, embed on the device → normalized ``[B, D]``."""
        ids, mask = self.tokenizer(texts, max_length=max_length,
                                   pad_to_buckets=self.SEQ_BUCKETS)
        return self.embed_ids(ids, mask)
