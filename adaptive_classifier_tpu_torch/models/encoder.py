"""Transformer encoders in PyTorch: BERT, DistilBERT, RoBERTa, ELECTRA,
MPNet, DeBERTa-v2/v3 and (``models/modernbert.py``) ModernBERT.

Counterpart of ``adaptive_classifier_tpu/models/encoder.py``.  Every family
but ModernBERT is a post-LayerNorm stack: embeddings + LayerNorm, then per
layer the fused ``[D, 3D]`` QKV projection, all-heads attention, the
O-projection, residual + LayerNorm, an exact-erf GELU FFN and residual +
LayerNorm; then pooling and L2 normalization.  The families differ in their
embeddings (``embed_tokens``: RoBERTa's and MPNet's padding-offset
positions, ELECTRA's narrow table and projection, DeBERTa's order and
masked rows) and in their attention:

- BERT, DistilBERT, RoBERTa and ELECTRA take one of four paths
  (``attn_impl``): ``"fusedqkv"`` (``ops.attention_qkv``, kernel B1, the
  default on the GPU), ``"flash"`` and ``"oneshot"``
  (``ops.flash_attention``, kernels B6 and B7; the GPU default from 1,024
  tokens is ``"flash"``), or ``"einsum"``, the plain torch version of B1
  (the CPU default).  ``AC_ATTN_IMPL`` in the environment forces the path,
  as in the JAX package.
- MPNet (a bucketed relative bias shared by all layers) and DeBERTa
  (disentangled content-to-position and position-to-content scores) run
  ``relative_attention``, plain torch on every device, as the JAX package
  computes them in plain ``jnp`` whatever ``attn_impl`` asks.

Matrix products take compute-dtype inputs (bf16 by default) and accumulate
in f32; biases are added and LayerNorm statistics taken in f32, as the JAX
forward does with ``preferred_element_type=jnp.float32``.  The two
residual LayerNorms per layer run through kernel B10
(``ops.layernorm.add_layer_norm``) when ``use_fused_ln`` is on, which it is
by default on a CUDA device (``_FUSED_LN_ON_CUDA``).

``quantization="int8"`` quantizes the float32 weights once and runs the
int8 forward (``models/encoder_int8.py``: kernels B2 and B3 on the GPU) for
BERT, DistilBERT, RoBERTa and ELECTRA without an embedding projection; for
the other families it logs a warning and the encoder runs the float
forward (``check_int8_arch``, the JAX package's rule), decided from the
config before any weight is made.  ``"auto"`` resolves by
``resolve_quantization``.  A checkpoint's int8 export can stand in for a
missing base checkpoint (``Encoder.from_quantized_export``).

The forward is differentiable on every path that has no kernel: on CUDA
a bf16 product that autograd records goes through ``_ProductF32``, whose
backward takes the JAX package's transpose (f32 cotangent, each gradient
rounded once to its operand's type).  Training (``finetune.py``,
``pretrain.py``) runs ``attn_impl="einsum"`` and ``use_fused_ln=False``;
the kernel wrappers refuse autograd.  ``Encoder.master_params`` gives the
float32 weights a run trains and ``Encoder.adopt_trained`` takes them back
(``tree_from_params`` inverts ``params_from_tree``).

Weights load from a local HuggingFace-layout checkpoint (``config.json`` +
``model.safetensors`` or ``pytorch_model.bin``); the tokenizer is its
``tokenizer.json`` when that is not WordPiece
(``models/hf_tokenizer_adapter.py``), else its ``vocab.txt``, else the
built-in vocabulary.  A model name with no local checkpoint builds the
named architecture offline with deterministic random weights from a numpy
RNG, equal to the JAX package's bit for bit (``init_params``), and the
built-in vocabulary.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import io_safetensors
from .._device import resolve_device
from ..ops.attention_qkv import NEG, attention_from_qkv, attention_from_qkv_ref
from ..ops.flash_attention import flash_attention, oneshot_attention
from ..ops.layernorm import add_layer_norm, add_layer_norm_ref

logger = logging.getLogger(__name__)

#: the stacked-layer tree of the JAX package: {"embeddings": {...},
#: "layers": {name: [L, ...]}} of numpy arrays (ModernBERT adds
#: "final_ln_scale")
Tree = Dict[str, Dict[str, np.ndarray]]
#: the port's encoder state: flat names → tensors (see params_from_tree)
Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class EncoderConfig:
    """The JAX package's ``EncoderConfig``, field for field (an int8
    export's ``encoder_config`` is this dict in either package)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    #: bert | distilbert | roberta | modernbert | electra | mpnet | deberta
    arch: str = "bert"
    #: sentence pooling: "cls" or "mean" (masked mean)
    pooling: str = "cls"
    #: pool after this many layers (0 = all layers; ModernBERT runs all)
    pool_layer: int = 0
    # ModernBERT: every n-th layer attends globally, the others within
    # ±local_attention/2; RoPE bases of the two kinds of layer
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    #: ELECTRA / DeBERTa: embedding-table width when it differs from
    #: hidden_size (0 = same), widened by a learned projection
    embedding_size: int = 0
    #: MPNet: buckets of the relative attention bias shared by every layer
    #: (0 = none) and the distance where the log buckets end
    relative_attn_buckets: int = 0
    relative_attn_max_distance: int = 128
    #: DeBERTa: the span K of each direction (the shared relative table has
    #: 2K rows; 0 = no relative attention), HF position_buckets (0 = raw
    #: offsets), the log-bucket max_position, the score terms ("p2c|c2p"),
    #: the table's LayerNorm, and whether absolute positions are added
    rel_att_span: int = 0
    rel_att_buckets: int = 0
    rel_att_max_pos: int = 0
    rel_pos_att: str = ""
    rel_norm: bool = False
    position_biased_input: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


#: named architectures for offline (weightless) operation: the exact dims
#: of the HF models (the JAX package's ``KNOWN_ARCHS``)
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
    "distilbert-base-uncased": EncoderConfig(num_layers=6, type_vocab_size=0,
                                             arch="distilbert"),
    "distilbert-base-cased": EncoderConfig(vocab_size=28996, num_layers=6,
                                           type_vocab_size=0, arch="distilbert"),
    "answerdotai/ModernBERT-base": EncoderConfig(
        vocab_size=50368, hidden_size=768, num_layers=22, num_heads=12,
        intermediate_size=1152, max_position_embeddings=8192,
        type_vocab_size=0, layer_norm_eps=1e-5, arch="modernbert"),
    "answerdotai/ModernBERT-large": EncoderConfig(
        vocab_size=50368, hidden_size=1024, num_layers=28, num_heads=16,
        intermediate_size=2624, max_position_embeddings=8192,
        type_vocab_size=0, layer_norm_eps=1e-5, arch="modernbert"),
    "google/electra-small-discriminator": EncoderConfig(
        hidden_size=256, num_layers=12, num_heads=4, intermediate_size=1024,
        embedding_size=128, arch="electra"),
    "google/electra-base-discriminator": EncoderConfig(arch="electra"),
    "microsoft/mpnet-base": EncoderConfig(
        vocab_size=30527, max_position_embeddings=514, type_vocab_size=0,
        layer_norm_eps=1e-5, pad_token_id=1, arch="mpnet", relative_attn_buckets=32),
    "sentence-transformers/all-mpnet-base-v2": EncoderConfig(
        vocab_size=30527, max_position_embeddings=514, type_vocab_size=0,
        layer_norm_eps=1e-5, pad_token_id=1, arch="mpnet", relative_attn_buckets=32,
        pooling="mean"),
    "microsoft/deberta-v3-base": EncoderConfig(
        vocab_size=128100, type_vocab_size=0, layer_norm_eps=1e-7, arch="deberta",
        rel_att_span=256, rel_att_buckets=256, rel_att_max_pos=512,
        rel_pos_att="p2c|c2p", rel_norm=True),
    "microsoft/deberta-v3-xsmall": EncoderConfig(
        vocab_size=128100, hidden_size=384, num_layers=12, num_heads=6,
        intermediate_size=1536, type_vocab_size=0, layer_norm_eps=1e-7, arch="deberta",
        rel_att_span=256, rel_att_buckets=256, rel_att_max_pos=512,
        rel_pos_att="p2c|c2p", rel_norm=True),
}


def config_for_model_name(name: str) -> EncoderConfig:
    """The architecture an offline model name builds: a ``KNOWN_ARCHS``
    entry, else by name fragment as the JAX package resolves it, else
    bert-base."""
    if name in KNOWN_ARCHS:
        return KNOWN_ARCHS[name]
    lowered = name.lower()
    if "modernbert" in lowered:
        return KNOWN_ARCHS["answerdotai/ModernBERT-large" if "large" in lowered
                           else "answerdotai/ModernBERT-base"]
    if "mpnet" in lowered:
        return KNOWN_ARCHS["microsoft/mpnet-base"]
    if "electra" in lowered:
        return KNOWN_ARCHS["google/electra-small-discriminator" if "small" in lowered
                           else "google/electra-base-discriminator"]
    if "deberta" in lowered:
        return KNOWN_ARCHS["microsoft/deberta-v3-xsmall" if "xsmall" in lowered
                           else "microsoft/deberta-v3-base"]
    if "tiny" in lowered:
        return KNOWN_ARCHS["prajjwal1/bert-tiny"]
    if "large" in lowered:
        return KNOWN_ARCHS["bert-large-uncased"]
    if "distil" in lowered:
        return KNOWN_ARCHS["distilbert-base-uncased"]
    return EncoderConfig()


def init_params(seed: int, cfg: EncoderConfig) -> Tree:
    """The JAX package's offline init: normal(0.02) weights from
    ``np.random.default_rng(seed)`` in the same order, zero biases, unit
    LayerNorms → the stacked-layer tree of float32 numpy arrays, equal to
    the JAX ``init_params`` array for array (ModernBERT:
    ``modernbert.init_modernbert_params``)."""
    if cfg.arch == "modernbert":
        from .modernbert import init_modernbert_params

        return init_modernbert_params(seed, cfg)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    E = cfg.embedding_size or D
    rng = np.random.default_rng(seed)

    def nrm(shape):
        return rng.standard_normal(shape, np.float32) * 0.02

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    emb = {"word": nrm((cfg.vocab_size, E)),
           "position": nrm((cfg.max_position_embeddings, E)),
           "token_type": nrm((max(cfg.type_vocab_size, 1), E)),
           "ln_scale": ones(E), "ln_bias": zeros(E)}
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
    if E != D:
        emb["proj_w"] = nrm((E, D))
        if cfg.arch != "deberta":          # DeBERTa's embed_proj has no bias
            emb["proj_b"] = zeros(D)
    if cfg.relative_attn_buckets:          # MPNet's shared relative bias
        emb["rel_bias"] = nrm((cfg.relative_attn_buckets, cfg.num_heads))
    if cfg.rel_att_span:                   # DeBERTa's shared relative table
        emb["rel_emb"] = nrm((2 * cfg.rel_att_span, D))
        if cfg.rel_norm:
            emb["rel_ln_scale"] = ones(D)
            emb["rel_ln_bias"] = zeros(D)
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
    """A local checkpoint's ``config.json`` → ``EncoderConfig``, family by
    ``model_type`` as the JAX package reads it."""
    cfg = json.loads((Path(path) / "config.json").read_text())
    model_type = cfg.get("model_type") or ""
    dims = {}
    if "distilbert" not in model_type:
        dims = dict(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                    num_layers=cfg["num_hidden_layers"],
                    num_heads=cfg["num_attention_heads"],
                    intermediate_size=cfg["intermediate_size"])
    if "modernbert" in model_type:
        return EncoderConfig(
            **dims, max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            type_vocab_size=0, layer_norm_eps=cfg.get("norm_eps", 1e-5),
            pad_token_id=cfg.get("pad_token_id", 0), arch="modernbert",
            global_attn_every_n_layers=cfg.get("global_attn_every_n_layers", 3),
            local_attention=cfg.get("local_attention", 128),
            global_rope_theta=cfg.get("global_rope_theta", 160000.0),
            local_rope_theta=cfg.get("local_rope_theta", 10000.0))
    if model_type in ("roberta", "xlm-roberta", "camembert"):
        return EncoderConfig(
            **dims, max_position_embeddings=cfg.get("max_position_embeddings", 514),
            type_vocab_size=cfg.get("type_vocab_size", 1),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            pad_token_id=cfg.get("pad_token_id", 1), arch="roberta")
    if model_type == "mpnet":
        return EncoderConfig(
            **dims, max_position_embeddings=cfg.get("max_position_embeddings", 514),
            type_vocab_size=0, layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            pad_token_id=cfg.get("pad_token_id", 1), arch="mpnet",
            relative_attn_buckets=cfg.get("relative_attention_num_buckets", 32),
            pooling=cfg.get("ac_pooling", "cls"))
    if model_type == "deberta-v2":
        # DeBERTa-v2 and v3 (v3 ships model_type "deberta-v2"); v1 is not read
        if (cfg.get("conv_kernel_size") or 0) > 0:
            raise ValueError(
                "DeBERTa-v2 checkpoints with a ConvLayer (conv_kernel_size>0, e.g. "
                "deberta-v2-xlarge) are not supported; the v3 family (conv-free) is")
        if cfg.get("relative_attention") and not cfg.get("share_att_key", False):
            raise ValueError("DeBERTa relative attention without share_att_key is not "
                             "supported (all published v2/v3 configs share the key)")
        max_rel = cfg.get("max_relative_positions", -1)
        if max_rel is None or max_rel < 1:
            max_rel = cfg.get("max_position_embeddings", 512)
        buckets = cfg.get("position_buckets") or 0
        span = (buckets if buckets > 0 else max_rel) if cfg.get("relative_attention") else 0
        pos_att = cfg.get("pos_att_type") or []
        if isinstance(pos_att, str):
            pos_att = [x.strip() for x in pos_att.lower().split("|") if x.strip()]
        hid = cfg["hidden_size"]
        emb_size = cfg.get("embedding_size", hid) or hid
        return EncoderConfig(
            **dims, max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 0),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-7),
            pad_token_id=cfg.get("pad_token_id", 0), arch="deberta",
            embedding_size=emb_size if emb_size != hid else 0,
            rel_att_span=span, rel_att_buckets=max(buckets, 0), rel_att_max_pos=max_rel,
            rel_pos_att="|".join(pos_att),
            rel_norm="layer_norm" in str(cfg.get("norm_rel_ebd", "none")).lower(),
            position_biased_input=cfg.get("position_biased_input", True),
            pooling=cfg.get("ac_pooling", "cls"))
    if model_type == "electra":
        hid = cfg["hidden_size"]
        emb_size = cfg.get("embedding_size", hid)
        return EncoderConfig(
            **dims, max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            pad_token_id=cfg.get("pad_token_id", 0), arch="electra",
            embedding_size=emb_size if emb_size != hid else 0,
            pooling=cfg.get("ac_pooling", "cls"))
    if "distilbert" in model_type:
        return EncoderConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["dim"], num_layers=cfg["n_layers"],
            num_heads=cfg["n_heads"], intermediate_size=cfg["hidden_dim"],
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=0, layer_norm_eps=1e-12,
            pad_token_id=cfg.get("pad_token_id", 0), arch="distilbert")
    return EncoderConfig(
        **dims, max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=cfg.get("pad_token_id", 0), arch="bert",
        pooling=cfg.get("ac_pooling", "cls"), pool_layer=cfg.get("ac_pool_layer", 0))


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """A checkpoint's tensors as numpy: ``model.safetensors``, else
    ``pytorch_model.bin`` (``torch.load(weights_only=True)``)."""
    st = Path(path) / "model.safetensors"
    if st.exists():
        return io_safetensors.load_file(st)
    pt = Path(path) / "pytorch_model.bin"
    if pt.exists():
        sd = torch.load(str(pt), map_location="cpu", weights_only=True)
        return {k: (v.float() if v.is_floating_point() else v).numpy()
                for k, v in sd.items()}
    raise FileNotFoundError(f"No model.safetensors or pytorch_model.bin in {path}")


#: HF per-layer module names by family
_LAYER_NAMES = {
    "bert": {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
             "ffn_out": "output.dense", "ffn_ln": "output.LayerNorm"},
    "distilbert": {"q": "attention.q_lin", "k": "attention.k_lin", "v": "attention.v_lin",
                   "o": "attention.out_lin", "attn_ln": "sa_layer_norm",
                   "ffn_in": "ffn.lin1", "ffn_out": "ffn.lin2",
                   "ffn_ln": "output_layer_norm"},
    "mpnet": {"q": "attention.attn.q", "k": "attention.attn.k", "v": "attention.attn.v",
              "o": "attention.attn.o", "attn_ln": "attention.LayerNorm",
              "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
              "ffn_ln": "output.LayerNorm"},
    "deberta": {"q": "attention.self.query_proj", "k": "attention.self.key_proj",
                "v": "attention.self.value_proj", "o": "attention.output.dense",
                "attn_ln": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
                "ffn_out": "output.dense", "ffn_ln": "output.LayerNorm"},
}
_MODEL_PREFIXES = ("bert.", "distilbert.", "roberta.", "electra.", "mpnet.", "deberta.", "")


def _map_hf_weights(sd: Dict[str, np.ndarray], cfg: EncoderConfig) -> Tree:
    """Map a HF checkpoint's tensor names into the JAX package's
    stacked-layer tree (float32 numpy, weights ``[in, out]``)."""
    if cfg.arch == "modernbert":
        from .modernbert import map_modernbert_weights

        return map_modernbert_weights(sd, cfg)

    def get(name: str) -> np.ndarray:
        for p in _MODEL_PREFIXES:
            if p + name in sd:
                return np.asarray(sd[p + name], np.float32)
        raise KeyError(name)

    D = cfg.hidden_size
    E = cfg.embedding_size or D
    emb = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": (get("embeddings.position_embeddings.weight")
                     if cfg.arch != "deberta" or cfg.position_biased_input
                     else np.zeros((1, E), np.float32)),
        "token_type": (get("embeddings.token_type_embeddings.weight")
                       if cfg.type_vocab_size > 0 else np.zeros((1, E), np.float32)),
        "ln_scale": get("embeddings.LayerNorm.weight"),
        "ln_bias": get("embeddings.LayerNorm.bias"),
    }
    if E != D:
        if cfg.arch == "deberta":           # bias-free embed_proj
            emb["proj_w"] = get("embeddings.embed_proj.weight").T
        else:                               # ELECTRA's embeddings_project
            emb["proj_w"] = get("embeddings_project.weight").T
            emb["proj_b"] = get("embeddings_project.bias")
    if cfg.relative_attn_buckets:
        emb["rel_bias"] = get("encoder.relative_attention_bias.weight")
    if cfg.rel_att_span:
        emb["rel_emb"] = get("encoder.rel_embeddings.weight")
        if cfg.rel_norm:
            emb["rel_ln_scale"] = get("encoder.LayerNorm.weight")
            emb["rel_ln_bias"] = get("encoder.LayerNorm.bias")
    names = _LAYER_NAMES.get(cfg.arch, _LAYER_NAMES["bert"])
    layer_fmt = ("transformer.layer.{i}.{n}" if cfg.arch == "distilbert"
                 else "encoder.layer.{i}.{n}")

    def stack(n: str, suffix: str, transpose: bool = False) -> np.ndarray:
        rows = [get(layer_fmt.format(i=i, n=names[n]) + "." + suffix)
                for i in range(cfg.num_layers)]
        return np.stack([r.T for r in rows] if transpose else rows)

    layers: Dict[str, np.ndarray] = {}
    # torch Linear stores [out, in]; transpose to [in, out] for x @ W
    for key in ("q", "k", "v", "o"):
        layers[f"{key}_w"] = stack(key, "weight", transpose=True)
        layers[f"{key}_b"] = stack(key, "bias")
    layers["attn_ln_scale"] = stack("attn_ln", "weight")
    layers["attn_ln_bias"] = stack("attn_ln", "bias")
    for key in ("ffn_in", "ffn_out"):
        layers[f"{key}_w"] = stack(key, "weight", transpose=True)
        layers[f"{key}_b"] = stack(key, "bias")
    layers["ffn_ln_scale"] = stack("ffn_ln", "weight")
    layers["ffn_ln_bias"] = stack("ffn_ln", "bias")
    return {"embeddings": emb, "layers": layers}


#: per-layer tensors of the port's state dict, as matrices (cast to the
#: compute dtype on the device) or f32 vectors; ModernBERT's in
#: ``modernbert.MATRICES`` / ``VECTORS``
_MATRICES = ("qkv_w", "o_w", "ffn_in_w", "ffn_out_w")
_VECTORS = ("qkv_b", "o_b", "attn_ln_scale", "attn_ln_bias",
            "ffn_in_b", "ffn_out_b", "ffn_ln_scale", "ffn_ln_bias")


def params_from_tree(tree: Tree, device: Union[str, torch.device] = "cpu",
                     matrix_dtype: torch.dtype = torch.float32) -> Params:
    """The JAX package's stacked-layer tree → the port's flat state dict.

    Names: ``embeddings.{name}`` and ``layers.{i}.{name}`` for ``name`` in
    ``_MATRICES + _VECTORS``, with Q, K and V concatenated into the fused
    ``[D, 3D]`` projection (ModernBERT: its own layer names and
    ``final_ln_scale``).  Matrices are stored in ``matrix_dtype``; everything
    else stays float32.
    """
    def t(a, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)

    lay = tree["layers"]
    if "wqkv" in lay:
        from .modernbert import MATRICES as matrices

        per_layer = dict(lay)
        extra = {"final_ln_scale": t(tree["final_ln_scale"])}
    else:
        matrices = _MATRICES
        per_layer = {"qkv_w": np.concatenate([lay["q_w"], lay["k_w"], lay["v_w"]], axis=2),
                     "qkv_b": np.concatenate([lay["q_b"], lay["k_b"], lay["v_b"]], axis=1),
                     **{n: lay[n] for n in _MATRICES + _VECTORS
                        if n not in ("qkv_w", "qkv_b")}}
        extra = {}
    params: Params = {f"embeddings.{k}": t(v) for k, v in tree["embeddings"].items()}
    for i in range(next(iter(per_layer.values())).shape[0]):
        for n, arr in per_layer.items():
            params[f"layers.{i}.{n}"] = t(arr[i], matrix_dtype if n in matrices
                                          else torch.float32)
    params.update(extra)
    return params


def tree_from_params(params: Params) -> Tree:
    """The inverse of ``params_from_tree``: the port's flat state dict (on
    any device, any dtype) → the JAX package's stacked-layer tree of float32
    numpy arrays, the fused QKV projection split back into Q, K and V."""
    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    emb = {k.split(".", 1)[1]: a(v) for k, v in params.items()
           if k.startswith("embeddings.")}
    n_layers = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("layers."))
    names = sorted({k.split(".", 2)[2] for k in params if k.startswith("layers.")})
    stacked = {n: np.stack([a(params[f"layers.{i}.{n}"]) for i in range(n_layers)])
               for n in names}
    tree: Tree = {"embeddings": emb}
    if "wqkv" in stacked:
        tree["layers"] = stacked
        tree["final_ln_scale"] = a(params["final_ln_scale"])
        return tree
    D = stacked["qkv_w"].shape[2] // 3
    layers = {n: v for n, v in stacked.items() if n not in ("qkv_w", "qkv_b")}
    for j, key in enumerate(("q", "k", "v")):
        layers[f"{key}_w"] = np.ascontiguousarray(stacked["qkv_w"][:, :, j * D:(j + 1) * D])
        layers[f"{key}_b"] = np.ascontiguousarray(stacked["qkv_b"][:, j * D:(j + 1) * D])
    tree["layers"] = layers
    return tree


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def _mm_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2d @ w`` in float32: the exact products of the operands' values
    summed in f32, never rounded to the operands' type.  On CUDA a bf16
    product takes ``torch.mm(..., out_dtype=torch.float32)``; elsewhere the
    operands are upcast (a product of two bf16 values is exact in f32)."""
    if x2d.device.type == "cuda" and x2d.dtype != torch.float32:
        return torch.mm(x2d, w, out_dtype=torch.float32)
    return torch.mm(x2d.float(), w.float())


class _ProductF32(torch.autograd.Function):
    """``_mm_f32`` with a backward, for CUDA, where ``torch.mm(...,
    out_dtype=...)`` has no derivative.  The backward is the JAX package's
    transpose of ``einsum(..., preferred_element_type=float32)``: the f32
    cotangent times the other operand (its values exact in f32), summed in
    f32, each gradient rounded once to its operand's type.  (The cotangent
    split into three bf16 terms for the tensor cores measured no faster at
    ac-base-v2's width on an H100: the split's elementwise passes cost what
    the products saved; PERF.md.)"""

    @staticmethod
    def forward(ctx, x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x2d, w)
        return _mm_f32(x2d, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2d, w = ctx.saved_tensors
        g = g.float()
        gx = torch.mm(g, w.float().t()).to(x2d.dtype) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x2d.float().t(), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def _product_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_mm_f32``, differentiable: a CUDA bf16 product that autograd
    records goes through ``_ProductF32``; every other call is the plain
    product (the CPU's upcast is differentiable as it stands)."""
    if (x2d.device.type == "cuda" and x2d.dtype != torch.float32
            and torch.is_grad_enabled() and (x2d.requires_grad or w.requires_grad)):
        return _ProductF32.apply(x2d, w)
    return _mm_f32(x2d, w)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [.., K] @ w [K, N]`` → f32 ``[.., N]`` (``_product_f32``), the
    weight cast to ``x``'s type."""
    y = _product_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` → f32, the product on compute-dtype operands with f32
    sums and an f32 result, then the f32 bias: the caller's cast to the
    compute dtype is the one rounding, as in the JAX package's
    ``einsum(..., preferred_element_type=float32) + b`` (its
    ``models/encoder.py:454-456, 514-515, 523-527``)."""
    return _matmul_f32(x, w) + b.float()


def _linear_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FFN's first projection: exact (erf) GELU of ``_linear`` → f32."""
    return F.gelu(_linear(x, w, b), approximate="none")


def _check_positions(S: int, cfg: EncoderConfig):
    """Raise past the position table (the JAX package's gather clamps there
    and reuses its last row).  RoBERTa and MPNet number real tokens from
    ``pad_token_id + 1``; DeBERTa without absolute positions has no table."""
    if cfg.arch == "deberta" and not cfg.position_biased_input:
        return
    last = S - 1 + (cfg.pad_token_id + 1 if cfg.arch in ("roberta", "mpnet") else 0)
    if last >= cfg.max_position_embeddings:
        raise ValueError(f"S={S} tokens need position row {last}, past "
                         f"max_position_embeddings={cfg.max_position_embeddings}: "
                         f"the position table has no row for them")


def embed_tokens(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 cfg: EncoderConfig, compute_dtype: torch.dtype) -> torch.Tensor:
    """The embeddings and their LayerNorm, in f32, → ``[B, S, D]`` in
    ``compute_dtype``, family by family as the JAX package's forward forms
    them (its ``models/encoder.py:350-381``):

    - DeBERTa: word (+ absolute positions if ``position_biased_input``)
      (+ token type 0), the bias-free projection, LayerNorm, pad rows zeroed;
    - RoBERTa and MPNet: positions ``cumsum(ids != pad) * (ids != pad) +
      pad``;
    - ELECTRA: LayerNorm at the table's width, then the projection to D.
    """
    S = input_ids.shape[1]
    _check_positions(S, cfg)
    ids = input_ids.long()

    def emb(name: str) -> torch.Tensor:
        return params[f"embeddings.{name}"]

    # index_select: the same rows as ``table[ids]``, with a scatter-add
    # backward (advanced indexing's sorts the indices, ~20 ms a training
    # step at V 30,000 on an H100)
    h = emb("word").index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)
    if cfg.arch == "deberta":
        if cfg.position_biased_input:
            h = h + emb("position")[:S][None, :, :]
        if cfg.type_vocab_size > 0:
            h = h + emb("token_type")[0][None, None, :]
        if "embeddings.proj_w" in params:
            h = h @ emb("proj_w")
        h = add_layer_norm_ref(h, None, emb("ln_scale"), emb("ln_bias"), cfg.layer_norm_eps)
        h = h * attention_mask[:, :, None].to(h.dtype)
        return h.to(compute_dtype)
    if cfg.arch in ("roberta", "mpnet"):
        pad = cfg.pad_token_id
        real = (ids != pad).long()
        h = h + emb("position")[torch.cumsum(real, dim=1) * real + pad]
    else:
        h = h + emb("position")[:S][None, :, :]
    if cfg.type_vocab_size > 0:
        h = h + emb("token_type")[0][None, None, :]
    h = add_layer_norm_ref(h, None, emb("ln_scale"), emb("ln_bias"), cfg.layer_norm_eps)
    if "embeddings.proj_w" in params:
        h = h @ emb("proj_w") + emb("proj_b")
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

#: families whose attention is ``relative_attention`` (MPNet, DeBERTa) or
#: ModernBERT's own, on every device and whatever ``attn_impl`` asks
OWN_ATTENTION_ARCHS = ("mpnet", "deberta", "modernbert")


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


def relative_attention(qkv: torch.Tensor, attention_mask: torch.Tensor, H: int, Dh: int,
                       scale: float, biases: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """MPNet's and DeBERTa's attention, plain torch on every device, as the
    JAX package computes it in ``jnp``: f32 scores ``q·k · scale``, plus
    each additive score bias in turn (``[B|1, H, S, S]`` f32), plus the pad
    mask; f32 softmax; probabilities rounded to qkv's type; f32 PV →
    ``[B, S, D]`` in qkv's type."""
    B, S, _ = qkv.shape
    D = H * Dh
    q, k, v = (qkv[..., j * D:(j + 1) * D].reshape(B, S, H, Dh).float() for j in range(3))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    for bias in biases:
        logits = logits + bias
    logits = logits + torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG).to(logits)
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D).to(qkv.dtype)


def _relative_position_buckets(S: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """MPNet/T5 bidirectional relative-position bucket matrix ``[S, S]``
    (HF ``MPNetModel.relative_position_bucket``: the sign takes half the
    buckets, exact buckets up to max_exact, log-spaced beyond); the JAX
    package's helper element for element."""
    ctx = np.arange(S)[:, None]
    mem = np.arange(S)[None, :]
    n = -(mem - ctx)
    half = num_buckets // 2
    ret = (n < 0).astype(np.int64) * half
    n = np.abs(n)
    max_exact = half // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact) * (half - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, half - 1)
    return ret + np.where(is_small, n, large)


def _deberta_rel_positions(S: int, bucket_size: int, max_position: int) -> np.ndarray:
    """DeBERTa-v2 (log-bucketed) relative position matrix ``[S, S]``:
    ``rel[i, j] = bucket(i - j)``, exact inside ±bucket_size/2, then
    log-spaced with the sign kept (HF ``make_log_bucket_position``, float32
    math for torch's ceil boundaries); the JAX package's helper element for
    element."""
    q = np.arange(S, dtype=np.int64)
    rel = q[:, None] - q[None, :]
    if bucket_size > 0 and max_position > 0:
        sign = np.sign(rel).astype(np.float32)
        mid = bucket_size // 2
        abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
        log_pos = np.ceil(
            np.log(abs_pos.astype(np.float32) / mid)
            / np.log(np.float32((max_position - 1) / mid)) * (mid - 1)
        ).astype(np.float32) + mid
        rel = np.where(abs_pos <= mid, rel, (log_pos * sign).astype(np.int64))
    return rel


#: a layer's attention in the post-LN stack: (qkv, mask, layer params) → ctx
LayerAttention = Callable[[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]],
                          torch.Tensor]


def _mpnet_attention(params: Params, cfg: EncoderConfig, S: int) -> LayerAttention:
    """MPNet: the bucketed bias ``rel_bias[bucket(i, j)]`` → ``[1, H, S,
    S]``, computed once and added in every layer."""
    H, Dh = cfg.num_heads, cfg.head_dim
    table = params["embeddings.rel_bias"]
    buckets = torch.from_numpy(_relative_position_buckets(
        S, cfg.relative_attn_buckets, cfg.relative_attn_max_distance)).to(table.device)
    bias = table[buckets].permute(2, 0, 1)[None].float()
    return lambda qkv, mask, p: relative_attention(qkv, mask, H, Dh, 1.0 / math.sqrt(Dh),
                                                   (bias,))


def _deberta_attention(params: Params, cfg: EncoderConfig, S: int,
                       compute_dtype: torch.dtype) -> LayerAttention:
    """DeBERTa's disentangled attention: the shared relative table (its
    LayerNorm, in the compute dtype) projected by each layer's own query and
    key weights (``share_att_key``); content-to-position scores
    ``q_i · pos_k[c2p(i, j)]`` and position-to-content scores ``k_j ·
    pos_q[p2c(j, i)]``, both scaled like the content scores by
    ``1/sqrt(Dh · (1 + n_pos))`` (HF ``DisentangledSelfAttention``, the JAX
    package's ``models/encoder.py:406-422, 481-507``).  Only the table rows
    the ``[S, S]`` index maps reach are projected and multiplied: each score
    is the same product."""
    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    terms = [t for t in cfg.rel_pos_att.split("|") if t] if cfg.rel_att_span else []
    scale = 1.0 / math.sqrt(Dh * (1 + len(terms)))
    if not cfg.rel_att_span:
        return lambda qkv, mask, p: relative_attention(qkv, mask, H, Dh, scale)
    K = cfg.rel_att_span
    rel = _deberta_rel_positions(S, cfg.rel_att_buckets, cfg.rel_att_max_pos)
    table = params["embeddings.rel_emb"]
    if cfg.rel_norm:
        table = add_layer_norm_ref(table, None, params["embeddings.rel_ln_scale"],
                                   params["embeddings.rel_ln_bias"], cfg.layer_norm_eps)
    table = table.to(compute_dtype)
    cd = compute_dtype

    def index_map(idx: np.ndarray):
        lo, hi = int(idx.min()), int(idx.max())
        return lo, hi, torch.from_numpy(idx - lo).to(table.device)

    # c2p[i, j] reads row clamp(rel[i, j] + K); p2c[j, i] reads clamp(-rel[j, i] + K)
    c2p = index_map(np.clip(rel + K, 0, 2 * K - 1))
    p2c = index_map(np.clip(-rel + K, 0, 2 * K - 1))

    def scores(x, rows, w, b, idx):
        """``x [B, S, H, Dh]`` against the projected rows → ``[B, H, S, S]``
        f32 gathered through the index map."""
        lo, hi, local = idx
        pos = (_matmul_f32(rows[lo:hi + 1], w).to(cd) + b.to(cd)).reshape(-1, H, Dh)
        full = torch.einsum("bshd,khd->bhsk", x.float(), pos.float())
        return torch.gather(full, -1, local.expand(*full.shape[:3], S))

    def attend(qkv, mask, p):
        B = qkv.shape[0]
        q, k = (qkv[..., j * D:(j + 1) * D].reshape(B, S, H, Dh) for j in range(2))
        w, b = p["qkv_w"], p["qkv_b"]
        biases = []
        if "c2p" in cfg.rel_pos_att:
            biases.append(scores(q, table, w[:, D:2 * D].contiguous(), b[D:2 * D],
                                 c2p) * scale)
        if "p2c" in cfg.rel_pos_att:
            # gathered [j, i] → score [i, j]
            biases.append(scores(k, table, w[:, :D].contiguous(), b[:D],
                                 p2c).transpose(-1, -2) * scale)
        return relative_attention(qkv, mask, H, Dh, scale, biases)

    return attend


def layer_attention(params: Params, cfg: EncoderConfig, S: int, attn_impl: str,
                    compute_dtype: torch.dtype) -> LayerAttention:
    """The attention every layer of this forward runs: MPNet's and DeBERTa's
    ``relative_attention``, else ``attention_fn(attn_impl)``."""
    if cfg.relative_attn_buckets:
        return _mpnet_attention(params, cfg, S)
    if cfg.arch == "deberta":
        return _deberta_attention(params, cfg, S, compute_dtype)
    attend = attention_fn(attn_impl)
    return lambda qkv, mask, p: attend(qkv, mask, cfg.num_heads, cfg.head_dim)


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

    ``attn_impl``: one of ``ATTN_IMPLS`` (``attention_fn``); MPNet, DeBERTa
    and ModernBERT run their own attention whatever it names.
    ``use_fused_ln``: the two residual LayerNorms of each layer through
    ``ops.layernorm.add_layer_norm`` (kernel B10 on a GPU); ``None`` follows
    ``_FUSED_LN_ON_CUDA`` on a CUDA device and is off elsewhere.
    """
    if cfg.arch == "modernbert":
        from .modernbert import modernbert_forward

        return modernbert_forward(params, input_ids, attention_mask, cfg, compute_dtype)
    if use_fused_ln is None:
        use_fused_ln = _FUSED_LN_ON_CUDA and input_ids.device.type == "cuda"
    add_ln = add_layer_norm if use_fused_ln else add_layer_norm_ref
    h = embed_tokens(params, input_ids, attention_mask, cfg, compute_dtype)
    attend = layer_attention(params, cfg, input_ids.shape[1], attn_impl, compute_dtype)
    eps = cfg.layer_norm_eps
    for i in range(_n_layers(cfg)):
        p = {n: params[f"layers.{i}.{n}"] for n in _MATRICES + _VECTORS}
        x = h
        qkv = _linear(x, p["qkv_w"], p["qkv_b"]).to(compute_dtype)
        ctx = attend(qkv, attention_mask, p).to(compute_dtype)
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


def attention_policy(cfg: EncoderConfig, device: torch.device, seq_len: int,
                     attn_impl: Optional[str] = None) -> str:
    """The attention path of a forward at ``seq_len`` tokens: ``"einsum"``
    for the families with their own attention (``OWN_ATTENTION_ARCHS``;
    their forward ignores it), else ``attn_impl`` if given, else
    ``AC_ATTN_IMPL`` if set (the JAX package's override), else plain
    torch on the CPU; on the GPU the flash kernel (B6) from 1,024 tokens
    and the packed-QKV kernel (B1) below, inside its envelope (head_dim
    <= 128, head_dim % 8 == 0, S % 8 == 0).  Outside it the plain
    attention runs, as the JAX package's plain ``jnp`` path does there."""
    if cfg.arch in OWN_ATTENTION_ARCHS:
        return "einsum"
    if attn_impl is not None:
        return attn_impl
    forced = os.environ.get("AC_ATTN_IMPL")
    if forced:
        return forced
    if torch.device(device).type == "cpu":
        return "einsum"
    if seq_len >= 1024:
        return "flash"
    dh = cfg.head_dim
    if dh > 128 or dh % 8 or seq_len % 8:
        return "einsum"
    return "fusedqkv"


def resolve_quantization(quantization: Optional[str],
                         device: torch.device) -> Optional[str]:
    """The forward ``quantization`` runs on ``device``: ``"int8"``, or
    ``None`` (float), with ``"auto"`` resolved for the device.  Any other
    value runs the float forward, as the JAX package's encoder does (it
    tests only for ``"int8"``)."""
    if quantization == "auto":
        return "int8" if _AUTO_INT8_ON_CUDA and device.type == "cuda" else None
    return "int8" if quantization == "int8" else None


def int8_arch(cfg: EncoderConfig) -> bool:
    """Whether the int8 forward runs this family: BERT, DistilBERT, RoBERTa
    and ELECTRA without an embedding projection (structurally BERT)."""
    return (cfg.arch in ("bert", "distilbert", "roberta")
            or (cfg.arch == "electra" and not cfg.embedding_size))


def check_int8_arch(cfg: EncoderConfig, quantization: Optional[str]) -> Optional[str]:
    """The quantization an encoder of ``cfg`` runs, by the JAX package's
    rule (its ``models/encoder.py:887-898``): ``"int8"`` for a family the
    int8 forward takes (``int8_arch``); for MPNet, DeBERTa, ModernBERT and
    projected ELECTRA a logged warning and ``None``, the float forward."""
    if quantization == "int8" and not int8_arch(cfg):
        logger.warning(f"quantization='int8' is not supported for arch "
                       f"'{cfg.arch}'; falling back to the float path")
        return None
    return quantization


def config_from_dict(d: Dict) -> EncoderConfig:
    """An ``EncoderConfig`` from the JAX package's config fields (an int8
    export's ``encoder_config``); unknown fields are ignored."""
    names = EncoderConfig.__dataclass_fields__
    return EncoderConfig(**{k: v for k, v in d.items() if k in names})


def load_tokenizer(path: Union[str, Path], vocab_size: int):
    """A checkpoint directory's tokenizer, chosen as the JAX package chooses
    it: a non-WordPiece ``tokenizer.json`` (``try_load_hf_tokenizer``), else
    WordPiece from ``vocab.txt``, else the built-in vocabulary of
    ``vocab_size`` tokens."""
    from .hf_tokenizer_adapter import try_load_hf_tokenizer
    from .tokenizer import WordPieceTokenizer

    tok = try_load_hf_tokenizer(str(path))
    if tok is not None:
        return tok
    try:
        return WordPieceTokenizer.from_pretrained(str(path))
    except FileNotFoundError:
        return WordPieceTokenizer.hermetic(vocab_size)


class Encoder:
    """Owns the encoder's weights on the device, its tokenizer, and the
    attention policy.  With ``quantization="int8"`` (on a family the int8
    forward takes) the weights are the int8 state
    (``quantization.quantize_encoder_for_inference``) and ``embed_ids``
    runs the int8 forward (``encoder_int8``)."""

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
            self.tokenizer = load_tokenizer(ckpt, self.config.vocab_size)
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
        self.quantization = check_int8_arch(self.config, self.quantization)
        tree = self._read_tree()
        if self.quantization == "int8":
            from ..quantization import quantize_encoder_for_inference

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
        # a value other than None, "int8" and "auto" is kept as given (the
        # JAX package keeps it too); the forward tests for "int8" only
        self.quantization = (resolve_quantization(quantization, self.device)
                             if quantization in (None, "int8", "auto") else quantization)
        #: forces the attention path (one of ``ATTN_IMPLS``; it wins over
        #: ``AC_ATTN_IMPL``); None = policy
        self.attn_impl: Optional[str] = None
        #: whether the weights are a training run's (``adopt_trained``) or
        #: an embedded fine-tuned checkpoint's, not the base model's
        self._finetuned = False

    def _on_device(self, params: Params) -> Params:
        """The int8 state on the encoder's device; on a CUDA device with the
        K-contiguous QKV, O and FFN weights that kernels B2, B3 and B8 read,
        made once here, elsewhere without them."""
        from ..ops.ffn_int8 import drop_int8_copies, prepare_int8_weights

        params = {k: v.to(self.device) for k, v in params.items()}
        if self.device.type == "cuda":
            prepare_int8_weights(params)
        else:
            drop_int8_copies(params)
        return params

    @classmethod
    def from_quantized_export(cls, directory: Union[str, Path], model_name: str,
                              compute_dtype: str = "bfloat16",
                              device: Optional[Union[str, torch.device]] = None,
                              quantization: Optional[str] = None) -> "Encoder":
        """The encoder a checkpoint's ``quantized/`` export captured, for a
        machine without the base checkpoint: its config and tokenizer (the
        export's ``tokenizer.json`` or ``vocab.txt``), as the int8 state
        (int8 quantization on a family that takes it) or dequantized float
        weights."""
        from ..quantization import load_quantized_encoder_params
        from .hf_tokenizer_adapter import try_load_hf_tokenizer
        from .tokenizer import WordPieceTokenizer

        directory = Path(directory)
        self = cls.__new__(cls)
        self._setup(compute_dtype, device, quantization)
        self.model_name = model_name
        qcfg = json.loads((directory / "quantize_config.json").read_text())
        if not qcfg.get("encoder_pretrained", False):
            raise ValueError(
                f"the export at {directory} holds a random-weight encoder: build it "
                f"again from its model name and seed")
        self.config = config_from_dict(qcfg["encoder_config"])
        self.quantization = check_int8_arch(self.config, self.quantization)
        self.tokenizer = try_load_hf_tokenizer(str(directory))
        if self.tokenizer is None:
            if not (directory / "vocab.txt").exists():
                # pretrained rows paired with another vocabulary's ids would
                # embed confident nonsense
                raise ValueError(
                    f"int8 export at {directory} has no vocab.txt and no real "
                    f"tokenizer is available: refusing to pair pretrained weights "
                    f"with another vocabulary")
            self.tokenizer = WordPieceTokenizer.from_pretrained(str(directory))
        want = "int8" if self.quantization == "int8" else "float"
        params, _, _ = load_quantized_encoder_params(directory, want=want)
        self._read_tree = lambda: load_quantized_encoder_params(directory)[0]
        if self.quantization == "int8":
            self.params = self._on_device(params)
        else:
            self.params = params_from_tree(params, device=self.device,
                                           matrix_dtype=self.compute_dtype)
        self.pretrained = True
        return self

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size

    def to(self, device: Union[str, torch.device]) -> "Encoder":
        """Move the weights to ``device``; an int8 state gets its
        K-contiguous copies again on a GPU and drops them elsewhere
        (``_on_device``)."""
        self.device = resolve_device(device)
        if self.quantization == "int8":
            self.params = self._on_device(self.params)
        else:
            self.params = {k: v.to(self.device) for k, v in self.params.items()}
        return self

    def float_tree(self) -> Tree:
        """The float32 weights as the JAX package's stacked-layer tree, read
        again from where they came from (the local checkpoint, the offline
        seed, the int8 export, or the float32 masters of the last training
        run, ``adopt_trained``), not from the device copy, whose matrices
        may be bf16 or int8."""
        return self._read_tree()

    def master_params(self) -> Params:
        """Float32 master weights on the encoder's device, every matrix
        included (``float_tree``): what a training run updates, as the JAX
        package trains its float32 params.  An int8 encoder has none."""
        if self.quantization == "int8":
            raise ValueError("an int8 encoder has no float master weights to train")
        return params_from_tree(self.float_tree(), device=self.device,
                                matrix_dtype=torch.float32)

    def adopt_trained(self, params: Params):
        """Take a training run's float32 masters as the encoder's weights:
        they become the source ``float_tree`` reads (so the int8 and HF
        exports write them), the device copy is rebuilt from them in the
        compute dtype, and the encoder is marked fine-tuned."""
        tree = tree_from_params(params)
        self._read_tree = lambda: tree
        self.params = params_from_tree(tree, device=self.device,
                                       matrix_dtype=self.compute_dtype)
        self._finetuned = True

    def _attn_impl(self, seq_len: int) -> str:
        """Attention policy, read on every call: ``self.attn_impl`` if set,
        else ``attention_policy`` for this encoder's family and device."""
        return attention_policy(self.config, self.device, seq_len, self.attn_impl)

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
