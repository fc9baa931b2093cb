"""Shared pieces of the encoder-training tests (``test_torch_finetune.py``,
``test_torch_pretrain.py``): tiny encoders in the JAX package's tree form,
a small labelled corpus, the JAX package's masking draws, and the
gradient comparison."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu_torch import pretrain
from adaptive_classifier_tpu_torch.models import encoder as tenc

REPO = Path(__file__).resolve().parent.parent
MASK_ID = 4
N, S, BATCH = 12, 16, 6


def _config(name):
    """(JAX tree, config) of a tiny encoder."""
    if name == "ac-tiny":
        path = REPO / "checkpoints" / "ac-tiny"
        cfg = jenc._read_hf_config(path)
        return jenc._map_hf_weights(jenc._load_state_dict(path), cfg), cfg
    arch = {"bert-2x64": "bert", "distilbert-2x64": "distilbert"}[name]
    cfg = jenc.EncoderConfig(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                             intermediate_size=128, max_position_embeddings=64,
                             type_vocab_size=0 if arch == "distilbert" else 2, arch=arch,
                             pooling="cls")
    return spread(jenc.init_params(1, cfg)), cfg


def spread(tree, seed=0):
    """``init_params``' tree with its matrices redrawn at std
    1/sqrt(fan_in): at std 0.02 every sentence embeds alike, the loss sits
    at its ceiling and its gradient is rounding noise."""
    r = np.random.default_rng(seed)
    layers = {n: (r.standard_normal(a.shape).astype(np.float32) / np.float32(np.sqrt(a.shape[1]))
                  if n.endswith("_w") else np.asarray(a))
              for n, a in tree["layers"].items()}
    return {**tree, "layers": layers}


def _port_cfg(cfg):
    return tenc.config_from_dict(cfg.__dict__)


def _corpus(cfg, seed=3):
    """Three token registers, one a class; ragged lengths."""
    r = np.random.default_rng(seed)
    V = cfg.vocab_size
    ids = np.zeros((N, S), np.int32)
    attn = np.zeros((N, S), np.int32)
    labels = np.arange(N, dtype=np.int32) % 3
    for i in range(N):
        n = int(r.integers(6, S + 1))
        lo, hi = (5 + labels[i] * (V - 5) // 3, 5 + (labels[i] + 1) * (V - 5) // 3)
        ids[i, :n] = r.integers(lo, hi, n)
        ids[i, 0] = 2
        attn[i, :n] = 1
    return ids, attn, labels


def _jax_masking(key, shape, vocab):
    """The draws JAX ``apply_mlm_masking(key, ...)`` makes."""
    k_sel, k_op, k_rand = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k_sel, shape), jax.random.uniform(k_op, shape),
        jax.random.randint(k_rand, shape, 4, vocab)))


def _jax_views(key, shape, vocab):
    """The two views' draws of JAX ``supcon_loss(..., key)``."""
    k1, k2 = jax.random.split(key)
    return [_jax_masking(k1, shape, vocab), _jax_masking(k2, shape, vocab)]


def _views(ids, attn, draws, prob=0.08):
    return [pretrain.masking_from_draws(torch.from_numpy(ids), torch.from_numpy(attn),
                                        MASK_ID, d, mask_prob=prob)[0] for d in draws]


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))


def assert_grads_close(jgrads, tgrads, min_cos=0.999):
    """Every gradient tensor within ``min_cos``; the key bias's, zero in
    exact arithmetic (a constant shift of a query's scores), only small on
    both sides."""
    tree = tenc.tree_from_params(tgrads)
    total = np.sqrt(sum(np.sum(np.square(a)) for s in ("embeddings", "layers")
                        for a in jgrads[s].values()))
    for section in ("embeddings", "layers"):
        for name, want in jgrads[section].items():
            got = tree[section][name]
            if name == "k_b":
                assert max(np.linalg.norm(want), np.linalg.norm(got)) <= 1e-3 * total
                continue
            c = cosine(want, got)
            assert c >= min_cos, (section, name, c)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's tiny tensors: once the JAX
    package has run a program, its CPU client's threads compete with
    torch's pool, and the pool's hand-offs cost ten times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
