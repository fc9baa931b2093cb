"""Prototype scoring, head and fusion, and the lexical channel: the port
against the JAX package on identical inputs (CPU)."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import lexical as jlex
from adaptive_classifier_tpu.models import head as jhead
from adaptive_classifier_tpu.ops import fusion as jfusion
from adaptive_classifier_tpu.ops import knn as jknn
from adaptive_classifier_tpu_torch import lexical as tlex
from adaptive_classifier_tpu_torch.models import head as thead
from adaptive_classifier_tpu_torch.ops import fusion as tfusion
from adaptive_classifier_tpu_torch.ops import knn as tknn

REPO = Path(__file__).resolve().parent.parent
ZOO = REPO / "checkpoints" / "zoo"


def _unit(r, shape):
    x = r.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _scene(seed, B=6, C=16, D=24, n_valid=7, ties=True):
    """Queries, prototypes with invalid slots and (optionally) identical
    prototype rows so similarities tie."""
    r = np.random.default_rng(seed)
    q = _unit(r, (B, D))
    p = _unit(r, (C, D))
    if ties:
        p[3] = p[1]                         # identical prototypes: tied sims
        q[2] = p[1]                         # a query exactly on the tie
    valid = np.zeros(C, bool)
    valid[:n_valid] = True
    bias = (0.3 * r.standard_normal(C)).astype(np.float32)
    return q, p, valid, bias


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_sims_ref(seed):
    q, p, valid, _ = _scene(seed)
    _close(tknn.masked_sims_ref(_t(q), _t(p), _t(valid)),
           jknn.masked_sims_ref(jnp.asarray(q), jnp.asarray(p), jnp.asarray(valid)))
    # below the kernel threshold the dispatcher is the plain computation
    _close(tknn.masked_sims(_t(q), _t(p), _t(valid), pallas_min_classes=4),
           jknn.masked_sims_ref(jnp.asarray(q), jnp.asarray(p), jnp.asarray(valid)))


@pytest.mark.parametrize("with_bias", [False, True])
def test_full_scores(with_bias):
    q, p, valid, bias = _scene(2)
    sims = np.asarray(jknn.masked_sims_ref(jnp.asarray(q), jnp.asarray(p),
                                           jnp.asarray(valid)))
    b = bias if with_bias else None
    _close(tknn.full_scores(_t(sims), _t(valid), None if b is None else _t(b)),
           jknn.full_scores(jnp.asarray(sims), jnp.asarray(valid),
                            None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize("k,n_valid,with_bias", [
    (3, 7, False), (5, 7, True), (10, 7, False),    # k > n_valid
    (4, 0, False), (16, 16, True),
])
def test_topk_scores(k, n_valid, with_bias):
    q, p, valid, bias = _scene(3, n_valid=n_valid)
    sims = np.asarray(jknn.masked_sims_ref(jnp.asarray(q), jnp.asarray(p),
                                           jnp.asarray(valid)))
    b = bias if with_bias else None
    sc, idx = tknn.topk_scores(_t(sims), _t(valid), k, None if b is None else _t(b))
    jsc, jidx = jknn.topk_scores(jnp.asarray(sims), jnp.asarray(valid), k,
                                 None if b is None else jnp.asarray(b))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(sc, jsc)


def test_topk_ties_go_to_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    vals, idx = tknn.top_k_lower_index(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0]]


def _head_sd(r, D, n, hidden=(), skip=False):
    sd, dims, idx = {}, [D, *hidden], 0
    for a, b in zip(dims[:-1], dims[1:]):
        sd[f"model.{idx}.weight"] = r.standard_normal((b, a)).astype(np.float32)
        sd[f"model.{idx}.bias"] = r.standard_normal(b).astype(np.float32)
        idx += 3
    sd[f"model.{idx}.weight"] = r.standard_normal((n, dims[-1])).astype(np.float32)
    sd[f"model.{idx}.bias"] = r.standard_normal(n).astype(np.float32)
    if skip:
        sd["skip.weight"] = r.standard_normal((n, D)).astype(np.float32)
    return sd


@pytest.mark.parametrize("skip", [False, True])
def test_head_forward(skip):
    r = np.random.default_rng(4)
    D, n, cap = 24, 5, 16
    sd = _head_sd(r, D, n, skip=skip)
    x = _unit(r, (6, D))
    jp, jdims = jhead.from_torch_state_dict(sd, cap)
    tp, tdims = thead.from_torch_state_dict(sd, cap)
    assert tdims == jdims == [] and tp["out"]["w"].shape == (D, cap)
    _close(thead.head_forward(tp, _t(x)),
           jhead.head_forward(jp, jnp.asarray(x), train=False), atol=1e-5)


def test_mlp_head_waits_for_its_slice():
    sd = _head_sd(np.random.default_rng(4), 24, 5, hidden=(12, 8))
    with pytest.raises(NotImplementedError, match="MLP"):
        thead.from_torch_state_dict(sd, 16)


def _fusion_inputs(seed, n_classes=7, C=16, ties=True):
    r = np.random.default_rng(seed)
    q, p, valid, bias = _scene(seed, C=C, n_valid=n_classes, ties=ties)
    sd = _head_sd(r, q.shape[1], n_classes)
    if ties:                                  # identical head rows: tied probs
        sd["model.0.weight"][4] = sd["model.0.weight"][2]
        sd["model.0.bias"][4] = sd["model.0.bias"][2]
    active = np.arange(C) < n_classes
    return q, p, valid, bias, sd, active


@pytest.mark.parametrize("k,pw,has_head,with_bias", [
    (3, 0.7, True, False),
    (5, 0.0, True, True),        # head only (a fitted fusion share of 0)
    (10, 0.3, True, True),       # k > n_valid
    (4, 1.0, False, False),      # prototypes only, no head
    (2, 0.5, True, False),
])
def test_fuse_topk_from_emb(k, pw, has_head, with_bias):
    q, p, valid, bias, sd, active = _fusion_inputs(5)
    C = p.shape[0]
    jp, _ = jhead.from_torch_state_dict(sd, C)
    tp, _ = thead.from_torch_state_dict(sd, C)
    b = bias if with_bias else None
    jsc, jid = jfusion.fuse_topk_from_emb(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(valid), jp if has_head else None,
        jnp.asarray(active), pw, 1.0 - pw, k, has_head,
        proto_bias=None if b is None else jnp.asarray(b))
    sc, ids = tfusion.fuse_topk_from_emb(
        _t(q), _t(p), _t(valid), tp if has_head else None, _t(active),
        pw, 1.0 - pw, k, has_head, proto_bias=None if b is None else _t(b))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jid))
    _close(sc, jsc, atol=1e-6)


@pytest.mark.parametrize("k,has_head,with_bias", [(3, True, False), (10, True, True),
                                                  (4, False, False)])
def test_fuse_full(k, has_head, with_bias):
    q, p, valid, bias, sd, active = _fusion_inputs(6)
    C = p.shape[0]
    r = np.random.default_rng(6)
    pw = np.where(r.random(C) < 0.5, 0.3, 0.7).astype(np.float32)
    sims = np.asarray(jknn.masked_sims_ref(jnp.asarray(q), jnp.asarray(p),
                                           jnp.asarray(valid)))
    jp, _ = jhead.from_torch_state_dict(sd, C)
    logits = np.asarray(jhead.head_forward(jp, jnp.asarray(q)))
    b = bias if with_bias else None
    jsc, jid = jfusion.fuse_full(
        jnp.asarray(sims), jnp.asarray(logits), jnp.asarray(valid),
        jnp.asarray(active), jnp.asarray(pw), jnp.asarray(1 - pw), k, has_head,
        proto_bias=None if b is None else jnp.asarray(b))
    sc, ids = tfusion.fuse_full(
        _t(sims), _t(logits), _t(valid), _t(active), _t(pw), _t(1 - pw), k,
        has_head, proto_bias=None if b is None else _t(b))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jid))
    _close(sc, jsc, atol=1e-6)


def _texts():
    data = json.loads((REPO / "data" / "intents.json").read_text())
    texts = [t for rows in data["test"].values() for t in rows][:40]
    return texts + ["", "Crème brûlée — déjà vu!", "a  b\tc\n'quoted' 123"]


@pytest.mark.parametrize("task,grams", [
    ("banking-intents", "char"), ("category", "skel"),
    ("hallucination-detector", "word"), ("llm-router", "wordchar"),
    ("sentiment", "charskel"),
])
def test_lexical_load_and_transform(task, grams):
    path = ZOO / task / "lexical.json"
    jl = jlex.HashedTfidf.load(path)
    tl = tlex.HashedTfidf.load(path)
    assert tl.grams == jl.grams == grams
    assert tl.weight == jl.weight and tl.dim == jl.dim and tl.ready
    np.testing.assert_array_equal(tl.transform(_texts()), jl.transform(_texts()))


def test_lexical_fit_matches_jax():
    texts = _texts()
    for grams in tlex.GRAM_KINDS:
        jl = jlex.HashedTfidf(1024, 1.0, grams).fit(texts[:20])
        tl = tlex.HashedTfidf(1024, 1.0, grams).fit(texts[:20])
        assert tl.to_dict() == jl.to_dict()
        np.testing.assert_array_equal(tl.transform(texts), jl.transform(texts))
