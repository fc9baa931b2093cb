"""Continual learning on the port against the JAX package (CPU, float32):
the default configuration (MLP head, ``fusion_weights: history``, no
lexical channel) built and grown with new classes in both packages, the
typo-augmented head rows, and the lossy-replay guarantees of
``tests/test_lossy_replay.py`` held on the port.

Head init, shuffles and dropout draw from a ``torch.Generator`` in the port
and from ``jax.random`` in the JAX package, so the gradient-fit heads are
held by behaviour (accuracy within 0.05 of the JAX package's); everything
else (labels, prototypes, training history, the balanced resampling and
the rows each fit sees) is held to the JAX package's values."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import adaptive_classifier_tpu.training as jtraining
from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert
from adaptive_classifier_tpu_torch import training as ttraining
from tests.conftest import synthetic_embed

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "checkpoints" / "ac-tiny")
INTENTS = json.loads((REPO / "data" / "intents.json").read_text())
#: the default configuration at test sizes (small buckets, float32)
DEFAULT = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16, 32],
           "example_capacity_buckets": [32, 128], "compute_dtype": "float32",
           "embedding_cache_size": 0}


def rows(block):
    if block in ("train", "new_classes"):
        r = [(t, l) for l, ts in INTENTS[block].items() for t in ts]
    else:
        src = "train" if block == "test_base" else "new_classes"
        r = [(t, l) for l in INTENTS[src] for t in INTENTS["test"][l]]
    return [t for t, _ in r], [l for _, l in r]


def accuracy(clf, block):
    texts, labels = rows(block)
    return float(np.mean([p[0][0] == l for p, l in zip(clf.predict_batch(texts, k=1), labels)]))


def spy(monkeypatch, module, name):
    """Record the keyword and positional arguments of every call."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.fixture(scope="module")
def default_flow():
    """ac-tiny on the default config in both packages: the intents train
    rows, then the three new classes; fit inputs and accuracies recorded."""
    mp = pytest.MonkeyPatch()
    try:
        tcalls = spy(mp, ttraining, "fit_head")
        jcalls = spy(mp, jtraining, "fit_head")
        clf = AdaptiveClassifier(TINY, device="cpu", config=dict(DEFAULT))
        jclf = JaxClassifier(TINY, config=dict(DEFAULT))
        out = {"clf": clf, "jclf": jclf, "tcalls": tcalls, "jcalls": jcalls}
        for step in ("train", "new_classes"):
            texts, labels = rows(step)
            clf.add_examples(texts, labels)
            jclf.add_examples(texts, labels)
            out[step] = {
                "state": (dict(clf.label_to_id), dict(clf.training_history), clf.train_steps),
                "jstate": (dict(jclf.label_to_id), dict(jclf.training_history),
                           jclf.train_steps),
                "proto": clf.memory.state.proto.clone(),
                "jproto": np.asarray(jclf.memory.state.proto).copy(),
                "acc": accuracy(clf, "test_base"), "jacc": accuracy(jclf, "test_base"),
                "epochs": clf.last_fit.epochs_run}
        out["new_acc"], out["jnew_acc"] = accuracy(clf, "test_new"), accuracy(jclf, "test_new")
    finally:
        mp.undo()
    return out


def test_default_config_state_matches_jax(default_flow):
    f = default_flow
    assert f["clf"].config.head_type == "mlp" and f["clf"].lexical is None
    for step in ("train", "new_classes"):
        assert f[step]["state"] == f[step]["jstate"]
        np.testing.assert_allclose(f[step]["proto"].numpy(), f[step]["jproto"], atol=1e-5)
    hidden = f["clf"].head_params["hidden"]
    assert [tuple(h["w"].shape) for h in hidden] == [(128, 128), (128, 64)]
    assert f["clf"].memory.texts == f["jclf"].memory.texts


def test_each_fit_sees_the_jax_rows(default_flow):
    """The first fit's stored rows and the new-class fit's balanced resample
    (``np.random.default_rng(seed + train_steps)``, numpy in both
    packages), its EWC exemplars and distillation; same hyperparameters."""
    f = default_flow
    assert len(f["tcalls"]) == len(f["jcalls"]) == 2
    for (targs, tkw), (jargs, jkw) in zip(f["tcalls"], f["jcalls"]):
        emb, labels, valid = targs[1:4]
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jargs[2]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jargs[3]))
        np.testing.assert_allclose(emb.numpy(), np.asarray(jargs[1]), atol=1e-5)
        np.testing.assert_array_equal(targs[4].numpy(), np.asarray(jargs[4]))
        for key in ("lr", "loss_type", "max_epochs", "patience", "use_scheduler"):
            assert tkw[key] == jkw[key], key
    _, tkw = f["tcalls"][1]
    _, jkw = f["jcalls"][1]
    assert jkw["has_ewc"] and jkw["has_distill"] and not jkw["has_grad_mask"]
    assert tkw["ewc_lambda"] == jkw["ewc_lambda"] == 5.0
    assert tkw["grad_mask"] is None
    np.testing.assert_array_equal(tkw["distill_active"].numpy(),
                                  np.asarray(jkw["distill_active"]))
    assert tkw["distill_logits"].shape == jkw["distill_logits"].shape


def test_default_config_accuracy_in_the_jax_band(default_flow):
    f = default_flow
    for step in ("train", "new_classes"):
        assert abs(f[step]["acc"] - f[step]["jacc"]) <= 0.05, (step, f[step])
        assert 1 <= f[step]["epochs"] <= 15
    assert abs(f["new_acc"] - f["jnew_acc"]) <= 0.05


def test_typo_augmented_rows_match_jax():
    """head_typo_augment on a ridge head (deterministic): the typo'd texts
    embedded and the weighted ridge fit equal the JAX package's."""
    cfg = {**DEFAULT, "head_type": "ridge", "head_typo_augment": True}
    texts, labels = rows("train")
    texts, labels = texts[::7], labels[::7]
    clf = AdaptiveClassifier(TINY, device="cpu", config=dict(cfg))
    jclf = JaxClassifier(TINY, config=dict(cfg))
    seen = {}
    for name, c in (("port", clf), ("jax", jclf)):
        orig, seen[name] = c._get_embeddings, []
        c._get_embeddings = (lambda o, s: lambda t: (s.append(list(t)), o(t))[1])(orig, seen[name])
        c.add_examples(texts, labels)
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 2 and seen["port"][1] != seen["port"][0]
    want = convert.head_params_from_jax(jclf.head_params)
    np.testing.assert_allclose(clf.head_params["out"]["w"].numpy(), want["out"]["w"].numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the lossy-replay guarantees of tests/test_lossy_replay.py, on the port
# ---------------------------------------------------------------------------

CLASSES = ["alpha", "beta", "gamma", "delta"]


def _embed(texts, dim):
    return synthetic_embed(texts, dim=dim, noise=0.05)


def _tiny(**config):
    cfg = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16, 32, 64],
           "example_capacity_buckets": [32, 128], **config}
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu", config=cfg)
    clf._get_embeddings = lambda t: _embed(t, clf.embedding_dim)
    return clf


def _load(path):
    clf = AdaptiveClassifier.load(path, device="cpu")
    clf._get_embeddings = lambda t: _embed(t, clf.embedding_dim)
    return clf


@pytest.fixture
def saved_loaded(tmp_path):
    """4 well-separated classes on 12 rows each, saved and loaded: the
    loaded store keeps 5 rows a class against a training history of 12."""
    clf = _tiny(embedding_cache_size=0)
    clf.add_examples([f"{c}:example {i}" for c in CLASSES for i in range(12)],
                     [c for c in CLASSES for _ in range(12)])
    clf.save(str(tmp_path / "ckpt"))
    return _load(tmp_path / "ckpt")


def test_loaded_prototypes_survive_unrelated_add(saved_loaded):
    clf = saved_loaded
    n = len(clf.label_to_id)
    before = clf.memory.state.proto[:n].clone()
    assert clf.memory.state.pweight[:n].min() >= 12.0
    clf.add_examples(["alpha:fresh row"], ["alpha"])
    drift = torch.linalg.norm(clf.memory.state.proto[:n] - before, dim=1).numpy()
    a = clf.label_to_id["alpha"]
    assert np.all(drift[[i for i in range(n) if i != a]] == 0.0), drift
    assert 0.0 < drift[a] < 0.25


def test_lossy_new_class_keeps_old_head_logits_bit_identical(saved_loaded):
    clf = saved_loaded
    n_old = len(clf.label_to_id)
    probe = torch.from_numpy(_embed([f"{c}:probe" for c in CLASSES], clf.embedding_dim))
    before = clf._head_logits(probe)[:, :n_old].clone()
    clf.add_examples([f"omega:new {i}" for i in range(3)], ["omega"] * 3)
    assert "skip" in clf.head_params and clf.last_fit.epochs_run > 1
    assert torch.equal(clf._head_logits(probe)[:, :n_old], before)


def test_lossy_new_class_preserves_old_predictions_and_learns_new(saved_loaded):
    clf = saved_loaded
    queries = [(f"{c}:query {i}", c) for c in CLASSES for i in range(5)]

    def acc():
        preds = clf.predict_batch([q for q, _ in queries], k=1)
        return np.mean([p and p[0][0] == l for p, (_, l) in zip(preds, queries)])

    assert acc() == 1.0
    clf.add_examples([f"omega:new {i}" for i in range(3)], ["omega"] * 3)
    assert acc() == 1.0
    newq = [f"omega:query {i}" for i in range(4)]
    for preds in (clf.predict_batch(newq, k=1), [clf.predict(q, k=1) for q in newq]):
        assert [p[0][0] for p in preds] == ["omega"] * 4


def test_fresh_classifier_keeps_full_retrain_path():
    clf = _tiny(embedding_cache_size=0)
    clf.add_examples([f"{c}:example {i}" for c in ["alpha", "beta"] for i in range(8)],
                     [c for c in ["alpha", "beta"] for _ in range(8)])
    before = clf.head_params
    clf.add_examples([f"omega:row {i}" for i in range(3)], ["omega"] * 3)
    moved = (clf.head_params["out"]["w"][:, :2] - before["out"]["w"][:, :2]).abs().max()
    assert moved > 0.0
    assert "skip" not in clf.head_params


def test_skip_probe_roundtrips_through_checkpoint(saved_loaded, tmp_path):
    clf = saved_loaded
    clf.add_examples([f"omega:new {i}" for i in range(3)], ["omega"] * 3)
    newq = [f"omega:query {i}" for i in range(3)]
    want = [clf.predict(q, k=1)[0][0] for q in newq]
    clf.save(str(tmp_path / "ckpt2"))
    again = _load(tmp_path / "ckpt2")
    assert "skip" in again.head_params
    assert [again.predict(q, k=1)[0][0] for q in newq] == want
