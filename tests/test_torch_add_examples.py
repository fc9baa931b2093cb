"""add_examples in both packages on identical inputs (CPU, float32 on both
sides): the port and the JAX package must build the same classifier — the
same labels, resolved lexical knobs, λ, fusion share and recalibration
bias, prototypes and head weights within 1e-4 (float32 sums in another
order), identical top-1 labels and scores within 1e-4 — after a first batch
and after a batch of new classes."""

import json
from pathlib import Path

import numpy as np
import pytest

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.ops import knn_topk as jknn_topk
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "checkpoints" / "ac-tiny")
BASE = str(REPO / "checkpoints" / "ac-base-v2")
INTENTS = json.loads((REPO / "data" / "intents.json").read_text())

#: the zoo's build config (checkpoints/zoo/manifest.json), float32
PRODUCTION = {"lexical_dim": 32768, "head_type": "ridge", "fusion_weights": "auto",
              "ridge_lambda": "auto", "compute_dtype": "float32",
              "embedding_cache_size": 0}


def intents_rows(block):
    """(texts, labels) in the row order of scripts/build_classifier_zoo.py."""
    if block == "train":
        rows = [(t, l) for l, ts in INTENTS["train"].items() for t in ts]
    elif block == "new_classes":
        rows = [(t, l) for l, ts in INTENTS["new_classes"].items() for t in ts]
    elif block == "test_base":
        rows = [(t, l) for l in INTENTS["train"] for t in INTENTS["test"][l]]
    else:   # test rows of the new classes
        rows = [(t, l) for l in INTENTS["new_classes"] for t in INTENTS["test"][l]]
    return [t for t, _ in rows], [l for _, l in rows]


def synthetic_rows(n_classes, per_class, first=0, seed=0):
    """Templated texts, ``per_class`` phrasings per class."""
    r = np.random.default_rng(seed)
    topics = ["billing", "shipping", "returns", "privacy", "hardware",
              "software", "travel", "finance"]
    texts, labels = [], []
    for i in range(first, first + n_classes):
        words = [topics[j] for j in r.integers(0, len(topics), 2)]
        for j in range(per_class):
            texts.append(f"route this {words[0]} case number {i} to the owning "
                         f"specialist team" if j == 0 else
                         f"a {words[1]} question about ticket {i} needs help")
            labels.append(f"class_{i:05d}")
    return texts, labels


def assert_same_state(clf, jclf, atol=1e-4):
    assert clf.label_to_id == jclf.label_to_id
    assert clf.training_history == jclf.training_history
    assert clf.train_steps == jclf.train_steps
    assert clf.config.ridge_lambda == jclf.config.ridge_lambda
    assert clf._fusion_alpha == jclf._fusion_alpha
    if clf.lexical is not None:
        assert (clf.lexical.grams, clf.lexical.weight) == \
            (jclf.lexical.grams, jclf.lexical.weight)
        assert clf.lexical._df == jclf.lexical._df
    if jclf._proto_bias is None:
        assert clf._proto_bias is None
    else:
        np.testing.assert_allclose(clf._proto_bias, jclf._proto_bias, atol=1e-5)
    assert clf.memory.texts == jclf.memory.texts
    want = convert.memory_state_from_jax(jclf.memory.state)
    got = clf.memory.state
    np.testing.assert_array_equal(got.count.numpy(), want.count.numpy())
    np.testing.assert_allclose(got.pweight.numpy(), want.pweight.numpy())
    np.testing.assert_allclose(got.proto.numpy(), want.proto.numpy(), atol=atol)
    np.testing.assert_allclose(got.emb.numpy(), want.emb.numpy(), atol=atol)
    head = convert.head_params_from_jax(jclf.head_params)
    np.testing.assert_allclose(clf.head_params["out"]["w"].numpy(),
                               head["out"]["w"].numpy(), atol=atol)
    np.testing.assert_allclose(clf.head_params["out"]["b"].numpy(),
                               head["out"]["b"].numpy(), atol=atol)


def assert_same_predictions(got, want, atol=1e-4):
    assert [[l for l, _ in row][:1] for row in got] == \
        [[l for l, _ in row][:1] for row in want]
    for g, w in zip(got, want):
        gs = dict(g)
        for label, score in w:
            if label in gs:
                assert abs(gs[label] - score) <= atol


def both(model, config):
    return (AdaptiveClassifier(model, device="cpu", config=dict(config)),
            JaxClassifier(model, config=dict(config)))


@pytest.fixture(scope="module")
def intents_tiny():
    """ac-tiny (BERT, 2 layers, hidden 128) on the production config, after
    the base batch (state copied) and after the new-class batch."""
    clf, jclf = both(TINY, PRODUCTION)
    texts, labels = intents_rows("train")
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    first = {"alpha": clf._fusion_alpha, "jalpha": jclf._fusion_alpha,
             "grams": clf.lexical.grams, "jgrams": jclf.lexical.grams,
             "lam": clf.config.ridge_lambda, "jlam": jclf.config.ridge_lambda,
             "proto": clf.memory.state.proto.clone(),
             "jproto": np.asarray(jclf.memory.state.proto).copy(),
             "w": clf.head_params["out"]["w"].clone(),
             "jw": np.asarray(jclf.head_params["out"]["w"]).copy()}
    texts, labels = intents_rows("new_classes")
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    return clf, jclf, first


def test_first_batch_matches_jax(intents_tiny):
    _, _, first = intents_tiny
    assert (first["grams"], first["lam"], first["alpha"]) == \
        (first["jgrams"], first["jlam"], first["jalpha"])
    np.testing.assert_allclose(first["proto"].numpy(), first["jproto"], atol=1e-4)
    np.testing.assert_allclose(first["w"].numpy(), first["jw"], atol=1e-4)


def test_new_class_batch_matches_jax(intents_tiny):
    clf, jclf, _ = intents_tiny
    assert_same_state(clf, jclf)
    assert clf._proto_bias is not None


@pytest.mark.parametrize("block", ["test_base", "test_new"])
def test_predict_batch_after_add_matches_jax(intents_tiny, block):
    clf, jclf, _ = intents_tiny
    texts, _ = intents_rows(block)
    assert_same_predictions(clf.predict_batch(texts, k=3),
                            jclf.predict_batch(texts, k=3))


def test_predict_and_proba_after_add_match_jax(intents_tiny):
    clf, jclf, _ = intents_tiny
    texts, _ = intents_rows("test_base")
    for text in texts[::40]:
        assert_same_predictions([clf.predict(text, k=4)], [jclf.predict(text, k=4)])
    probs, labels = clf.predict_proba(texts[::10])
    jprobs, jlabels = jclf.predict_proba(texts[::10])
    assert labels == jlabels
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_production_intents_flow_matches_jax():
    """The zoo's encoder (ac-base-v2: BERT, 8 layers, hidden 512) on the
    production config: first batch, new classes, predict_batch."""
    clf, jclf = both(BASE, PRODUCTION)
    for block in ("train", "new_classes"):
        texts, labels = intents_rows(block)
        clf.add_examples(texts, labels)
        jclf.add_examples(texts, labels)
    assert (clf.lexical.grams, clf.lexical.weight, clf.config.ridge_lambda) == \
        (jclf.lexical.grams, jclf.lexical.weight, jclf.config.ridge_lambda)
    assert_same_state(clf, jclf)
    texts, _ = intents_rows("test_base")
    test_new, _ = intents_rows("test_new")
    assert_same_predictions(clf.predict_batch(texts + test_new, k=1),
                            jclf.predict_batch(texts + test_new, k=1))


def _many_class_config(capacity, **extra):
    return {"head_type": "ridge", "ridge_lambda": 1.0, "compute_dtype": "float32",
            "embedding_cache_size": 0, "class_capacity_buckets": [capacity],
            "example_capacity_buckets": [4], "example_capacity_slack": 4,
            "max_examples_per_class": 4, "train_size_buckets": [2048], **extra}


def test_many_classes_above_the_knn_kernel_threshold_match_jax():
    """600 classes, then 8 more: C = 1024 >= pallas_knn_min_classes, the
    branch kernel B4 carries on a GPU (here its plain version)."""
    clf, jclf = both(TINY, _many_class_config(1024))
    for n, first in ((600, 0), (8, 600)):
        texts, labels = synthetic_rows(n, 2, first=first)
        clf.add_examples(texts, labels)
        jclf.add_examples(texts, labels)
    assert clf._class_capacity == 1024
    assert_same_state(clf, jclf)
    queries, _ = synthetic_rows(608, 1, seed=5)
    queries = queries[::7]
    assert_same_predictions(clf.predict_batch(queries, k=2),
                            jclf.predict_batch(queries, k=2))
    probs, _ = clf.predict_proba(queries[:4])
    jprobs, _ = jclf.predict_proba(queries[:4])
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)


def test_fused_topk_branch_matches_jax_kernel():
    """fused_topk_min_classes = 64: the JAX package runs its streaming top-k
    Pallas kernel (interpret mode); the port, on the CPU, runs the
    materialized branch, which must give the same answers."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = _many_class_config(128, fused_topk_min_classes=64)
    clf, jclf = both(TINY, cfg)
    texts, labels = synthetic_rows(70, 2)
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    texts, labels = synthetic_rows(3, 2, first=70)
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    assert_same_state(clf, jclf)
    queries, _ = synthetic_rows(73, 1, seed=3)
    queries = queries[::3]
    jknn_topk.FORCE_FUSED = True
    before = jknn_topk.FUSED_DISPATCHES
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jclf.predict_batch(queries, k=5)
    finally:
        jknn_topk.FORCE_FUSED = False
    assert jknn_topk.FUSED_DISPATCHES > before
    assert_same_predictions(clf.predict_batch(queries, k=5), want)


def test_add_examples_validates_and_raises_for_later_slices():
    clf = AdaptiveClassifier(TINY, device="cpu", config={"head_type": "ridge"})
    with pytest.raises(ValueError):
        clf.add_examples([], [])
    with pytest.raises(ValueError):
        clf.add_examples(["a"], ["x", "y"])
    # MLP heads and typo-augmented heads train (tests/test_torch_continual.py
    # holds them to the JAX package)
    for config in ({"head_type": "mlp"}, {"head_type": "ridge", "head_typo_augment": True}):
        clf = AdaptiveClassifier(TINY, device="cpu", config=config)
        clf.add_examples(["a", "b"], ["x", "y"])
        assert clf.label_to_id == {"x": 0, "y": 1}
        assert len(clf.head_params["hidden"]) == (2 if config["head_type"] == "mlp" else 0)
    # strategic mode constructs and builds the JAX package's classifier
    # (tests/test_torch_strategic.py holds it further)
    config = {"head_type": "ridge", "compute_dtype": "float32", "embedding_cache_size": 0,
              "enable_strategic_mode": True, "cost_function_type": "linear",
              "cost_coefficients": [0.15] * 128}
    clf, jclf = both(TINY, config)
    assert clf.strategic_mode and jclf.strategic_mode
    texts, labels = intents_rows("train")
    clf.add_examples(texts[::4], labels[::4])
    jclf.add_examples(texts[::4], labels[::4])
    assert_same_state(clf, jclf)
    queries, _ = intents_rows("test_base")
    assert_same_predictions(clf.predict_strategic_batch(queries[::5], k=3),
                            jclf.predict_strategic_batch(queries[::5], k=3))
