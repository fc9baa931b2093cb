"""Multi-label classification on the port against the JAX package (CPU,
synthetic embeddings below the encoder): ``tests/test_multilabel.py``'s
cases, then the cross-package ones: the multi-hot BCE fit sees the JAX
package's rows, and with the JAX head's parameters carried across
``predict_multilabel`` gives the JAX package's labels and probabilities
(1e-4).  The head facades at the end."""

import numpy as np
import pytest
import torch

import adaptive_classifier_tpu.training as jtraining
from adaptive_classifier_tpu import MultiLabelAdaptiveClassifier as JaxMultiLabel
from adaptive_classifier_tpu.models import head as jhead
from adaptive_classifier_tpu_torch import (
    AdaptiveHead,
    MultiLabelAdaptiveClassifier,
    MultiLabelAdaptiveHead,
    convert,
)
from adaptive_classifier_tpu_torch import training as ttraining
from tests.conftest import synthetic_embed

CFG = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16, 32],
       "example_capacity_buckets": [32, 128]}


def _synth(cls, **kw):
    extra = {"device": "cpu"} if cls is MultiLabelAdaptiveClassifier else {}
    clf = cls("prajjwal1/bert-tiny", config=dict(CFG), **extra, **kw)
    clf._get_embeddings = lambda texts: synthetic_embed(texts, dim=clf.embedding_dim)
    return clf


@pytest.fixture(scope="module")
def ml_factory():
    return lambda **kw: _synth(MultiLabelAdaptiveClassifier, **kw)


def test_adaptive_threshold_table(ml_factory):
    clf = ml_factory(default_threshold=0.5)
    assert clf._get_adaptive_threshold(2) == 0.5
    assert clf._get_adaptive_threshold(5) == pytest.approx(0.4)
    assert clf._get_adaptive_threshold(10) == pytest.approx(0.3)
    assert clf._get_adaptive_threshold(20) == pytest.approx(0.2)
    assert clf._get_adaptive_threshold(25) == pytest.approx(0.1)


def test_add_and_predict_multilabel(ml_factory):
    clf = ml_factory()
    texts = [f"tech:{i}" for i in range(6)] + [f"sport:{i}" for i in range(6)] \
        + [f"mix:{i}" for i in range(6)]
    labels = [["tech"]] * 6 + [["sport"]] * 6 + [["tech", "sport"]] * 6
    clf.add_examples(texts, labels)
    labels_out = [l for l, _ in clf.predict_multilabel("mix:99")]
    assert set(labels_out) <= {"tech", "sport"}
    assert "tech" in labels_out and "sport" in labels_out


def test_min_predictions_backfill(ml_factory):
    clf = ml_factory(default_threshold=0.99, min_predictions=2)
    clf.add_examples([f"a:{i}" for i in range(5)] + [f"b:{i}" for i in range(5)],
                     [["a"]] * 5 + [["b"]] * 5)
    assert len(clf.predict_multilabel("a:99", threshold=0.999999)) >= 2


def test_max_labels_limit(ml_factory):
    clf = ml_factory()
    clf.add_examples([f"x{j}:{i}" for j in range(4) for i in range(4)],
                     [[f"x{j}"] for j in range(4) for _ in range(4)])
    assert len(clf.predict_multilabel("x0:9", threshold=0.0, max_labels=2)) <= 2


def test_label_thresholds_by_frequency(ml_factory):
    clf = ml_factory(default_threshold=0.5)
    clf.add_examples([f"common:{i}" for i in range(30)] + ["rare:0"],
                     [["common"]] * 30 + [["rare"]])
    assert clf.label_thresholds["common"] == pytest.approx(0.6)
    assert clf.label_thresholds["rare"] == pytest.approx(0.15)


def test_empty_inputs_raise(ml_factory):
    clf = ml_factory()
    with pytest.raises(ValueError):
        clf.add_examples([], [])
    with pytest.raises(ValueError):
        clf.add_examples(["a"], [["x"], ["y"]])
    with pytest.raises(ValueError):
        clf.predict_multilabel("")


def test_texts_without_labels_skipped(ml_factory):
    clf = ml_factory()
    clf.add_examples(["a:1", "skip:1", "b:1"], [["a"], [], ["b"]])
    assert clf.get_memory_stats()["total_examples"] == 2


def test_label_statistics(ml_factory):
    clf = ml_factory(default_threshold=0.4, min_predictions=2, max_predictions=5)
    clf.add_examples(["a:1", "b:1"], [["a"], ["b"]])
    stats = clf.get_label_statistics()
    assert stats["default_threshold"] == 0.4
    assert stats["min_predictions"] == 2
    assert stats["max_predictions"] == 5
    assert "label_thresholds" in stats
    assert "adaptive_threshold" in stats


def test_save_load_multilabel(ml_factory, tmp_path):
    clf = ml_factory()
    clf.add_examples([f"a:{i}" for i in range(5)] + [f"b:{i}" for i in range(5)],
                     [["a"]] * 5 + [["b"]] * 5)
    clf.save(str(tmp_path / "ml"))
    clf2 = MultiLabelAdaptiveClassifier.load(tmp_path / "ml", device="cpu")
    assert isinstance(clf2, MultiLabelAdaptiveClassifier)
    clf2._get_embeddings = lambda texts: synthetic_embed(texts, dim=clf2.embedding_dim)
    assert clf2.label_to_id == clf.label_to_id
    assert len(clf2.predict_multilabel("a:99", threshold=0.0)) >= 1
    # the head round-trips: the same sigmoids of the labels for the same
    # embedding (the checkpoint keeps the label columns only)
    emb = clf._embed_device(["a:99"])
    np.testing.assert_allclose(clf2._head_sigmoid(emb)[:, :2], clf._head_sigmoid(emb)[:, :2],
                               atol=1e-6)


def test_25_label_no_threshold_regression(ml_factory):
    clf = ml_factory(min_predictions=1)
    labels = [f"lab{i:02d}" for i in range(25)]
    clf.add_examples([f"{l}:{j}" for l in labels for j in range(2)],
                     [[l] for l in labels for _ in range(2)])
    assert clf._get_adaptive_threshold(25) == pytest.approx(clf.default_threshold * 0.2)
    assert len(clf.predict_multilabel("lab00:9")) >= 1


def test_predict_falls_back_to_base(ml_factory):
    clf = ml_factory(default_threshold=1.5)
    clf.min_predictions = 0
    clf.add_examples(["a:1", "b:1"], [["a"], ["b"]])
    assert clf.predict("a:1", k=2)


def test_finetune_encoder_is_not_ported(ml_factory):
    with pytest.raises(NotImplementedError, match="finetune"):
        ml_factory().finetune_encoder(steps=1)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

ROWS = ([f"tech:{i}" for i in range(6)] + [f"sport:{i}" for i in range(6)]
        + [f"mix:{i}" for i in range(6)] + [f"news:{i}" for i in range(4)],
        [["tech"]] * 6 + [["sport"]] * 6 + [["tech", "sport"]] * 6
        + [["news", "tech"]] * 4)
QUERIES = ["mix:99", "tech:50", "sport:51", "news:52", "other:53"]


def _spy(monkeypatch, module, seen):
    orig = module.fit_head

    def wrapper(params, emb, labels, valid, active, *args, **kwargs):
        seen.append({"emb": np.asarray(emb, np.float32), "labels": np.asarray(labels),
                     "valid": np.asarray(valid), "active": np.asarray(active),
                     "loss": kwargs.get("loss_type"), "epochs": kwargs.get("max_epochs"),
                     "scheduler": kwargs.get("use_scheduler")})
        return orig(params, emb, labels, valid, active, *args, **kwargs)

    monkeypatch.setattr(module, "fit_head", wrapper)


@pytest.fixture(scope="module")
def both_ml():
    mp = pytest.MonkeyPatch()
    seen = {"port": [], "jax": []}
    _spy(mp, ttraining, seen["port"])
    _spy(mp, jtraining, seen["jax"])
    try:
        clf, jclf = _synth(MultiLabelAdaptiveClassifier), _synth(JaxMultiLabel)
        for c in (clf, jclf):
            c.add_examples(ROWS[0][:12], ROWS[1][:12])
            c.add_examples(ROWS[0][12:], ROWS[1][12:])
    finally:
        mp.undo()
    return clf, jclf, seen


def test_bce_fit_sees_the_jax_rows(both_ml):
    clf, jclf, seen = both_ml
    assert len(seen["port"]) == len(seen["jax"]) >= 2
    for got, want in zip(seen["port"], seen["jax"]):
        assert (got["loss"], got["scheduler"], got["epochs"]) == \
            (want["loss"], want["scheduler"], want["epochs"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["active"], want["active"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["emb"], want["emb"], atol=1e-6)
    assert clf.train_steps == jclf.train_steps
    assert clf.label_thresholds == jclf.label_thresholds
    assert clf.label_to_id == jclf.label_to_id


def test_predict_multilabel_matches_jax_with_the_jax_head(both_ml):
    clf, jclf, _ = both_ml
    saved = clf.head_params
    clf.head_params = convert.head_params_from_jax(jclf.head_params)
    try:
        for q in QUERIES:
            for kw in ({}, {"threshold": 0.0}, {"threshold": 0.0, "max_labels": 2}):
                got = clf.predict_multilabel(q, **kw)
                want = jclf.predict_multilabel(q, **kw)
                assert [l for l, _ in got] == [l for l, _ in want], (q, kw)
                np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                           atol=1e-4)
            assert [l for l, _ in clf.predict(q, k=2)] == [l for l, _ in jclf.predict(q, k=2)]
    finally:
        clf.head_params = saved


def test_prototype_branch_matches_jax():
    """With no head the nearest prototypes answer, in both packages."""
    clf, jclf = _synth(MultiLabelAdaptiveClassifier), _synth(JaxMultiLabel)
    for c in (clf, jclf):
        c.add_examples(ROWS[0][:12], ROWS[1][:12])
        c.head_params = None
    for q in QUERIES:
        got = clf.predict_multilabel(q, threshold=0.0)
        want = jclf.predict_multilabel(q, threshold=0.0)
        assert [l for l, _ in got] == [l for l, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)


@pytest.mark.parametrize("cls,jcls", [(AdaptiveHead, jhead.AdaptiveHead),
                                      (MultiLabelAdaptiveHead, jhead.MultiLabelAdaptiveHead)])
def test_head_facades(cls, jcls):
    """Same shapes and widths as the JAX facades; with the JAX weights
    carried across, the same outputs; growing keeps the old columns."""
    x = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    head, jh = cls(16, 3, device="cpu"), jcls(16, 3)
    assert isinstance(head, torch.nn.Module)
    assert head.hidden_dims == jh.hidden_dims
    assert tuple(head(x).shape) == tuple(np.asarray(jh(x)).shape) == (3, 3)
    head.params = convert.head_params_from_jax(jh.params)
    np.testing.assert_allclose(head(x).numpy(), np.asarray(jh(x)), atol=1e-6)
    before = head(x).clone()
    head.update_num_classes(5)
    assert tuple(head(x).shape) == (3, 5)
    torch.testing.assert_close(head(x)[:, :3], before)
