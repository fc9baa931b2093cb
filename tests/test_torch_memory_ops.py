"""Memory editing and the other surfaces of a served classifier on the port
against the JAX package (CPU): the memory's ``add_example``, ``reembed``,
``clear``, ``remove_label`` and ``class_embeddings``; the classifier's
``clear_memory`` and ``merge_classifiers`` (same labels, prototypes and
predictions as in JAX); ``enable_profiling``; ``from_pretrained`` on a local
directory and ``to``; the legacy checkpoint layout (``config.json`` with the
examples embedded, ``tensors.safetensors``) loaded by both packages; and
``launch_counts`` kept exact by threads."""

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.config import Example as JaxExample
from adaptive_classifier_tpu_torch import AdaptiveClassifier, Example, convert, ops
from tests.conftest import synthetic_embed

REPO = Path(__file__).resolve().parent.parent
TASK = REPO / "checkpoints" / "zoo" / "banking-intents"
CFG = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16, 32],
       "example_capacity_buckets": [32, 128], "head_type": "ridge"}
ROWS = ([f"{c}:{i}" for c in ("cat", "dog", "fox") for i in range(6)],
        [c for c in ("cat", "dog", "fox") for _ in range(6)])
QUERIES = ["cat:90", "dog:91", "fox:92", "bird:93", "ant:94"]


def _synth(cls, model="prajjwal1/bert-tiny", **config):
    extra = {"device": "cpu"} if cls is AdaptiveClassifier else {}
    clf = cls(model, config={**CFG, **config}, **extra)
    clf._get_embeddings = lambda texts: synthetic_embed(texts, dim=clf.embedding_dim)
    return clf


def _pair(**config):
    clf, jclf = _synth(AdaptiveClassifier, **config), _synth(JaxClassifier, **config)
    for c in (clf, jclf):
        c.add_examples(*ROWS)
    return clf, jclf


def assert_same(clf, jclf):
    """Same labels, stored texts, memory state and predictions."""
    assert clf.label_to_id == jclf.label_to_id
    assert clf.memory.label_to_index == jclf.memory.label_to_index
    assert clf.memory.texts == jclf.memory.texts
    want = convert.memory_state_from_jax(jclf.memory.state)
    got = clf.memory.state
    np.testing.assert_array_equal(got.count.numpy(), want.count.numpy())
    np.testing.assert_allclose(got.proto.numpy(), want.proto.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.pweight.numpy(), want.pweight.numpy())
    assert (clf._proto_bias is None) == (jclf._proto_bias is None)
    for g, w in zip(clf.predict_batch(QUERIES, k=3), jclf.predict_batch(QUERIES, k=3)):
        assert [l for l, _ in g] == [l for l, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4)


def test_memory_add_example_and_class_embeddings_match_jax():
    clf, jclf = _pair()
    emb = synthetic_embed(["cat:extra"], dim=clf.embedding_dim)[0]
    clf.memory.add_example(Example("cat:extra", "cat", emb), "cat")
    jclf.memory.add_example(JaxExample("cat:extra", "cat", emb), "cat")
    for label in ("cat", "dog"):
        np.testing.assert_allclose(clf.memory.class_embeddings(label),
                                   np.asarray(jclf.memory.class_embeddings(label)), atol=1e-6)
    assert clf.memory.class_embeddings("cat").shape == (7, clf.embedding_dim)
    with pytest.raises(ValueError):
        clf.memory.add_example(Example("x", "cat", None), "cat")
    with pytest.raises(ValueError):
        clf.memory.add_example(Example("x", "cat", np.zeros(3, np.float32)), "cat")


def test_memory_remove_label_and_clear_match_jax():
    clf, jclf = _pair()
    clf.memory.remove_label("dog")
    jclf.memory.remove_label("dog")
    clf.memory.remove_label("never-seen")
    assert clf.memory.texts == jclf.memory.texts
    np.testing.assert_array_equal(clf.memory.state.count.numpy(),
                                  np.asarray(jclf.memory.state.count))
    np.testing.assert_allclose(clf.memory.state.proto.numpy(),
                               np.asarray(jclf.memory.state.proto), atol=1e-6)
    shape = tuple(clf.memory.state.emb.shape)
    clf.memory.clear()
    jclf.memory.clear()
    assert clf.memory.label_to_index == jclf.memory.label_to_index == {}
    assert tuple(clf.memory.state.emb.shape) == shape
    assert int(clf.memory.state.count.sum()) == 0 and clf.memory.state.emb.device == clf.device


def test_memory_reembed_matches_jax():
    clf, jclf = _pair()
    new_embed = lambda texts: synthetic_embed(texts, dim=clf.embedding_dim, noise=0.2)
    clf.memory.reembed(new_embed)
    jclf.memory.reembed(new_embed)
    assert clf.memory.texts == jclf.memory.texts
    assert clf.memory.label_to_index == jclf.memory.label_to_index
    np.testing.assert_allclose(clf.memory.state.proto.numpy(),
                               np.asarray(jclf.memory.state.proto), atol=1e-5)
    np.testing.assert_allclose(clf.memory.state.emb.numpy(),
                               np.asarray(jclf.memory.state.emb), atol=1e-6)


@pytest.mark.parametrize("labels", [["dog"], ["dog", "fox"], None], ids=["one", "two", "all"])
def test_clear_memory_matches_jax(labels):
    clf, jclf = _pair()
    bias = np.full((clf._class_capacity,), 0.1, np.float32)
    clf._proto_bias, jclf._proto_bias = bias, bias
    clf.clear_memory(labels)
    jclf.clear_memory(labels)
    assert clf._proto_bias is None
    if labels is None:
        # every label keeps its id, with no examples left
        assert clf.memory.label_to_index == clf.label_to_id
        assert clf.memory.texts == jclf.memory.texts
        assert int(clf.memory.state.count.sum()) == 0
        return
    assert_same(clf, jclf)
    clf.add_examples(["dog:new"], ["dog"])
    jclf.add_examples(["dog:new"], ["dog"])
    assert_same(clf, jclf)


def test_merge_classifiers_same_space_matches_jax():
    clf, jclf = _pair()
    other_rows = ([f"{c}:{i}" for c in ("bird", "cat") for i in range(10, 15)],
                  [c for c in ("bird", "cat") for _ in range(5)])
    other, jother = _synth(AdaptiveClassifier), _synth(JaxClassifier)
    other.add_examples(*other_rows)
    jother.add_examples(*other_rows)
    assert clf.merge_classifiers(other) is clf
    jclf.merge_classifiers(jother)
    assert_same(clf, jclf)
    assert clf.label_to_id["bird"] == 3
    with pytest.raises(ValueError, match="embedding dimensions"):
        clf.merge_classifiers(_synth(AdaptiveClassifier, model="bert-base-uncased"))


def test_merge_classifiers_reembeds_across_models():
    """Different model names: ``other``'s texts are embedded again by this
    classifier, not copied."""
    clf, jclf = _pair()
    other_rows = (["owl:1", "owl:2", "owl:3"], ["owl"] * 3)
    other, jother = _synth(AdaptiveClassifier), _synth(JaxClassifier)
    for o in (other, jother):
        o.model_name = "another-model"
        o.add_examples(*other_rows)
    other.memory.state.emb.zero_()       # copied rows would be zeros
    seen = []
    base = clf._get_embeddings
    clf._get_embeddings = lambda texts: (seen.append(list(texts)), base(texts))[1]
    clf.merge_classifiers(other)
    jclf.merge_classifiers(jother)
    assert ["owl:1", "owl:2", "owl:3"] in seen
    clf._get_embeddings = base
    assert_same(clf, jclf)


def test_enable_profiling_times_the_jax_stages():
    clf = AdaptiveClassifier(str(REPO / "checkpoints" / "ac-tiny"), device="cpu",
                             config={**CFG, "embedding_cache_size": 0})
    clf.add_examples(["good stuff", "bad stuff"], ["pos", "neg"])
    timers = clf.enable_profiling()
    clf.predict_batch(["good", "bad", "fine"], k=1)
    summary = timers.summary()
    assert set(summary) == {"tokenize", "encoder_forward", "knn_fusion"}
    assert all(s["count"] == 1 for s in summary.values())
    assert "encoder_forward" in timers.report()
    timers.reset()
    assert timers.summary() == {}


def test_stage_waits_on_its_device_and_trace_writes(tmp_path):
    from adaptive_classifier_tpu_torch.utils.profiling import StageTimers, annotate, device_trace

    timers = StageTimers()
    with timers.stage("x", block_on=torch.ones(2)):
        pass
    timers.record("x", 0.5)
    assert timers.summary()["x"]["count"] == 2
    with device_trace(tmp_path / "trace"):
        with annotate("region"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "region" for e in trace["traceEvents"])


def test_from_pretrained_local_directory_and_to(tmp_path):
    clf, _ = _pair()
    clf.save(tmp_path / "ckpt", include_quantized=False)
    back = AdaptiveClassifier.from_pretrained(str(tmp_path / "ckpt"), device="cpu")
    assert back.label_to_id == clf.label_to_id
    with pytest.raises(ValueError, match="Hub"):
        AdaptiveClassifier.from_pretrained("org/some-model", device="cpu")
    assert back.to("cpu") is back and back.to(torch.device("cpu")) is back
    with pytest.raises(NotImplementedError, match="later slice"):
        back.to("cuda")


def _legacy_checkpoint(dst: Path) -> Path:
    """banking-intents in the legacy layout: the examples embedded in
    ``config.json``, the tensors in ``tensors.safetensors``; float32 and an
    absolute encoder path, the embedding caches off (the comparison needs
    no repeated text, and each cache would hold 545 MB at this width)."""
    cfg = json.loads((TASK / "config.json").read_text())
    cfg["config"]["compute_dtype"] = "float32"
    cfg["config"]["embedding_cache_size"] = 0
    cfg["model_name"] = str(REPO / cfg["model_name"])
    cfg["examples"] = json.loads((TASK / "examples.json").read_text())
    dst.mkdir()
    (dst / "config.json").write_text(json.dumps(cfg))
    os.symlink(TASK / "model.safetensors", dst / "tensors.safetensors")
    os.symlink(TASK / "lexical.json", dst / "lexical.json")
    return dst


def test_legacy_layout_loads_in_both_packages(tmp_path):
    path = _legacy_checkpoint(tmp_path / "legacy")
    clf = AdaptiveClassifier.load(path, device="cpu")
    jclf = JaxClassifier.load(str(path))
    assert clf.label_to_id == jclf.label_to_id
    assert clf.memory.texts == jclf.memory.texts
    np.testing.assert_array_equal(clf.memory.state.proto.numpy(),
                                  np.asarray(jclf.memory.state.proto))
    data = json.loads((REPO / "data" / "intents.json").read_text())
    texts = [t for lbl in data["train"] for t in data["test"][lbl]][::25]
    for g, w in zip(clf.predict_batch(texts, k=2), jclf.predict_batch(texts, k=2)):
        assert [l for l, _ in g] == [l for l, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4)


def test_launch_counts_stay_exact_under_threads():
    """More threads than cores, a short switch interval: a lost increment
    would show in the total."""
    import sys

    before = dict(ops.launch_counts)
    n_threads, per = 2 * (os.cpu_count() or 8), 5000

    def bump():
        for _ in range(per):
            ops.count_launch("knn_sims")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ops.launch_counts["knn_sims"] == before["knn_sims"] + n_threads * per
    ops.launch_counts["knn_sims"] = before["knn_sims"]
