"""The slice as a whole: a zoo classifier loaded in both packages answers
``predict_batch`` and ``predict`` with the same labels and scores (CPU,
float32 forward on both sides)."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu_torch import AdaptiveClassifier

REPO = Path(__file__).resolve().parent.parent
TASK = REPO / "checkpoints" / "zoo" / "banking-intents"


def _f32_checkpoint(dst: Path) -> Path:
    """The zoo checkpoint with ``compute_dtype`` forced to float32 and an
    absolute encoder path; the other files are symlinked."""
    cfg = json.loads((TASK / "config.json").read_text())
    cfg["config"]["compute_dtype"] = "float32"
    cfg["model_name"] = str(REPO / cfg["model_name"])
    dst.mkdir()
    (dst / "config.json").write_text(json.dumps(cfg))
    for name in ("examples.json", "lexical.json", "model.safetensors"):
        os.symlink(TASK / name, dst / name)
    return dst


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = _f32_checkpoint(tmp_path_factory.mktemp("zoo") / "banking-intents")
    return JaxClassifier.load(str(path)), AdaptiveClassifier.load(path, device="cpu")


def _test_texts(n):
    data = json.loads((REPO / "data" / "intents.json").read_text())
    rows = [t for lbl in data["train"] for t in data["test"][lbl]]
    return rows[::len(rows) // n][:n]


def _assert_same(got, want, atol=1e-4):
    assert [[lbl for lbl, _ in row] for row in got] == \
        [[lbl for lbl, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in want], atol=atol)


def test_loaded_state_matches(both):
    jclf, clf = both
    assert clf.label_to_id == jclf.label_to_id
    assert clf.embedding_dim == jclf.embedding_dim == 512 + 32768
    assert clf._fusion_alpha == jclf._fusion_alpha
    assert clf._class_capacity == jclf._class_capacity
    np.testing.assert_array_equal(clf.memory.state.proto.numpy(),
                                  np.asarray(jclf.memory.state.proto))
    np.testing.assert_array_equal(clf.memory.state.valid.numpy(),
                                  np.asarray(jclf.memory.state.valid))
    np.testing.assert_array_equal(clf.head_params["out"]["w"].numpy(),
                                  np.asarray(jclf.head_params["out"]["w"]))


@pytest.mark.parametrize("k", [1, 3])
def test_predict_batch_matches_jax(both, k):
    jclf, clf = both
    texts = _test_texts(16)
    # float32 forward on both sides; summation order differs
    _assert_same(clf.predict_batch(texts, k=k), jclf.predict_batch(texts, k=k))


def test_predict_batch_chunks_match_jax(both):
    jclf, clf = both
    texts = _test_texts(16)
    _assert_same(clf.predict_batch(texts, k=2, batch_size=5),
                 jclf.predict_batch(texts, k=2))


def test_predict_matches_jax(both):
    jclf, clf = both
    for text in _test_texts(3):
        _assert_same([clf.predict(text, k=4)], [jclf.predict(text, k=4)])


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveClassifier.load(TASK)


def test_unported_paths_raise(both):
    _, clf = both
    labels = dict(clf.label_to_id)
    # a loaded checkpoint keeps ~5 rows per class: new classes there take the
    # JAX package's frozen-head gradient path, not ported yet; nothing changes
    with pytest.raises(NotImplementedError, match="later slice"):
        clf.add_examples(["a"], ["b"])
    assert clf.label_to_id == labels
    with pytest.raises(NotImplementedError, match="later slice"):
        clf.predict_proba(["a"], calibrated=True)
    with pytest.raises(ValueError):
        clf.predict_batch([])
