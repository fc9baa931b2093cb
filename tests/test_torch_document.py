"""Long-document classification on the port against the JAX package (CPU,
ac-tiny in float32): the windowing, the padded window batch the encoder
sees, and ``predict_document`` in each pool (``tests/test_document.py``'s
cases, then the cross-package ones: window ids and masks equal, answers
within 1e-4)."""

from pathlib import Path

import numpy as np
import pytest

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu import document as jdoc
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.document import embed_document, window_batch, window_ids

CKPT = str(Path(__file__).resolve().parent.parent / "checkpoints" / "ac-tiny")
CFG = {"train_size_buckets": [64], "class_capacity_buckets": [8],
       "example_capacity_buckets": [32], "max_length": 32,
       "head_type": "ridge", "compute_dtype": "float32"}
TRAIN = (
    ["the library compiles kernels for the accelerator and runs tests",
     "install the package with the package manager and import it",
     "compile the module then execute the benchmark suite",
     "the runtime schedules work on the device and manages memory",
     "run the linter and the unit tests before submitting the patch",
     "the api documentation lists configuration flags and defaults",
     "the train departs from the station every morning at seven",
     "passengers boarded the express service to the coastal city",
     "the railway timetable changed after the holiday season",
     "the ferry crossing to the island takes about forty minutes",
     "travelers waited on the platform for the delayed night train",
     "the scenic route winds through mountain villages and lakes"],
    ["software"] * 6 + ["travel"] * 6)
LONG_SOFTWARE_DOC = (
    "the toolkit provides a compiler that lowers numerical programs onto "
    "accelerator hardware. users install the package, import the library, "
    "and run the provided test suite to validate the build. the runtime "
    "schedules kernels, manages device memory, and streams results back to "
    "the host process. documentation describes the api surface, the "
    "configuration flags, and the benchmark harness used to measure "
    "throughput across releases. contributors should run the linter and "
    "the full test suite before submitting changes for review."
)
TRAVEL_DOC = ("the night train left the coastal station late. passengers "
              "waited on the platform while the ferry crossed to the island, "
              "and the timetable changed for the holiday season on the scenic "
              "mountain route past villages and lakes.")


def test_window_short_stream_is_single_window():
    assert window_ids([1, 2, 3], 10, 7) == [[1, 2, 3]]


def test_window_exact_multiple_no_overlap():
    assert window_ids(list(range(20)), 10, 10) == [list(range(10)), list(range(10, 20))]


def test_window_overlap_and_tail_alignment():
    body = list(range(25))
    wins = window_ids(body, 10, 7)
    assert all(len(w) == 10 for w in wins)
    assert wins[0] == list(range(10))
    assert wins[1] == list(range(7, 17))
    assert wins[-1] == list(range(15, 25))
    assert set().union(*map(set, wins)) == set(body)


def test_window_rejects_bad_args():
    with pytest.raises(ValueError):
        window_ids([1, 2], 0, 1)
    with pytest.raises(ValueError):
        window_ids([1, 2], 4, 0)


def test_window_ids_match_jax_on_seeded_streams():
    r = np.random.default_rng(0)
    for _ in range(200):
        body = list(r.integers(0, 1000, r.integers(0, 300)))
        chunk = int(r.integers(1, 80))
        stride = int(r.integers(1, chunk + 1))
        assert window_ids(body, chunk, stride) == jdoc.window_ids(body, chunk, stride)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "lexical"])
def both(request):
    """ac-tiny in both packages, the same examples; with the lexical
    channel on, its knobs fixed (no sweep)."""
    cfg = dict(CFG)
    if request.param:
        cfg.update(lexical_dim=512, lexical_grams="word", lexical_weight=1.0)
    clf = AdaptiveClassifier(CKPT, device="cpu", config=dict(cfg))
    jclf = JaxClassifier(CKPT, config=dict(cfg))
    for c in (clf, jclf):
        c.add_examples(*TRAIN)
    return clf, jclf


@pytest.mark.parametrize("pool", ["mean", "max", "vote"])
def test_long_document_classifies_consistently(both, pool):
    clf, _ = both
    res = clf.predict_document(LONG_SOFTWARE_DOC, k=2, pool=pool)
    assert res and res[0][0] == "software", (pool, res)
    assert all(0.0 <= s <= 1.0 + 1e-6 for _, s in res)


def test_document_actually_windows(both):
    clf, _ = both
    emb, counts = embed_document(clf, LONG_SOFTWARE_DOC)
    assert emb.shape[0] == len(counts) and emb.shape[0] > 1
    assert emb.shape[1] == clf.embedding_dim
    assert counts.max() <= clf.config.max_length


def test_short_document_matches_predict(both):
    clf, _ = both
    text = "install the package and run tests"
    doc = clf.predict_document(text, k=2, pool="mean")
    direct = clf.predict(text, k=2)
    assert doc[0][0] == direct[0][0]
    emb = clf._get_embeddings([text])[0]
    same_path = clf._predict_from_embedding(emb, k=2)
    assert doc[0][0] == same_path[0][0]
    assert abs(doc[0][1] - same_path[0][1]) < 5e-3


def test_document_rejects_bad_input(both):
    clf, _ = both
    with pytest.raises(ValueError):
        clf.predict_document("")
    with pytest.raises(ValueError):
        clf.predict_document("text", pool="median")
    with pytest.raises(ValueError):
        clf.predict_document("text", overlap=1.0)


@pytest.mark.parametrize("chunk_tokens,overlap", [(None, 0.25), (16, 0.0), (24, 0.5),
                                                   (64, 0.25)])
def test_window_batch_matches_jax(both, chunk_tokens, overlap):
    """The padded ``[Wp, S]`` ids and mask the encoder sees equal the JAX
    package's (caught at its encoder call)."""
    clf, jclf = both
    seen = []
    orig = jclf.encoder._embed
    jclf.encoder._embed = lambda p, ids, mask: (seen.append((np.asarray(ids),
                                                             np.asarray(mask))),
                                                orig(p, ids, mask))[1]
    try:
        _, jcounts = jdoc.embed_document(jclf, LONG_SOFTWARE_DOC * 3, chunk_tokens, overlap)
    finally:
        jclf.encoder._embed = orig
    ids, mask, counts = window_batch(clf, LONG_SOFTWARE_DOC * 3, chunk_tokens, overlap)
    np.testing.assert_array_equal(ids, seen[0][0])
    np.testing.assert_array_equal(mask, seen[0][1])
    np.testing.assert_array_equal(counts, jcounts)


@pytest.mark.parametrize("pool", ["mean", "max", "vote"])
@pytest.mark.parametrize("text", [LONG_SOFTWARE_DOC, TRAVEL_DOC], ids=["software", "travel"])
def test_predict_document_matches_jax(both, pool, text):
    clf, jclf = both
    for ct in (None, 16):
        got = clf.predict_document(text, k=2, chunk_tokens=ct, pool=pool)
        want = jclf.predict_document(text, k=2, chunk_tokens=ct, pool=pool)
        assert [l for l, _ in got] == [l for l, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)


def test_window_above_the_largest_bucket(both):
    """``chunk_tokens`` above 512: a window longer than the largest bucket
    raises ValueError in both packages; a document that fits one such
    window is scored."""
    clf, jclf = both
    long_doc = " ".join([LONG_SOFTWARE_DOC] * 8)
    for c in (clf, jclf):
        with pytest.raises(ValueError):
            c.predict_document(long_doc, chunk_tokens=600)
    got = clf.predict_document(LONG_SOFTWARE_DOC, chunk_tokens=2000)
    want = jclf.predict_document(LONG_SOFTWARE_DOC, chunk_tokens=2000)
    assert [l for l, _ in got] == [l for l, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)


def test_window_distributions_take_no_recalibration_bias(both):
    """As in the JAX package, the max and vote pools fuse without the
    prototype recalibration bias (the mean pool applies it)."""
    clf, jclf = both
    bias = np.linspace(-0.5, 0.5, clf._class_capacity).astype(np.float32)
    saved = clf._proto_bias, jclf._proto_bias
    clf._proto_bias = jclf._proto_bias = bias
    try:
        for pool in ("vote", "mean"):
            got = clf.predict_document(TRAVEL_DOC, k=2, chunk_tokens=16, pool=pool)
            want = jclf.predict_document(TRAVEL_DOC, k=2, chunk_tokens=16, pool=pool)
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)
        no_bias = clf.predict_document(TRAVEL_DOC, k=2, chunk_tokens=16, pool="vote")
    finally:
        clf._proto_bias, jclf._proto_bias = saved
    assert no_bias == clf.predict_document(TRAVEL_DOC, k=2, chunk_tokens=16, pool="vote")
