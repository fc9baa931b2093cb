"""The serving engine over the port (CPU, synthetic embeddings below the
encoder): ``tests/test_serving.py``'s cases on the port's servers, then
the cross-package ones: served answers equal the JAX package's direct
``predict_batch`` on the same classifier state, and the predict modes
answer as the JAX package does, without strategic mode and with it.  Every
wait has a timeout and every server is stopped in a ``finally`` (or a
``with``)."""

import threading
import time

import numpy as np
import pytest

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.serving import (
    BatchingClassifierServer,
    DeadlineExceeded,
    MultiTenantServer,
    ServerOverloaded,
    _PriorityChannel,
    _Request,
    _RWLock,
)
from tests.conftest import synthetic_embed

CFG = {"train_size_buckets": [64, 256, 1024], "class_capacity_buckets": [8, 16, 32, 64],
       "example_capacity_buckets": [32, 128]}


def _synth(cls=AdaptiveClassifier, **config):
    extra = {"device": "cpu"} if cls is AdaptiveClassifier else {}
    clf = cls("prajjwal1/bert-tiny", config={**CFG, **config}, **extra)
    clf._get_embeddings = lambda texts: synthetic_embed(texts, dim=clf.embedding_dim)
    return clf


@pytest.fixture(scope="module")
def server_clf():
    clf = _synth()
    clf.add_examples([f"cat:{i}" for i in range(6)] + [f"dog:{i}" for i in range(6)],
                     ["cat"] * 6 + ["dog"] * 6)
    return clf


def test_predict_matches_direct(server_clf):
    direct = server_clf.predict_batch(["cat:77"], k=2)[0]
    with BatchingClassifierServer(server_clf, max_wait_ms=1) as server:
        served = server.predict("cat:77", k=2, timeout=30)
    assert served[0][0] == direct[0][0]
    assert abs(served[0][1] - direct[0][1]) < 1e-6


def test_concurrent_requests_batched(server_clf):
    with BatchingClassifierServer(server_clf, max_batch_size=32, max_wait_ms=20) as server:
        futures = [server.submit_predict(f"cat:{i}" if i % 2 == 0 else f"dog:{i}", k=1)
                   for i in range(24)]
        results = [f.result(timeout=60) for f in futures]
    for i, res in enumerate(results):
        assert res[0][0] == ("cat" if i % 2 == 0 else "dog")
    stats = server.stats()
    assert stats["requests_served"] == 24
    assert stats["batches_run"] < 24
    assert stats["mean_batch_size"] > 1.0


def test_add_examples_interleaved(server_clf):
    with BatchingClassifierServer(server_clf, max_wait_ms=1) as server:
        fut = server.submit_add_examples([f"bird:{i}" for i in range(6)], ["bird"] * 6)
        assert fut.result(timeout=120) is True
        res = server.predict("bird:99", k=3, timeout=60)
    assert res[0][0] == "bird"


def test_per_request_k(server_clf):
    with BatchingClassifierServer(server_clf, max_wait_ms=10) as server:
        f1 = server.submit_predict("cat:5", k=1)
        f2 = server.submit_predict("dog:5", k=2)
        r1, r2 = f1.result(timeout=30), f2.result(timeout=30)
    assert len(r1) == 1
    assert len(r2) == 2


def test_stop_and_restart(server_clf):
    server = BatchingClassifierServer(server_clf, max_wait_ms=1)
    try:
        server.start()
        assert server.predict("cat:1", k=1, timeout=30)
        server.stop()
        server.start()
        assert server.predict("dog:1", k=1, timeout=30)
    finally:
        server.stop()


def test_priority_orders_queued_work():
    chan = _PriorityChannel()
    for i, prio in enumerate([0, 0, 5, 1]):
        chan.put(_Request("predict", "default", [f"t{i}"], None, 1, priority=prio))
    order = []
    while chan.qsize():
        order.append(chan.get(timeout=1).texts[0])
    assert order == ["t2", "t3", "t0", "t1"]


def test_deadline_expired_requests_are_shed(server_clf):
    server = BatchingClassifierServer(server_clf, max_wait_ms=1)
    try:
        fut = server.submit_predict("cat:1", k=1, deadline_ms=5)
        time.sleep(0.05)
        server.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert server.requests_expired == 1
        live = server.submit_predict("cat:2", k=1, deadline_ms=60_000)
        assert live.result(timeout=30)[0][0] == "cat"
    finally:
        server.stop()


def test_overload_shedding_at_admission(server_clf):
    server = BatchingClassifierServer(server_clf, max_queue_depth=2)
    try:
        f1 = server.submit_predict("cat:1", k=1)
        f2 = server.submit_predict("cat:2", k=1)
        f3 = server.submit_predict("cat:3", k=1)
        with pytest.raises(ServerOverloaded):
            f3.result(timeout=1)
        assert server.requests_shed == 1
        server.start()
        assert f1.result(timeout=30)[0][0] == "cat"
        assert f2.result(timeout=30)[0][0] == "cat"
    finally:
        server.stop()


def test_backpressure_engages_under_live_overload(server_clf):
    """Offered far more than it drains, a live server sheds at admission,
    and every request resolves: served, shed or expired, never hung."""
    server = BatchingClassifierServer(server_clf, max_batch_size=4, max_wait_ms=1,
                                      max_queue_depth=8, num_workers=1)
    with server:
        n = 200
        futs = [server.submit_predict(f"cat:{i}", k=1, deadline_ms=30_000) for i in range(n)]
        served = shed = expired = 0
        for f in futs:
            exc = f.exception(timeout=60)
            if exc is None:
                served += 1
            elif isinstance(exc, ServerOverloaded):
                shed += 1
            elif isinstance(exc, DeadlineExceeded):
                expired += 1
            else:  # pragma: no cover
                raise exc
        assert served + shed + expired == n
        assert shed > 0
        assert served > 0
        assert server.requests_shed == shed
        assert server.stats()["queue_depth"] == 0


def test_multi_tenant_routes_by_model():
    clf_a = _synth()
    clf_a.add_examples([f"cat:{i}" for i in range(4)] + [f"dog:{i}" for i in range(4)],
                       ["cat"] * 4 + ["dog"] * 4)
    clf_b = _synth()
    clf_b.add_examples([f"spam:{i}" for i in range(4)] + [f"ham:{i}" for i in range(4)],
                       ["spam"] * 4 + ["ham"] * 4)
    with MultiTenantServer({"animals": clf_a, "mail": clf_b}, max_wait_ms=5) as server:
        fa = [server.submit_predict(f"cat:{i+10}", k=1, model="animals") for i in range(3)]
        fb = [server.submit_predict(f"spam:{i+10}", k=1, model="mail") for i in range(3)]
        assert all(f.result(timeout=60)[0][0] == "cat" for f in fa)
        assert all(f.result(timeout=60)[0][0] == "spam" for f in fb)
        bad = server.submit_predict("x", model="nope")
        with pytest.raises(KeyError):
            bad.result(timeout=1)
    stats = server.stats()
    assert stats["requests_served"] == 6
    assert stats["models"] == ["animals", "mail"]


def test_multi_tenant_add_model_and_training():
    clf_a = _synth()
    clf_a.add_examples(["cat:0", "dog:0", "cat:1", "dog:1"], ["cat", "dog", "cat", "dog"])
    server = MultiTenantServer({"animals": clf_a})
    try:
        server.start()
        clf_b = _synth()
        server.add_model("colors", clf_b)
        add = server.submit_add_examples(["red:0", "blue:0", "red:1", "blue:1"],
                                         ["red", "blue", "red", "blue"], model="colors")
        assert add.result(timeout=60) is True
        res = server.submit_predict("red:7", k=1, model="colors").result(timeout=60)
        assert res[0][0] == "red"
        with pytest.raises(ValueError):
            server.add_model("animals", clf_b)
    finally:
        server.stop()


def test_prediction_modes(server_clf):
    """Without strategic mode ``robust``, ``strategic`` and ``dual`` answer
    as the JAX package does without it (``_predict_regular_batch``),
    batches never mix modes, and an unknown mode errors."""
    assert server_clf.strategic_mode is False
    with BatchingClassifierServer(server_clf, max_wait_ms=5) as server:
        regular = server_clf._predict_regular_batch(["cat:query"], 2)[0]
        for mode in ("robust", "strategic", "dual"):
            served = server.predict("cat:query", k=2, mode=mode, timeout=30)
            assert [l for l, _ in served] == [l for l, _ in regular]
            np.testing.assert_allclose([s for _, s in served], [s for _, s in regular],
                                       atol=1e-6)
        assert server_clf.predict_robust("cat:query", 2) == regular
        assert server_clf.predict_strategic("cat:query", 2) == regular
        futs = [server.submit_predict(f"cat:{i}", k=1, mode=("robust" if i % 2 else "regular"))
                for i in range(8)]
        assert all(f.result(timeout=30) for f in futs)
        with pytest.raises(ValueError, match="unknown mode"):
            server.predict("cat:x", mode="telepathy", timeout=30)


def test_prediction_modes_in_strategic_mode():
    """In strategic mode the served ``robust``, ``strategic`` and ``dual``
    answers, from several client threads, are the direct calls'
    (``predict_robust_batch``, ``predict_strategic_batch``,
    ``_predict_dual_batch``), which are the JAX package's on the same
    stored examples (labels identical, scores within 1e-4)."""
    cfg = {"head_type": "ridge", "enable_strategic_mode": True,
           "cost_function_type": "linear", "cost_coefficients": [0.15] * 128}
    clf, jclf = _synth(**cfg), _synth(JaxClassifier, **cfg)
    texts = [f"{a}:{i}" for a in ("cat", "dog", "owl") for i in range(6)]
    labels = [t.split(":")[0] for t in texts]
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    assert clf.strategic_mode and jclf.strategic_mode
    queries = [f"{a}:q{i}" for a in ("cat", "dog", "owl") for i in range(4)]
    direct = {"robust": "predict_robust_batch", "strategic": "predict_strategic_batch",
              "dual": "_predict_dual_batch"}
    with BatchingClassifierServer(clf, max_wait_ms=5, num_workers=2) as server:
        for mode, method in direct.items():
            served = [None] * len(queries)

            def client(rows, mode=mode, served=served):
                for i in rows:
                    served[i] = server.submit_predict(queries[i], k=2, mode=mode).result(
                        timeout=30)

            threads = [threading.Thread(target=client, args=(range(c, len(queries), 3),))
                       for c in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            want = getattr(clf, method)(queries, 2)
            jwant = getattr(jclf, method)(queries, 2)
            for got, ref, atol in ((served, want, 1e-6), (want, jwant, 1e-4)):
                assert [[l for l, _ in r] for r in got] == [[l for l, _ in r] for r in ref]
                np.testing.assert_allclose([s for r in got for _, s in r],
                                           [s for r in ref for _, s in r], atol=atol)


def test_multi_worker_consistency_and_write_exclusion():
    clf = _synth()
    clf.add_examples([f"cat:{i}" for i in range(6)] + [f"dog:{i}" for i in range(6)],
                     ["cat"] * 6 + ["dog"] * 6)
    ref = {t: clf.predict_batch([t], k=1)[0][0][0] for t in ["cat:77", "dog:88"]}
    with BatchingClassifierServer(clf, max_batch_size=8, max_wait_ms=2,
                                  num_workers=3) as srv:
        futs = [srv.submit_predict("cat:77" if i % 2 == 0 else "dog:88", k=1)
                for i in range(60)]
        addf = srv.submit_add_examples([f"bird:{i}" for i in range(4)], ["bird"] * 4)
        futs2 = [srv.submit_predict(f"bird:{i}", k=1) for i in range(8)]
        for i, f in enumerate(futs):
            want = ref["cat:77"] if i % 2 == 0 else ref["dog:88"]
            assert f.result(timeout=60)[0][0] == want
        assert addf.result(timeout=60) is True
        assert all(f.result(timeout=60) for f in futs2)
    assert clf.predict("bird:1", k=1)[0][0] == "bird"


def test_predict_batch_size_invariance():
    clf = _synth(embedding_cache_size=0)
    clf.add_examples([f"cat:{i}" for i in range(6)] + [f"dog:{i}" for i in range(6)],
                     ["cat"] * 6 + ["dog"] * 6)
    texts = [("cat:q%d" if i % 2 else "dog:q%d") % i for i in range(33)]
    ref = clf.predict_batch(texts, k=2)
    for n in (1, 3, 7, 20, 33):
        out = clf.predict_batch(texts[:n], k=2)
        for a, b in zip(out, ref):
            assert [l for l, _ in a] == [l for l, _ in b]
            assert all(abs(x - y) < 1e-3 for (_, x), (_, y) in zip(a, b))
    out = clf.predict_batch(texts[:10], k=2, batch_size=4)
    for a, b in zip(out, ref):
        assert [l for l, _ in a] == [l for l, _ in b]


# ---------------------------------------------------------------------------
# against the JAX package, and the port's own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_ridge():
    """The same synthetic classifier in both packages (ridge head: the
    closed-form fit gives both the same state)."""
    rows = ([f"c{j}:{i}" for j in range(5) for i in range(6)],
            [f"c{j}" for j in range(5) for _ in range(6)])
    clf, jclf = _synth(head_type="ridge"), _synth(JaxClassifier, head_type="ridge")
    clf.add_examples(*rows)
    jclf.add_examples(*rows)
    return clf, jclf


def test_served_answers_match_jax_predict_batch(both_ridge):
    """Seeded shuffled traffic from 4 client threads through 2 workers:
    every answer equals the JAX package's ``predict_batch`` for its text."""
    clf, jclf = both_ridge
    r = np.random.default_rng(0)
    texts = [f"c{int(r.integers(5))}:q{i}" for i in range(64)]
    want = dict(zip(texts, jclf.predict_batch(texts, k=3)))
    order = list(r.permutation(len(texts)))
    results = {}
    with BatchingClassifierServer(clf, max_batch_size=16, max_wait_ms=2,
                                  num_workers=2) as srv:
        def client(idx):
            futs = [(texts[i], srv.submit_predict(texts[i], k=3)) for i in idx]
            for t, f in futs:
                results[t] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(order[c::4],)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == len(texts)
    for t in texts:
        assert [l for l, _ in results[t]] == [l for l, _ in want[t]]
        np.testing.assert_allclose([s for _, s in results[t]], [s for _, s in want[t]],
                                   atol=1e-4)


def test_modes_match_jax_without_strategic_mode(both_ridge):
    clf, jclf = both_ridge
    texts = ["c1:z", "c3:z", "c4:z"]
    for name in ("predict_robust_batch", "predict_strategic_batch", "_predict_dual_batch",
                 "_predict_regular_batch"):
        got, want = getattr(clf, name)(texts, 2), getattr(jclf, name)(texts, 2)
        for g, w in zip(got, want):
            assert [l for l, _ in g] == [l for l, _ in w], name
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4)


def test_worker_exception_reaches_every_future(server_clf):
    """A batch that fails resolves each of its requests' futures with the
    exception; the worker lives on and serves the next batch."""
    calls = []

    def boom(texts, k=5, batch_size=None):
        calls.append(len(texts))
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return AdaptiveClassifier.predict_batch(server_clf, texts, k, batch_size)

    server_clf.predict_batch = boom
    server = BatchingClassifierServer(server_clf, max_wait_ms=20, num_workers=1)
    try:
        futs = [server.submit_predict(f"cat:{i}", k=1) for i in range(5)]
        server.start()
        for f in futs:
            assert isinstance(f.exception(timeout=30), RuntimeError)
        assert server.predict("dog:3", k=1, timeout=30)[0][0] == "dog"
    finally:
        server.stop()
        del server_clf.predict_batch


def test_rw_lock_excludes_readers_while_writing():
    lock, events = _RWLock(), []
    lock.acquire_read()
    writer = threading.Thread(target=lambda: (lock.acquire_write(), events.append("w"),
                                              lock.release_write()))
    writer.start()
    time.sleep(0.05)
    assert events == []          # the reader still holds it
    reader = threading.Thread(target=lambda: (lock.acquire_read(), events.append("r"),
                                              lock.release_read()))
    reader.start()
    time.sleep(0.05)
    assert events == []          # a waiting writer blocks new readers
    lock.release_read()
    writer.join(timeout=10)
    reader.join(timeout=10)
    assert not writer.is_alive() and not reader.is_alive()
    assert events == ["w", "r"]
