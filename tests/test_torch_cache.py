"""The embedding caches on the port against the JAX package's (CPU): the
host LRU and the device ring buffer driven through the same operations in
both packages, and the classifier's predict path served from the device
cache giving the answers of the encoder path, as the JAX package's
does (``tests/test_cache.py``'s cases, then the port's own traps: a padded
chunk writes only its rows, the ring is made at the first predict and
outside ``torch.inference_mode``, a replaced ``_get_embeddings`` bypasses
it)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.utils import cache as jcache
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.utils.cache import DeviceEmbeddingCache, EmbeddingCache
from tests.conftest import synthetic_embed

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "checkpoints" / "ac-tiny")
SMALL = {"train_size_buckets": [64], "class_capacity_buckets": [8],
         "example_capacity_buckets": [32]}


def test_lru_basic():
    c = EmbeddingCache(capacity=2)
    cached, misses = c.lookup(["a", "b"], 64)
    assert misses == [0, 1]
    c.store(["a", "b"], 64, np.arange(8).reshape(2, 4).astype(np.float32))
    cached, misses = c.lookup(["a", "b"], 64)
    assert misses == []
    np.testing.assert_array_equal(cached[0], [0, 1, 2, 3])
    _ = c.lookup(["b"], 64)  # touch b
    c.store(["c"], 64, np.ones((1, 4), np.float32))
    _, misses = c.lookup(["a"], 64)
    assert misses == [0]
    _, misses = c.lookup(["b", "c"], 64)
    assert misses == []


def test_max_length_keying():
    c = EmbeddingCache(capacity=4)
    c.store(["a"], 64, np.ones((1, 4), np.float32))
    _, misses = c.lookup(["a"], 128)
    assert misses == [0]


def test_lru_matches_jax_on_seeded_traffic():
    """The same seeded stream of lookups and stores: the same misses, rows
    and stats as the JAX package's LRU."""
    r = np.random.default_rng(0)
    ours, theirs = EmbeddingCache(capacity=16), jcache.EmbeddingCache(capacity=16)
    for _ in range(60):
        texts = [f"t{i}" for i in r.integers(0, 40, r.integers(1, 9))]
        got, got_miss = ours.lookup(texts, 32)
        want, want_miss = theirs.lookup(texts, 32)
        assert got_miss == want_miss
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
        rows = r.standard_normal((len(got_miss), 4)).astype(np.float32)
        miss_texts = [texts[i] for i in got_miss]
        ours.store(miss_texts, 32, rows)
        theirs.store(miss_texts, 32, rows)
    assert ours.stats() == theirs.stats()


def test_classifier_uses_cache():
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu",
                             config={**SMALL, "embedding_cache_size": 128})
    e1 = clf._get_embeddings(["hello world", "foo bar"])
    e2 = clf._get_embeddings(["hello world", "foo bar"])
    np.testing.assert_array_equal(e1, e2)
    stats = clf._emb_cache.stats()
    assert stats["hits"] == 2
    assert stats["misses"] == 2
    e3 = clf._get_embeddings(["new text", "hello world"])
    np.testing.assert_array_equal(e3[1], e1[0])


def test_device_cache_ring_and_gather():
    c = DeviceEmbeddingCache(capacity=3, dim=4, device="cpu")
    rows = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    c.store(["a", "b"], 64, rows)
    hits, misses = c.lookup(["a", "b", "x"], 64)
    assert misses == [2] and [i for i, _ in hits] == [0, 1]
    assert torch.equal(c.gather([s for _, s in hits]), rows)
    # padded store: only the first len(texts) rows land
    c.store(["c"], 64, torch.full((4, 4), 9.0))
    hits, _ = c.lookup(["c"], 64)
    assert torch.equal(c.gather([hits[0][1]])[0], torch.full((4,), 9.0))
    # the fourth store wraps the ring: "a" (the oldest slot) is overwritten
    c.store(["d"], 64, torch.full((1, 4), 7.0))
    _, misses = c.lookup(["a"], 64)
    assert misses == [0]
    _, misses = c.lookup(["b"], 64)
    assert misses == []
    _, misses = c.lookup(["b"], 128)
    assert misses == [0]


def test_device_cache_matches_jax_on_seeded_traffic():
    """The same seeded stream of padded stores, lookups and gathers: the
    same hits, misses, gathered rows and stats as the JAX package's ring."""
    import jax.numpy as jnp

    r = np.random.default_rng(1)
    ours = DeviceEmbeddingCache(capacity=8, dim=6, device="cpu")
    theirs = jcache.DeviceEmbeddingCache(capacity=8, dim=6)
    for _ in range(40):
        texts = list(dict.fromkeys(f"t{i}" for i in r.integers(0, 20, r.integers(1, 6))))
        hits, misses = ours.lookup(texts, 16)
        assert (hits, misses) == theirs.lookup(texts, 16)
        if hits:
            slots = [s for _, s in hits]
            np.testing.assert_array_equal(ours.gather(slots).numpy(),
                                          np.asarray(theirs.gather(slots)))
        pad = 1 if len(misses) == 1 else 8
        rows = r.standard_normal((pad, 6)).astype(np.float32)
        miss_texts = [texts[i] for i in misses]
        ours.store(miss_texts, 16, torch.from_numpy(rows))
        theirs.store(miss_texts, 16, jnp.asarray(rows))
    assert ours.stats() == theirs.stats()
    np.testing.assert_array_equal(ours._buf.numpy(), np.asarray(theirs._buf))


def test_padded_chunk_writes_only_its_rows():
    """JAX drops padding rows by scattering them out of bounds; here only
    the first n rows are written, and every other slot is left alone."""
    c = DeviceEmbeddingCache(capacity=4, dim=3, device="cpu")
    c.store(["a"], 8, torch.full((1, 3), 5.0))
    c.store(["b", "c"], 8, torch.full((64, 3), 2.0))
    assert torch.equal(c._buf[0], torch.full((3,), 5.0))
    assert torch.equal(c._buf[1:3], torch.full((2, 3), 2.0))
    assert torch.equal(c._buf[3], torch.zeros(3))
    # more texts than slots: the last `capacity` rows are the ones kept
    c.store([f"x{i}" for i in range(6)], 8, torch.arange(18.0).reshape(6, 3))
    hits, misses = c.lookup([f"x{i}" for i in range(6)], 8)
    assert misses == [0, 1]
    got = c.gather([s for _, s in hits])
    assert torch.equal(got, torch.arange(18.0).reshape(6, 3)[2:])


def test_device_cache_under_concurrent_workers():
    """More threads than cores storing, looking up and gathering through
    one small ring, with a short switch interval.  Whenever the lock is
    held, every published slot holds its text's row (a slot published
    before its write, or a write lost to a race, would break it)."""
    import os
    import sys
    import threading

    dim = 8
    c = DeviceEmbeddingCache(capacity=32, dim=dim, device="cpu")

    def row(text):
        return torch.full((dim,), float(int(text[1:])))

    def consistent():
        with c._lock:
            return all(torch.equal(c._buf[slot], row(text))
                       for (text, _), slot in c._slot_of.items())

    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for step in range(200):
                texts = list(dict.fromkeys(f"t{i}" for i in r.integers(0, 64, 6)))
                hits, misses = c.lookup(texts, 8)
                if hits:
                    c.gather([s for _, s in hits])
                miss = [texts[i] for i in misses]
                if miss:   # a padded chunk: two rows past the texts
                    c.store(miss, 8, torch.stack([row(t) for t in miss]
                                                 + [torch.full((dim,), -1.0)] * 2))
                if step % 20 == 0 and not consistent():
                    errors.append(step)
        except Exception as e:     # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 8))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert consistent() and c._slot_of


@pytest.fixture(scope="module")
def both_tiny():
    """ac-tiny in both packages (float32, ridge head), the device cache on."""
    cfg = {**SMALL, "embedding_cache_size": 64, "head_type": "ridge",
           "compute_dtype": "float32"}
    clf = AdaptiveClassifier(TINY, device="cpu", config=dict(cfg))
    jclf = JaxClassifier(TINY, config=dict(cfg))
    texts = ["good stuff", "great work", "bad stuff", "awful work"]
    labels = ["pos", "pos", "neg", "neg"]
    for c in (clf, jclf):
        c.add_examples(texts, labels)
    return clf, jclf


def test_device_cache_is_made_at_the_first_predict_outside_inference_mode():
    clf = AdaptiveClassifier(TINY, device="cpu", config={**SMALL, "head_type": "ridge"})
    clf.add_examples(["good stuff", "bad stuff"], ["pos", "neg"])
    assert clf._dev_cache is None
    clf.predict_batch(["good"], k=1)
    buf = clf._dev_cache._buf
    assert buf.shape == (clf.config.embedding_cache_size, clf.embedding_dim)
    assert not buf.is_inference()
    # a store from outside inference mode still writes in place
    clf._dev_cache.store(["x"], clf.config.max_length, torch.ones(1, clf.embedding_dim))


def test_predict_batch_device_cache_consistency(both_tiny):
    """Rows served from the device cache give the encoder path's answers,
    and the same answers and hit counts as the JAX package."""
    clf, jclf = both_tiny
    queries = [f"query number {i}" for i in range(10)]
    r_miss = clf.predict_batch(queries, k=2)
    r_hit = clf.predict_batch(queries, k=2)
    assert r_miss == r_hit
    mixed = queries[:5] + [f"fresh {i}" for i in range(5)] + queries[5:]
    r_mixed = clf.predict_batch(mixed, k=2)
    assert r_mixed[:5] == r_miss[:5] and r_mixed[10:] == r_miss[5:]
    want = [jclf.predict_batch(queries, k=2), jclf.predict_batch(queries, k=2),
            jclf.predict_batch(mixed, k=2)]
    for got, w in zip((r_miss, r_hit, r_mixed), want):
        assert [[l for l, _ in row] for row in got] == [[l for l, _ in row] for row in w]
        np.testing.assert_allclose([[s for _, s in row] for row in got],
                                   [[s for _, s in row] for row in w], atol=1e-4)
    assert clf._dev_cache.stats() == jclf._dev_cache.stats()
    assert clf._dev_cache.stats()["hits"] >= 20


def test_predict_hits_fuse_in_bucketed_chunks(both_tiny):
    """A batch of hits bigger than the chunk fuses in chunks padded to the
    buckets {1, 8, 64, chunk} (32 rows → 64), and the rows come back in
    request order."""
    clf, _ = both_tiny
    queries = [f"bucket query {i}" for i in range(40)]
    cold = clf.predict_batch(queries, k=1, batch_size=32)
    seen = []
    orig = clf._dev_cache.gather
    clf._dev_cache.gather = lambda slots: (seen.append(len(slots)), orig(slots))[1]
    try:
        warm = clf.predict_batch(queries[::-1], k=1, batch_size=32)
    finally:
        del clf._dev_cache.gather
    assert seen == [64, 8]
    assert warm == cold[::-1]


def test_override_bypasses_the_device_cache():
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu", config=dict(SMALL))
    clf._get_embeddings = lambda t: synthetic_embed(t, dim=clf.embedding_dim)
    clf.add_examples(["a:1", "b:1", "a:2", "b:2"], ["a", "b", "a", "b"])
    assert clf.predict_batch(["a:9"], k=1)[0][0][0] == "a"
    assert clf._dev_cache is None


def test_lexical_setup_drops_the_host_cache():
    """A row cached before the lexical channel was set up (dense width
    only) is never served after it."""
    clf = AdaptiveClassifier(TINY, device="cpu",
                             config={**SMALL, "lexical_dim": 256, "head_type": "ridge"})
    early = clf._host_cache()
    early.store(["good stuff"], clf.config.max_length,
                np.zeros((1, clf.encoder.hidden_size), np.float32))
    clf.add_examples(["good stuff", "bad stuff", "great work", "awful work"],
                     ["pos", "neg", "pos", "neg"])
    assert clf._emb_cache is not early
    row = clf._get_embeddings(["good stuff"])
    assert row.shape == (1, clf.embedding_dim) and np.abs(row).sum() > 0


def test_cache_disabled():
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu",
                             config={**SMALL, "embedding_cache_size": 0})
    clf._get_embeddings(["x"])
    assert clf._emb_cache is None
    clf.add_examples(["a b", "c d"], ["a", "c"])
    clf.predict_batch(["a b"], k=1)
    assert clf._dev_cache is None
