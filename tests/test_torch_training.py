"""The fitting half of add_examples against the JAX package on identical
inputs (CPU, float32): the ridge head, λ selection, the fusion share, the
new-class penalty, the lexical sweep, the prototype memory's transitions
and the linear head's init and growth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import lexical as jlex
from adaptive_classifier_tpu import memory as jmem
from adaptive_classifier_tpu import training as jtrain
from adaptive_classifier_tpu.config import ModelConfig as JaxConfig
from adaptive_classifier_tpu_torch import convert, lexical as tlex
from adaptive_classifier_tpu_torch import memory as tmem
from adaptive_classifier_tpu_torch import training as ttrain
from adaptive_classifier_tpu_torch.config import ModelConfig
from adaptive_classifier_tpu_torch.models import head as thead


def rows(seed, N, D, C, n_valid=None, spread=1.0):
    """Class-structured rows: class means plus noise, unit-normalized."""
    r = np.random.default_rng(seed)
    means = r.standard_normal((C, D)).astype(np.float32)
    y = np.arange(N) % C
    x = means[y] + spread * r.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.arange(N) < (N if n_valid is None else n_valid)
    return x.astype(np.float32), y.astype(np.int32), valid


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("N,D,weighted", [
    (48, 64, False),     # dual form (rows <= dims)
    (48, 64, True),
    (200, 24, False),    # primal form
    (200, 24, True),
])
def test_ridge_solve_matches_jax(N, D, weighted):
    x, y, valid = rows(0, N, D, 6, n_valid=N - 7)
    w = (0.5 + np.random.default_rng(1).random(N)).astype(np.float32) if weighted else None
    want = np.asarray(jtrain.ridge_solve(jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
                                         8, 0.3, None if w is None else jnp.asarray(w)))
    got = ttrain.ridge_solve(t(x), t(y), t(valid), 8, 0.3,
                             sample_weight=None if w is None else t(w))
    assert got.shape == (D, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_ridge_head_params_keeps_skip():
    x, y, valid = rows(2, 30, 16, 3)
    keep = {"skip": {"w": torch.ones(16, 4)}}
    params = ttrain.ridge_head_params(t(x), t(y), t(valid), 4, keep_from=keep)
    assert params["hidden"] == [] and params["skip"] is keep["skip"]
    assert torch.equal(params["out"]["b"], torch.zeros(4))


@pytest.mark.parametrize("seed,spread", [(3, 1.0), (4, 2.5), (5, 0.3)])
def test_select_ridge_lambda_matches_jax(seed, spread):
    x, y, valid = rows(seed, 90, 40, 5, n_valid=80, spread=spread)
    lam, rep = ttrain.select_ridge_lambda(t(x), t(y), t(valid), 8)
    jlam, jrep = jtrain.select_ridge_lambda(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(valid), 8)
    assert lam == jlam
    assert rep == jrep


def test_fit_fusion_alpha_matches_jax():
    x, y, _ = rows(6, 60, 32, 4, spread=1.5)

    def fold_fit(fe, fy, ve):   # the same head on both sides
        W = np.asarray(jtrain.ridge_solve(jnp.asarray(fe), jnp.asarray(fy),
                                          jnp.ones(len(fy), bool), 4, 1.0))
        return ve @ W

    alpha, rep = ttrain.fit_fusion_alpha(x, y, 4, fold_fit)
    jalpha, jrep = jtrain.fit_fusion_alpha(x, y, 4, fold_fit)
    assert alpha == jalpha
    np.testing.assert_allclose(rep["val_acc"], jrep["val_acc"], atol=1e-12)


@pytest.mark.parametrize("seed,new_ids", [(7, [5, 6]), (8, [4]), (9, [3, 5, 6])])
def test_fit_new_class_penalty_matches_jax(seed, new_ids):
    """The penalty may well be 0 (zero penalty wins ties); at least seed 7
    moves a class."""
    r = np.random.default_rng(seed)
    N, C = 60, 8
    sims = r.random((N, C)).astype(np.float32)
    labels = (np.arange(N) % 7).astype(np.int32)
    # new classes attract some old rows: raise their similarities
    sims[:, new_ids] += 0.15
    vmask = np.arange(N) < 55
    pvalid = np.arange(C) < 7
    want = np.asarray(jtrain.fit_new_class_penalty(
        jnp.asarray(sims), jnp.asarray(labels), jnp.asarray(vmask),
        jnp.asarray(pvalid), new_ids))
    # a small block forces the grid through several chunks
    got = ttrain.fit_new_class_penalty(t(sims), t(labels), t(vmask), t(pvalid),
                                       new_ids, max_block=5 * N * C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if seed == 7:
        assert (got.numpy()[new_ids] < 0).any()


def test_penalty_grid_matches_jax():
    want = np.asarray(jnp.concatenate([jnp.zeros((1,)), jnp.geomspace(1e-3, 0.5, 40)]))
    np.testing.assert_allclose(ttrain.penalty_grid().numpy(), want, rtol=1e-6)


TEXTS = ["my card has not arrived yet", "where is my new card",
         "i lost my card yesterday", "someone stole my wallet and card",
         "what is the exchange rate today", "how much is a euro in dollars",
         "my transfer never arrived", "the money i sent is missing",
         "card still not here after a week", "please block my lost card",
         "rates for converting pounds", "transfer pending for days"]
LABELS = [0, 0, 1, 1, 2, 2, 3, 3, 0, 1, 2, 3]


@pytest.mark.parametrize("grams,weight", [("auto", "auto"), ("char", "auto"),
                                          ("auto", 1.0)])
def test_resolve_config_matches_jax(grams, weight):
    enc = rows(10, len(TEXTS), 24, 4)[0]
    r = np.random.default_rng(11)
    enc_t = enc + 0.05 * r.standard_normal(enc.shape).astype(np.float32)
    texts_t = [s.replace("card", "crad") for s in TEXTS]
    views = (enc_t, texts_t) if grams == "auto" else None
    got = tlex.HashedTfidf(1024, weight, grams)
    got.resolve_config(enc, TEXTS, LABELS, typo_views=views)
    want = jlex.HashedTfidf(1024, weight, grams)
    want.resolve_config(enc, TEXTS, LABELS, typo_views=views)
    assert (got.grams, got.weight) == (want.grams, want.weight)
    assert got._df == want._df and got._n_docs == want._n_docs
    np.testing.assert_array_equal(got.transform(TEXTS), want.transform(TEXTS))
    np.testing.assert_array_equal(got.compose(enc, got.transform(TEXTS)),
                                  want.compose(enc, want.transform(TEXTS)))


def _jstate(st):
    return convert.memory_state_from_jax(st)


def _assert_states(got, want, atol=1e-6):
    np.testing.assert_array_equal(got.count.numpy(), want.count.numpy())
    np.testing.assert_allclose(got.pweight.numpy(), want.pweight.numpy())
    np.testing.assert_allclose(got.proto.numpy(), want.proto.numpy(), atol=atol)
    np.testing.assert_allclose(got.emb.numpy(), want.emb.numpy(), atol=atol)


def test_memory_transitions_match_jax():
    """Every class ends with 1 or >= 3 rows: two rows are equidistant from
    their mean, so their prune order is a rounding artefact in either
    package."""
    r = np.random.default_rng(12)
    C, E, D = 6, 8, 5
    st = tmem.init_state(C, E, D)
    jst = jmem.init_state(C, E, D)
    for cls in ([0, 0, 0, 1, 1, 1, -1], [2, 2, 2, 0, 1, -1, -1],
                [3, 3, 3, 3, 2, 4, 0]):
        emb = r.standard_normal((7, D)).astype(np.float32)
        cls = np.asarray(cls, np.int32)
        tmem.add_batch(st, t(emb), cls)
        jst = jmem.add_batch(jst, jnp.asarray(emb), jnp.asarray(cls))
        _assert_states(st, _jstate(jst))
    order = tmem.prune(st, 2)
    jst, jorder = jmem.prune(jst, 2)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    _assert_states(st, _jstate(jst))
    for n_cap in (16, 64):
        got = tmem.gather_training_set(st, n_cap)
        want = jmem.gather_training_set(jst, n_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_examples,slack", [(1000, 256), (3, 2), (4, 1)])
def test_prototype_memory_add_and_prune_match_jax(max_examples, slack):
    """Chunked appends with pruning; the port sends the chunks between two
    prunes to the device at once, the JAX package appends chunk by chunk."""
    cfg = {"max_examples_per_class": max_examples, "example_capacity_slack": slack,
           "class_capacity_buckets": [4, 8], "example_capacity_buckets": [2, 4, 8]}
    mem = tmem.PrototypeMemory(6, config=ModelConfig(cfg))
    jm = jmem.PrototypeMemory(6, config=JaxConfig(cfg))
    r = np.random.default_rng(13)
    for step in range(4):
        labels = [f"c{j}" for j in r.integers(0, 5, 9)]
        texts = [f"text {step} {i}" for i in range(9)]
        embs = r.standard_normal((9, 6)).astype(np.float32)
        mem.add_batch_host(texts, embs, labels)
        jm.add_batch_host(texts, embs, labels)
        assert mem.texts == jm.texts
        assert mem.label_to_index == jm.label_to_index
        _assert_states(mem.state, _jstate(jm.state), atol=1e-5)
    q = r.standard_normal(6).astype(np.float32)
    got, want = mem.get_nearest_prototypes(q, k=3), jm.get_nearest_prototypes(q, k=3)
    assert [l for l, _ in got] == [l for l, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    np.testing.assert_allclose(
        mem.sims_for(t(q[None])).numpy(),
        np.asarray(jm.sims_for(jnp.asarray(q[None]))), atol=1e-6)


def test_linear_head_init_and_growth():
    h = thead.init_head(10, 8)
    assert h["hidden"] == [] and h["out"]["w"].shape == (10, 8)
    assert not h["out"]["w"].any()
    h["out"]["w"][:, :3] = 1.0
    h["skip"] = {"w": torch.ones(10, 8)}
    g = thead.grow_capacity(h, 16)
    assert g["out"]["w"].shape == (10, 16) and g["skip"]["w"].shape == (10, 16)
    assert torch.equal(g["out"]["w"][:, :8], h["out"]["w"])
    assert not g["out"]["w"][:, 8:].any() and not g["out"]["b"][8:].any()
    assert thead.grow_capacity(g, 8) is g
    with pytest.raises(NotImplementedError, match="later slice"):
        thead.init_head(10, 8, hidden_dims=[4])


def test_head_params_from_jax():
    from adaptive_classifier_tpu.models import head as jhead
    import jax

    jp = jhead.init_head(jax.random.PRNGKey(0), 6, 8, 3, hidden_dims=[])
    jp = jhead.ensure_skip(jp, 6)
    got = convert.head_params_from_jax(jp)
    np.testing.assert_array_equal(got["out"]["w"].numpy(), np.asarray(jp["out"]["w"]))
    assert got["skip"]["w"].shape == (6, 8)
    x = np.random.default_rng(14).standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(thead.head_forward(got, t(x)).numpy(),
                               np.asarray(jhead.head_forward(jp, jnp.asarray(x))),
                               atol=1e-6)
