"""Strategic mode in the port against the JAX package (CPU).

- ``strategic.py``: the candidate sweep bit for bit; the best response
  picks the same candidate (at D 64, and at D 3 where the Gaussian filler
  exists, with the JAX package's noise handed to the port); both cost
  functions and the factory (dict coefficients included); the strategic
  loss within 1e-5; the robustness evaluation equal at gaming levels 0.0
  and 1.0, where it draws nothing that matters.
- The classifier on ``checkpoints/ac-tiny`` (float32 on both sides) with a
  ridge head: ``add_examples`` runs ``_strategic_ridge_refit`` for as many
  best-response rounds as the JAX package's, the head within 1e-4, the
  strategic / robust / dual / ``predict`` top-k labels identical and their
  scores within 1e-4, ``evaluate_strategic_robustness`` equal at 0.0 and
  1.0.  An MLP head's strategic pass is held with the JAX package's
  shuffle seed handed to the port.  Saving and loading go both ways.
- No strategic entry point swallows a kernel's error (the JAX package
  answers with the regular path instead); a cost configuration the
  factory refuses turns strategic mode off, as in the JAX package.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu import strategic as jstrategic
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert, strategic

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "checkpoints" / "ac-tiny")
SENTIMENT = json.loads((REPO / "data" / "sentiment.json").read_text())


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(_np(x).copy())


def _linear_probs(w):
    """softmax(z @ w) in both packages."""
    jw, tw = jnp.asarray(w), _t(w)
    return (lambda z: jax.nn.softmax(z @ jw, axis=-1),
            lambda z: torch.softmax(z @ tw, dim=-1))


# ---------------------------------------------------------------------------
# strategic.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,K", [(8, 50), (64, 50), (5, 50), (64, 20)])
def test_candidate_sweep_equals_jax(D, K):
    x = np.random.default_rng(D).standard_normal((3, D)).astype(np.float32)
    cost, jcost = (m.LinearCostFunction(np.full(D, 0.1, np.float32))
                   for m in (strategic, jstrategic))
    cost.num_candidates = jcost.num_candidates = K
    got = cost._generate_candidates(_t(x)).numpy()
    want = np.asarray(jcost._generate_candidates(jnp.asarray(x)))
    assert got.shape == want.shape == (3, K, D)
    np.testing.assert_array_equal(got, want)


def _hand_jax_noise(monkeypatch, key):
    """The port's Gaussian filler replaced by the JAX package's draw under
    ``key`` (its candidate noise, scaled by 0.5 in both)."""
    def noise(generator, shape, device):
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))

    monkeypatch.setattr(strategic, "_candidate_noise", noise)


@pytest.mark.parametrize("D,cost_type", [(64, "linear"), (64, "separable"), (3, "linear"),
                                         (3, "separable")])
def test_best_response_picks_the_same_candidate(monkeypatch, D, cost_type):
    r = np.random.default_rng(7 + D)
    x = r.standard_normal((32, D)).astype(np.float32)
    # logits of order 1: the probabilities stay off saturation, so no two
    # candidates tie within float32 rounding
    w = (r.standard_normal((D, 4)) * (0.5 / np.sqrt(D))).astype(np.float32)
    coeffs = np.abs(r.standard_normal(D)).astype(np.float32) * 0.05
    cost = strategic.CostFunctionFactory.create_cost_function(cost_type, coeffs)
    jcost = jstrategic.CostFunctionFactory.create_cost_function(cost_type, coeffs)
    jf, tf = _linear_probs(w)
    key = jax.random.PRNGKey(3)
    if D * 10 < cost.num_candidates - 1:
        _hand_jax_noise(monkeypatch, key)
    want = np.asarray(jcost.compute_best_response_batch(jnp.asarray(x), jf, key))
    got = cost.compute_best_response_batch(_t(x), tf).numpy()
    np.testing.assert_array_equal(got, want)
    # the chunked form gives the same rows
    chunked = cost.compute_best_response_chunked(_t(x), tf, chunk=5).numpy()
    if D * 10 >= cost.num_candidates - 1:
        np.testing.assert_array_equal(chunked, want)
    # and the agents do move; one row alone answers as in the batch
    assert np.any(got != x)
    np.testing.assert_array_equal(cost.compute_best_response(x[0], tf).numpy(), got[0])


def test_cost_functions_and_factory_match_jax():
    D = 8
    r = np.random.default_rng(0)
    x, y = r.standard_normal((2, D)).astype(np.float32)
    cands = r.standard_normal((4, 6, D)).astype(np.float32)
    xs = r.standard_normal((4, D)).astype(np.float32)
    cases = [("linear", np.full(D, 0.5, np.float32), {}),
             ("separable", np.full(D, 0.5, np.float32), {}),
             ("separable", np.linspace(0, 1, D).astype(np.float32),
              {"c2_coefficients": np.full(D, 0.3, np.float32)}),
             ("linear", [0.2] * 3, {}),                 # zero-padded to D
             ("linear", [0.7], {}),                     # a scalar, tiled
             ("linear", {"f0": 1.0, "f1": 0.5}, {}),    # dict: its own keys
             ("separable", {"a": 0.3}, {})]
    for cost_type, coeffs, kw in cases:
        c = strategic.CostFunctionFactory.create_cost_function(cost_type, coeffs, **kw)
        jc = jstrategic.CostFunctionFactory.create_cost_function(cost_type, coeffs, **kw)
        assert type(c).__name__ == type(jc).__name__
        assert c.feature_names == jc.feature_names
        for a, b in ((x, y), (y, x)):
            assert float(c.compute_cost(a, b)) == pytest.approx(
                float(jc.compute_cost(a, b)), abs=1e-6)
        np.testing.assert_allclose(
            c.compute_cost_batch(_t(xs), _t(cands)).numpy(),
            np.asarray(jc.compute_cost_batch(jnp.asarray(xs), jnp.asarray(cands))),
            atol=1e-6)
    # dict coefficients with explicit names; without them the classes refuse
    c = strategic.SeparableCostFunction({"f0": 1.0}, {"f0": 2.0}, feature_names=["f0", "f1"])
    assert c.c1.tolist() == [1.0, 0.0] and c.c2.tolist() == [2.0, 0.0]
    for cls in (strategic.SeparableCostFunction, jstrategic.SeparableCostFunction):
        with pytest.raises(ValueError):
            cls({"f0": 1.0}, {"f0": 1.0})
    with pytest.raises(ValueError):
        strategic.LinearCostFunction({"f0": 1.0})
    with pytest.raises(ValueError, match="Unknown cost function"):
        strategic.CostFunctionFactory.create_cost_function("bogus", np.ones(D))
    # moving down is free, moving up costs
    lin = strategic.LinearCostFunction(np.ones(D, np.float32))
    assert float(lin.compute_cost(np.zeros(D), np.full(D, 0.25))) == pytest.approx(2.0)
    assert float(lin.compute_cost(np.full(D, 0.25), np.zeros(D))) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_strategic_loss_terms_match_jax(seed):
    D, C = 16, 3
    r = np.random.default_rng(seed)
    w = r.standard_normal((D, C)).astype(np.float32)
    x = r.standard_normal((12, D)).astype(np.float32)
    y = (r.integers(0, C, 12)).astype(np.int32)
    coeffs = np.full(D, 0.01, np.float32)
    opt = strategic.StrategicOptimizer(strategic.SeparableCostFunction(coeffs, coeffs))
    jopt = jstrategic.StrategicOptimizer(jstrategic.SeparableCostFunction(coeffs, coeffs))
    tw = _t(w).requires_grad_(True)
    regular, penalty = opt.strategic_loss_terms(lambda z: z @ tw, _t(x),
                                                torch.from_numpy(y.astype(np.int64)))
    jreg, jpen = jopt.strategic_loss_terms(lambda z: z @ jnp.asarray(w), jnp.asarray(x),
                                           jnp.asarray(y), key=jax.random.PRNGKey(0))
    assert penalty.item() > 0
    assert regular.item() == pytest.approx(float(jreg), abs=1e-5)
    assert penalty.item() == pytest.approx(float(jpen), abs=1e-5)
    # the gradient of the combined loss, through the forward only
    loss = opt.strategic_loss(lambda z: z @ tw, _t(x), torch.from_numpy(y.astype(np.int64)),
                              0.5)
    (g,) = torch.autograd.grad(loss, tw)
    jg = jax.grad(lambda wj: jopt.strategic_loss(
        lambda z: z @ wj, jnp.asarray(x), jnp.asarray(y), 0.5,
        key=jax.random.PRNGKey(0)))(jnp.asarray(w))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)


def test_evaluate_robustness_matches_jax_at_levels_0_and_1():
    D = 16
    r = np.random.default_rng(4)
    x = r.standard_normal((40, D)).astype(np.float32)
    w = r.standard_normal((D, 3)).astype(np.float32)
    y = (x @ w).argmax(-1)
    y[::5] = (y[::5] + 1) % 3
    coeffs = np.full(D, 0.02, np.float32)
    ev = strategic.StrategicEvaluator(strategic.LinearCostFunction(coeffs))
    jev = jstrategic.StrategicEvaluator(jstrategic.LinearCostFunction(coeffs))
    got = ev.evaluate_robustness(lambda z: z @ _t(w), _t(x), torch.from_numpy(y),
                                 gaming_levels=[0.0, 1.0])
    want = jev.evaluate_robustness(lambda z: z @ jnp.asarray(w), jnp.asarray(x),
                                   jnp.asarray(y), gaming_levels=[0.0, 1.0])
    assert got == want
    assert got["accuracy_gaming_0.0"] == pytest.approx(0.8)
    assert got["robustness_score"] > 0
    # at 0.5 about half the rows game: between the two
    half = ev.evaluate_robustness(lambda z: z @ _t(w), _t(x), torch.from_numpy(y),
                                  gaming_levels=[0.0, 0.5, 1.0],
                                  generator=torch.Generator().manual_seed(0))
    assert got["accuracy_gaming_1.0"] <= half["accuracy_gaming_0.5"] <= \
        got["accuracy_gaming_0.0"]


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

def _rows(split, n):
    rows = [(t, lbl) for lbl in ("positive", "negative") for t in SENTIMENT[split][lbl][:n]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def _config(coeff, **extra):
    return {"head_type": "ridge", "ridge_lambda": 1.0, "compute_dtype": "float32",
            "embedding_cache_size": 0, "enable_strategic_mode": True,
            "cost_function_type": "linear", "cost_coefficients": coeff,
            "strategic_training_frequency": 2, **extra}


def _count_rounds(clf):
    """Wrap the cost function's chunked best response: one call per round
    of ``_strategic_ridge_refit``."""
    calls = []
    fn = clf.strategic_cost_function.compute_best_response_chunked

    def counted(x, f, *args, **kwargs):
        calls.append(int(x.shape[0]))
        return fn(x, f, *args, **kwargs)

    clf.strategic_cost_function.compute_best_response_chunked = counted
    return calls


#: (label, config, train rows per class, chunks): dict coefficients (0.5
#: and 0.1 on two features, the rest free) with the lexical channel and
#: typo-augmented rows carried through the strategic solve;
#: and free moves (cost 0) with the action-space block weighted 0 and λ 10,
#: where the best responses flip the solved head and the refit re-solves
CASES = [
    ("typo_augment_lexical", _config({"f0": 0.5, "f1": 0.1}, head_typo_augment=True,
                                     lexical_dim=512, lexical_grams="word",
                                     lexical_weight=1.0), 12, 1),
    ("free_moves", _config([0.0] * 128, ridge_lambda=10.0,
                           strategic_ridge_ext_weight=0.0), 12, 1),
]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def ridge_pair(request):
    label, config, n, chunks = request.param
    clf = AdaptiveClassifier(TINY, device="cpu", config=dict(config))
    jclf = JaxClassifier(TINY, config=dict(config))
    rounds = {"port": _count_rounds(clf), "jax": _count_rounds(jclf)}
    texts, labels = _rows("train", n)
    order = np.random.default_rng(0).permutation(len(texts))
    texts, labels = [texts[i] for i in order], [labels[i] for i in order]
    step = -(-len(texts) // chunks)
    for s in range(0, len(texts), step):
        clf.add_examples(texts[s:s + step], labels[s:s + step])
        jclf.add_examples(texts[s:s + step], labels[s:s + step])
    return clf, jclf, rounds, label


def test_strategic_ridge_refit_matches_jax(ridge_pair):
    """The same best-response rounds run (one add with free moves flips the
    solved head, so its refit re-solves) and the same head comes out."""
    clf, jclf, rounds, label = ridge_pair
    assert clf.strategic_mode and jclf.strategic_mode
    assert rounds["port"] == rounds["jax"] and rounds["port"]
    if label == "free_moves":
        assert len(rounds["port"]) > 1
    assert clf.train_steps == jclf.train_steps
    assert clf._fusion_alpha == jclf._fusion_alpha
    head = convert.head_params_from_jax(jclf.head_params)
    np.testing.assert_allclose(clf.head_params["out"]["w"].numpy(),
                               head["out"]["w"].numpy(), atol=1e-4)


@pytest.mark.parametrize("method", ["predict_strategic_batch", "predict_robust_batch",
                                    "_predict_dual_batch", "predict"])
def test_strategic_predictions_match_jax(ridge_pair, method):
    clf, jclf, _, _ = ridge_pair
    texts, _ = _rows("test", 12)
    if method == "predict":
        got = [clf.predict(t, k=2) for t in texts[::3]]
        want = [jclf.predict(t, k=2) for t in texts[::3]]
    else:
        got, want = getattr(clf, method)(texts, 2), getattr(jclf, method)(texts, 2)
    assert [[l for l, _ in row] for row in got] == [[l for l, _ in row] for row in want]
    np.testing.assert_allclose([s for row in got for _, s in row],
                               [s for row in want for _, s in row], atol=1e-4)


def test_evaluate_strategic_robustness_matches_jax(ridge_pair):
    clf, jclf, _, _ = ridge_pair
    texts, labels = _rows("test", 20)
    got = clf.evaluate_strategic_robustness(texts, labels, [0.0, 1.0])
    want = jclf.evaluate_strategic_robustness(texts, labels, [0.0, 1.0])
    assert got == pytest.approx(want, abs=1e-6)


def test_save_load_both_ways(ridge_pair, tmp_path):
    clf, jclf, _, _ = ridge_pair
    texts, _ = _rows("test", 6)
    jclf.save(str(tmp_path / "jax"), include_onnx=False, include_quantized=False)
    loaded = AdaptiveClassifier.load(tmp_path / "jax", device="cpu")
    clf.save(tmp_path / "port", include_quantized=False)
    jloaded = JaxClassifier.load(str(tmp_path / "port"))
    assert loaded.strategic_mode and jloaded.strategic_mode
    for a, b in ((loaded, jclf), (jloaded, clf)):
        for method in ("predict_strategic_batch", "predict_robust_batch"):
            got, want = getattr(a, method)(texts, 2), getattr(b, method)(texts, 2)
            assert [[l for l, _ in r] for r in got] == [[l for l, _ in r] for r in want]


def test_mlp_head_strategic_pass_matches_jax_with_its_seed(monkeypatch):
    """An MLP head's strategic pass (5 epochs of AdamW on the strategic
    loss): the port, given the JAX package's head and shuffle seed, ends
    at its head within 1e-4; periodic passes fire every
    ``strategic_training_frequency`` adds."""
    config = {"compute_dtype": "float32", "embedding_cache_size": 0, "epochs": 1,
              "enable_strategic_mode": True, "cost_function_type": "linear",
              "cost_coefficients": [0.05] * 128, "strategic_training_frequency": 1000}
    clf = AdaptiveClassifier(TINY, device="cpu", config=dict(config))
    jclf = JaxClassifier(TINY, config=dict(config))
    texts, labels = _rows("train", 10)
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    clf.head_params = convert.head_params_from_jax(jclf.head_params)
    _, sub = jax.random.split(jclf._rng)
    seed = int(np.asarray(jax.random.randint(sub, (), 0, np.iinfo(np.int32).max)))
    monkeypatch.setattr(clf, "_strategic_shuffle_seed", lambda: seed)
    clf._perform_strategic_training()
    jclf._perform_strategic_training()
    want = convert.head_params_from_jax(jclf.head_params)
    for got_l, want_l in zip(clf.head_params["hidden"] + [clf.head_params["out"]],
                             want["hidden"] + [want["out"]]):
        for k in ("w", "b"):
            np.testing.assert_allclose(got_l[k].numpy(), want_l[k].numpy(), atol=1e-4)
    test_texts, _ = _rows("test", 8)
    assert [[l for l, _ in r] for r in clf._predict_dual_batch(test_texts, 2)] == \
        [[l for l, _ in r] for r in jclf._predict_dual_batch(test_texts, 2)]
    # the periodic trigger: every add at frequency 1
    clf.config.strategic_training_frequency = 1
    passes = []
    original = clf._perform_strategic_training
    monkeypatch.setattr(clf, "_perform_strategic_training",
                        lambda: passes.append(1) or original())
    clf.add_examples(texts[:4], labels[:4])
    assert passes == [1]


def test_strategic_entry_points_propagate_kernel_errors(monkeypatch):
    """A kernel wrapper that raises (as B4's does on a CUDA error) reaches
    the caller from every strategic entry point."""
    from adaptive_classifier_tpu_torch.ops import knn

    clf = AdaptiveClassifier(TINY, device="cpu", config=_config([0.15] * 128))
    texts, labels = _rows("train", 4)
    clf.add_examples(texts, labels)

    def failing(*args, **kwargs):
        raise RuntimeError("masked_sims: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(knn, "masked_sims", failing)
    for call in (lambda: clf.predict_strategic_batch(texts, 2),
                 lambda: clf.predict_robust_batch(texts, 2),
                 lambda: clf._predict_dual_batch(texts, 2),
                 lambda: clf.predict(texts[0], 2),
                 lambda: clf.predict_strategic(texts[0], 2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            call()
    monkeypatch.undo()

    def failing_encoder(*args, **kwargs):
        raise RuntimeError("attention_qkv: CUDA error 719")

    monkeypatch.setattr(clf.encoder, "embed_ids", failing_encoder)
    for call in (lambda: clf.predict_strategic_batch(["a new text"], 2),
                 lambda: clf.predict_robust_batch(["another new text"], 2),
                 lambda: clf.evaluate_strategic_robustness(["a third text"], [labels[0]])):
        with pytest.raises(RuntimeError, match="CUDA error"):
            call()


@pytest.mark.parametrize("config,enabled", [
    ({"cost_function_type": "bogus", "cost_coefficients": [0.1] * 128}, False),
    ({"cost_function_type": "linear", "cost_coefficients": []}, True),
    ({"cost_function_type": "separable", "cost_coefficients": {"a": 0.2}}, True),
])
def test_strategic_config_errors_match_jax(config, enabled):
    """A cost type the factory refuses turns strategic mode off (config
    included); no coefficients leave it on in the config and off in use;
    both as in the JAX package."""
    full = {"enable_strategic_mode": True, **config}
    clf = AdaptiveClassifier(TINY, device="cpu", config=dict(full))
    jclf = JaxClassifier(TINY, config=dict(full))
    assert clf.config.enable_strategic_mode == jclf.config.enable_strategic_mode == enabled
    assert clf.strategic_mode == jclf.strategic_mode == bool(config["cost_coefficients"]
                                                             and enabled)
    if not clf.strategic_mode:
        with pytest.raises(ValueError, match="not enabled"):
            clf.evaluate_strategic_robustness(["x"], ["y"])
