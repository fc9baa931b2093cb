"""Temperature calibration on the port against the JAX package (CPU):
``scale_probs``, the NLL grid, the fitted temperature and its grid index,
ECE and the classifier's ``calibrate`` / ``predict_proba(calibrated=True)``
on identical inputs (``tests/test_calibration.py``'s cases, then the
cross-package ones).  Single ops to 1e-6."""

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu import calibration as jcal
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.calibration import (
    TemperatureScaler,
    _nll_curve,
    expected_calibration_error,
    log_grid,
    scale_probs,
)
from tests.conftest import synthetic_embed

CFG = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16],
       "example_capacity_buckets": [32, 128], "head_type": "ridge"}


def _synth(cls, **kw):
    clf = cls("prajjwal1/bert-tiny", config=dict(CFG), **kw)
    clf._get_embeddings = lambda texts: synthetic_embed(texts, dim=clf.embedding_dim)
    return clf


@pytest.fixture(scope="module")
def trained():
    texts = [f"cat:{i}" for i in range(8)] + [f"dog:{i}" for i in range(8)] \
        + [f"fox:{i}" for i in range(8)]
    labels = ["cat"] * 8 + ["dog"] * 8 + ["fox"] * 8
    clf, jclf = _synth(AdaptiveClassifier, device="cpu"), _synth(JaxClassifier)
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    return clf, jclf


def _seeded_probs(seed, N=500, C=5, T=0.5):
    """Overconfident distributions and labels drawn from the calibrated ones."""
    rng = np.random.default_rng(seed)
    true = rng.dirichlet(np.ones(C) * 2.0, size=N).astype(np.float32)
    labels = np.asarray([rng.choice(C, p=row / row.sum()) for row in true], np.int32)
    return np.array(jcal.scale_probs(true, T)), labels


def test_predict_proba_rows_are_distributions(trained):
    clf, _ = trained
    probs, labels = clf.predict_proba(["cat:91", "dog:92", "fox:93"])
    assert probs.shape == (3, 3)
    assert sorted(labels) == ["cat", "dog", "fox"]
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert (probs >= 0).all()
    for row, text in zip(probs, ["cat:91", "dog:92", "fox:93"]):
        assert labels[int(row.argmax())] == clf.predict(text, k=1)[0][0]


def test_predict_proba_single_string_and_empty(trained):
    clf, _ = trained
    probs, labels = clf.predict_proba("cat:55")
    assert probs.shape == (1, 3)
    with pytest.raises(ValueError):
        clf.predict_proba([])


def test_scale_probs_identity_and_flattening():
    p = torch.tensor([[0.7, 0.2, 0.1], [0.05, 0.9, 0.05]])
    torch.testing.assert_close(scale_probs(p, 1.0), p, atol=1e-6, rtol=0)
    hot = scale_probs(p, 10.0)
    assert hot[0].max() < p[0].max()
    cold = scale_probs(p, 0.1)
    assert cold[0].max() > p[0].max()
    out = scale_probs(torch.tensor([[0.5, 0.5, 0.0]]), 2.0)
    assert out[0, 2] == 0.0
    torch.testing.assert_close(out.sum(axis=1), torch.ones(1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("T", [0.1, 0.5, 1.0, 3.0, 17.0])
def test_scale_probs_matches_jax(T):
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(6), size=40).astype(np.float32)
    p[::7, 2] = 0.0
    got = scale_probs(torch.from_numpy(p), T).numpy()
    want = np.asarray(jcal.scale_probs(p, T))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[::7, 2] == 0).all()


def test_nll_curve_and_grids_match_jax():
    import jax.numpy as jnp

    probs, labels = _seeded_probs(4)
    grid = log_grid(float(np.log10(np.float32(0.05))), float(np.log10(np.float32(20.0))), 64)
    jgrid = np.asarray(jnp.logspace(jnp.log10(0.05), jnp.log10(20.0), 64))
    # the same construction; XLA rounds its fused float32 steps differently
    np.testing.assert_allclose(grid.numpy(), jgrid, rtol=1e-6, atol=0)
    np.testing.assert_allclose(log_grid(-0.12, 0.12, 33).numpy(),
                               np.asarray(jnp.logspace(-0.12, 0.12, 33)), rtol=1e-6, atol=0)
    got = _nll_curve(torch.from_numpy(probs), torch.from_numpy(labels.astype(np.int64)), grid)
    want = np.asarray(jcal._nll_curve(jnp.asarray(probs), jnp.asarray(labels),
                                      jnp.asarray(jgrid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,T", [(0, 0.5), (1, 2.0), (2, 0.25), (5, 1.0)])
def test_fitted_temperature_and_grid_index_match_jax(seed, T):
    import jax.numpy as jnp

    probs, labels = _seeded_probs(seed, T=T)
    ours = TemperatureScaler(device="cpu").fit(probs, labels)
    theirs = jcal.TemperatureScaler().fit(probs, labels)
    assert ours.temperature == pytest.approx(theirs.temperature, rel=1e-6)
    # the JAX fine grid around its coarse winner, and the index it chose there
    jp, jl = jnp.asarray(probs), jnp.asarray(labels)
    coarse = jnp.logspace(jnp.log10(0.05), jnp.log10(20.0), 64)
    fine = coarse[jnp.argmin(jcal._nll_curve(jp, jl, coarse))] * jnp.logspace(-0.12, 0.12, 33)
    assert ours.grid_index == int(jnp.argmin(jcal._nll_curve(jp, jl, fine)))
    np.testing.assert_allclose(ours.transform(probs), theirs.transform(probs),
                               atol=1e-6, rtol=0)


def test_scaler_recovers_known_temperature():
    rng = np.random.default_rng(0)
    N, C = 2000, 4
    true = rng.dirichlet(np.ones(C) * 2.0, size=N).astype(np.float32)
    labels = np.asarray([rng.choice(C, p=row) for row in true], np.int32)
    overconfident = scale_probs(torch.from_numpy(true), 0.5).numpy()
    scaler = TemperatureScaler(device="cpu").fit(overconfident, labels)
    assert 1.5 < scaler.temperature < 2.7, scaler.temperature
    fixed = scaler.transform(overconfident)
    assert (expected_calibration_error(fixed, labels)
            < expected_calibration_error(overconfident, labels))


def test_ece_matches_jax():
    probs, labels = _seeded_probs(7)
    for bins in (5, 15):
        assert expected_calibration_error(probs, labels, bins) == \
            jcal.expected_calibration_error(probs, labels, bins)


def test_classifier_calibrate_roundtrip(trained):
    """The report and the calibrated rows equal the JAX package's on the
    same classifier state."""
    clf, jclf = trained
    hold_texts = [f"{c}:{i}" for c in ("cat", "dog", "fox") for i in range(100, 106)]
    hold_labels = [c for c in ("cat", "dog", "fox") for _ in range(6)]
    report = clf.calibrate(hold_texts, hold_labels)
    assert report["nll_after"] <= report["nll_before"] + 1e-6
    assert report["temperature"] > 0
    probs, _ = clf.predict_proba(hold_texts, calibrated=True)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    jreport = jclf.calibrate(hold_texts, hold_labels)
    assert report["temperature"] == pytest.approx(jreport["temperature"], rel=1e-6)
    for key in ("nll_before", "nll_after", "ece_before", "ece_after"):
        assert report[key] == pytest.approx(jreport[key], abs=1e-4), key
    jprobs, _ = jclf.predict_proba(hold_texts, calibrated=True)
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)


def test_calibrated_requires_fit():
    clf = _synth(AdaptiveClassifier, device="cpu")
    clf.add_examples(["a:1", "b:1", "a:2", "b:2"], ["a", "b", "a", "b"])
    with pytest.raises(RuntimeError):
        clf.predict_proba(["a:9"], calibrated=True)


def test_calibrate_rejects_unknown_labels(trained):
    clf, _ = trained
    with pytest.raises(ValueError):
        clf.calibrate(["x:1"], ["never-seen-label"])


def test_scaler_runs_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TemperatureScaler()
