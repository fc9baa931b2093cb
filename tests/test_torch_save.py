"""Saving on the port against the JAX package (CPU, float32): the file set
and JSON keys of a checkpoint, checkpoints crossing between the packages
with the same predictions (labels, and scores within 1e-4), the int8
encoder export in both formats, and k-means as ``tests/test_kmeans.py``
holds the JAX package's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.models.encoder import Encoder as JaxEncoder
from adaptive_classifier_tpu.quantization import save_quantized_encoder as jax_save_quantized
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.models.encoder import Encoder
from adaptive_classifier_tpu_torch.ops.kmeans import kmeans_fit, representative_indices
from adaptive_classifier_tpu_torch.quantization import save_quantized_encoder

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "checkpoints" / "ac-tiny")
INTENTS = json.loads((REPO / "data" / "intents.json").read_text())
SMALL = {"train_size_buckets": [64, 256], "class_capacity_buckets": [8, 16, 32],
         "example_capacity_buckets": [32, 128], "compute_dtype": "float32",
         "embedding_cache_size": 0}
CONFIGS = {
    "default": dict(SMALL),
    # the lexical channel's knobs fixed: the save carries lexical.json and
    # the fitted fusion share without the first batch's sweeps
    "ridge_lexical": {**SMALL, "head_type": "ridge", "lexical_dim": 1024,
                      "lexical_grams": "word", "lexical_weight": 1.0,
                      "fusion_weights": "auto", "ridge_lambda": 1.0},
}


def rows(block, step=1):
    if block == "test":
        r = [(t, l) for l in INTENTS["train"] for t in INTENTS["test"][l]]
    else:
        r = [(t, l) for l, ts in INTENTS[block].items() for t in ts]
    r = r[::step]
    return [t for t, _ in r], [l for _, l in r]


def build(cls, config, **kw):
    clf = cls(TINY, config=dict(config), **kw)
    for block in ("train", "new_classes"):
        clf.add_examples(*rows(block, step=2))
    return clf


def assert_same_predictions(got, want, atol=1e-4):
    assert [[l for l, _ in r] for r in got] == [[l for l, _ in r] for r in want]
    np.testing.assert_allclose([[s for _, s in r] for r in got],
                               [[s for _, s in r] for r in want], atol=atol)


def listing(path: Path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The default config built in both packages, each saved."""
    root = tmp_path_factory.mktemp("saved")
    clf = build(AdaptiveClassifier, CONFIGS["default"], device="cpu")
    jclf = build(JaxClassifier, CONFIGS["default"])
    clf.save(root / "port")
    jclf.save(str(root / "jax"))
    return clf, jclf, root


def test_file_set_and_json_keys_match_jax(saved):
    clf, jclf, root = saved
    assert listing(root / "port") == listing(root / "jax")
    assert {"config.json", "examples.json", "model.safetensors", "README.md",
            "quantized/model_int8.safetensors", "quantized/quantize_config.json",
            "quantized/vocab.txt"} <= set(listing(root / "port"))
    cfg, jcfg = (json.loads((root / d / "config.json").read_text()) for d in ("port", "jax"))
    assert sorted(cfg) == sorted(jcfg)
    assert sorted(cfg["config"]) == sorted(jcfg["config"])
    for key in ("model_name", "embedding_dim", "label_to_id", "id_to_label", "train_steps",
                "training_history", "config", "ac_seed", "library_name"):
        assert cfg[key] == jcfg[key], key
    ex, jex = (json.loads((root / d / "examples.json").read_text()) for d in ("port", "jax"))
    assert sorted(ex) == sorted(jex)
    for label, items in ex.items():
        assert len(items) == len(jex[label]) == min(5, len(clf.memory.texts[label]))
        assert sorted(items[0]) == sorted(jex[label][0])
        assert {d["text"] for d in items} <= set(clf.memory.texts[label])
    t, jt = (load_file(str(root / d / "model.safetensors")) for d in ("port", "jax"))
    assert sorted(t) == sorted(jt)
    for k in t:
        assert t[k].shape == jt[k].shape and t[k].dtype == jt[k].dtype, k
    for label in clf.label_to_id:
        np.testing.assert_allclose(t[f"prototype_{label}"], jt[f"prototype_{label}"], atol=1e-5)
    np.testing.assert_allclose(t["proto_calibration_bias"], jt["proto_calibration_bias"],
                               atol=1e-5)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_port_save_loads_in_jax(config, tmp_path, saved):
    clf = saved[0] if config == "default" else build(AdaptiveClassifier, CONFIGS[config],
                                                     device="cpu")
    clf.save(tmp_path / "ckpt", include_quantized=False)
    assert (tmp_path / "ckpt" / "lexical.json").exists() == (config == "ridge_lexical")
    jclf = JaxClassifier.load(str(tmp_path / "ckpt"))
    texts, _ = rows("test", step=4)
    assert_same_predictions(jclf.predict_batch(texts, k=3), clf.predict_batch(texts, k=3))
    assert_same_predictions([jclf.predict(t, k=3) for t in texts[:5]],
                            [clf.predict(t, k=3) for t in texts[:5]])


def test_jax_save_loads_on_the_port(saved):
    _, jclf, root = saved
    clf = AdaptiveClassifier.load(root / "jax", device="cpu")
    assert len(clf.head_params["hidden"]) == 2
    texts, _ = rows("test", step=4)
    assert_same_predictions(clf.predict_batch(texts, k=3), jclf.predict_batch(texts, k=3))
    probs, labels = clf.predict_proba(texts[:6])
    jprobs, jlabels = jclf.predict_proba(texts[:6])
    assert labels == jlabels
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)
    # the loaded classifier grows again: a lossy replay store, frozen probe
    clf.add_examples(["where do I collect lost property", "I left my bag on the bus"],
                     ["lost_item"] * 2)
    assert "skip" in clf.head_params and clf.last_fit.epochs_run >= 1


def test_stats_and_model_card(saved):
    clf, jclf, root = saved
    assert clf.get_memory_stats() == jclf.get_memory_stats()
    stats, jstats = clf.get_example_statistics(), jclf.get_example_statistics()
    assert stats == jstats
    card = (root / "port" / "README.md").read_text()
    assert f"Number of Classes: {len(clf.label_to_id)}" in card
    assert "adaptive_classifier_tpu_torch" in card


# ---------------------------------------------------------------------------
# the int8 encoder export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["standard", "runtime_int8_tree"])
def test_quantized_export_matches_jax(fmt, tmp_path):
    quant = "int8" if fmt == "runtime_int8_tree" else None
    save_quantized_encoder(Encoder(TINY, device="cpu", quantization=quant,
                                   compute_dtype="float32"), tmp_path / "port")
    jax_save_quantized(JaxEncoder(TINY, compute_dtype="float32", quantization=quant),
                       tmp_path / "jax")
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    cfg, jcfg = (json.loads((tmp_path / d / "quantize_config.json").read_text())
                 for d in ("port", "jax"))
    assert cfg["format"] == fmt
    for key in ("scheme", "format", "encoder_config", "encoder_pretrained"):
        assert cfg[key] == jcfg[key], key
    assert {k: sorted(v) for k, v in cfg["manifest"].items()} == \
        {k: sorted(v) for k, v in jcfg["manifest"].items()}
    assert (tmp_path / "port" / "vocab.txt").read_text() == \
        (tmp_path / "jax" / "vocab.txt").read_text()
    t = load_file(str(tmp_path / "port" / "model_int8.safetensors"))
    jt = load_file(str(tmp_path / "jax" / "model_int8.safetensors"))
    assert sorted(t) == sorted(jt)
    for k in t:
        assert t[k].dtype == jt[k].dtype and t[k].shape == jt[k].shape, k
        if fmt == "runtime_int8_tree" and k.endswith(".scale"):
            # XLA computes absmax / 127 as absmax * (1/127) under jit
            np.testing.assert_array_max_ulp(t[k], jt[k], maxulp=1)
        elif fmt == "runtime_int8_tree" and k.endswith(".int8"):
            # a one-ulp scale moves a value on a rounding tie by one step
            diff = np.abs(t[k].astype(np.int32) - jt[k].astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, k
        else:
            np.testing.assert_array_equal(t[k], jt[k], err_msg=k)


def test_quantized_export_loads_back(tmp_path):
    """An export of a float encoder restores, on a machine without the base
    checkpoint, an encoder that embeds as the int8 round trip of it."""
    enc = Encoder(TINY, device="cpu", compute_dtype="float32")
    save_quantized_encoder(enc, tmp_path)
    back = Encoder.from_quantized_export(tmp_path, "gone/model", device="cpu",
                                         compute_dtype="float32")
    texts = ["where is my card?", "change my PIN"]
    cos = torch.nn.functional.cosine_similarity(enc.embed(texts), back.embed(texts))
    assert cos.min() > 0.99


# ---------------------------------------------------------------------------
# k-means, as tests/test_kmeans.py holds the JAX package's
# ---------------------------------------------------------------------------

def clustered(n_per=20, k=3, dim=8, seed=0, n_cap=64):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((k, dim)).astype(np.float32) * 5
    x = np.concatenate([centers[i] + 0.1 * r.standard_normal((n_per, dim)).astype(np.float32)
                        for i in range(k)])
    pad = np.zeros((n_cap, dim), np.float32)
    pad[:len(x)] = x
    return torch.from_numpy(pad), torch.arange(n_cap) < len(x), centers


def test_kmeans_finds_cluster_centers():
    x, valid, centers = clustered()
    got = kmeans_fit(x, valid, torch.Generator().manual_seed(0), k=3).numpy()
    for c in centers:
        assert np.linalg.norm(got - c, axis=1).min() < 0.5


def test_kmeans_deterministic():
    x, valid, _ = clustered()
    a = kmeans_fit(x, valid, torch.Generator().manual_seed(7), k=3)
    b = kmeans_fit(x, valid, torch.Generator().manual_seed(7), k=3)
    assert torch.equal(a, b)


def test_representative_indices_one_per_cluster_and_ignore_padding():
    x, valid, _ = clustered(n_per=10)
    idx = representative_indices(x, valid, torch.Generator().manual_seed(0), k=3).numpy()
    assert len(idx) == 3 and all(0 <= i < 30 for i in idx)
    assert len({int(i) // 10 for i in idx}) == 3
    poisoned = x.clone()
    poisoned[~valid] = 1e3
    idx = representative_indices(poisoned, valid, torch.Generator().manual_seed(0), k=3)
    assert valid[idx].all()
