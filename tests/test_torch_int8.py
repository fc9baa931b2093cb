"""The port's int8 path against the JAX package's, on identical inputs (CPU).

- Weight quantization: int8 values and scales equal bit for bit to the JAX
  functions (``quantize_weight``, ``quantize_encoder_for_inference``), run
  as written.  Under ``jax.jit`` XLA rewrites ``absmax / 127`` as
  ``absmax · (1/127)``, which moves some scales by one ulp; the JAX
  ``Encoder`` quantizes under jit, so the classifier-level comparisons
  below hold the port by tolerance, not bits.
- Kernels B2, B9, B3 and B8: the port's plain versions (what a CPU tensor
  takes) against the Pallas kernels in interpret mode.  B2's int8 operands
  and int32 sums are exact: only the epilogue's rounding may differ.  B3
  and B8 requantize a GELU output: a last-ulp difference of tanh, or a
  scale XLA computed by reciprocal, can move one int8 value by one step.
- The int8 forward, fused and not, in float32 and bfloat16; then whole
  classifiers: add_examples on the production config, and the restore of
  a checkpoint's int8 export when the base encoder is missing.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models import encoder_int8 as jenc8
from adaptive_classifier_tpu.ops import ffn_int8 as jffn
from adaptive_classifier_tpu.ops import matmul_int8 as jm8
from adaptive_classifier_tpu_torch import AdaptiveClassifier, convert, quantization
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models import encoder_int8 as tenc8
from adaptive_classifier_tpu_torch.ops import ffn_int8, matmul_int8

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "checkpoints" / "ac-tiny"
INTENTS = json.loads((REPO / "data" / "intents.json").read_text())

_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps", "pad_token_id", "arch", "pooling", "pool_layer")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def row_cosine(a, b):
    a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def report(name, got, want):
    """Largest error and smallest row cosine, printed for the record."""
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    cos = float(row_cosine(got, want).min())
    print(f"{name}: max abs error {err:.3g}, min row cosine {cos:.8f}")
    return err, cos


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,outlier", [((128, 384), False), ((512, 128), True),
                                           ((64, 1536), False)])
def test_quantize_weight_matches_jax(shape, outlier):
    r = np.random.default_rng(sum(shape))
    w = (r.standard_normal(shape) * 0.05).astype(np.float32)
    if outlier:
        w[:, 3] *= 100.0
    w[:, 5] = 0.0          # an all-zero column takes the 1e-8 floor
    q, s = quantization.quantize_weight(_t(w))
    jq, js = jenc8.quantize_weight(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _assert_int8_state_equal(params, jtree):
    want = convert.encoder_int8_params_from_jax(jtree)
    assert set(params) == set(want)
    for k, v in want.items():
        assert params[k].dtype == v.dtype, k
        np.testing.assert_array_equal(params[k].numpy(), v.numpy(), err_msg=k)


def test_quantize_encoder_matches_jax_on_a_random_tree():
    jcfg = jenc.EncoderConfig(vocab_size=97, hidden_size=128, num_layers=3,
                              num_heads=2, intermediate_size=256)
    jparams = jenc.init_params(5, jcfg)
    params = quantization.quantize_encoder_for_inference(
        convert.encoder_params_from_jax(jparams))
    _assert_int8_state_equal(params, jenc8.quantize_encoder_for_inference(jparams))


def test_quantize_encoder_matches_jax_on_ac_tiny():
    """The port's int8 Encoder quantizes the float32 checkpoint (not its
    bf16 matrices): values and scales equal the JAX function's."""
    jax_enc = jenc.Encoder(str(TINY), compute_dtype="float32")
    enc = tenc.Encoder(str(TINY), device="cpu", quantization="int8")
    assert enc.quantization == "int8"
    assert enc.params["layers.1.ffn_in_w.int8"].shape == (128, 512)
    # row-major, as the kernels take them (the checkpoint's are column-major)
    assert all(v.is_contiguous() for v in enc.params.values())
    _assert_int8_state_equal(enc.params,
                             jenc8.quantize_encoder_for_inference(jax_enc.params))


def test_auto_quantization_resolves_to_float():
    enc = tenc.Encoder(str(TINY), device="cpu", quantization="auto")
    assert enc.quantization is None
    assert tenc.resolve_quantization("auto", torch.device("cpu")) is None
    assert tenc.resolve_quantization(None, torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _layer_problem(seed, M, D, N):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, D)).astype(np.float32)
    w = (r.standard_normal((D, N)) * 0.05).astype(np.float32)
    b = (r.standard_normal(N) * 0.1).astype(np.float32)
    jw, js = jenc8.quantize_weight(jnp.asarray(w))
    return x, np.asarray(jw), np.asarray(js), b


@pytest.mark.parametrize("M", [256, 200])
def test_quant_matmul_plain_matches_pallas(M):
    x, w_q, s, b = _layer_problem(M, M, 128, 384)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm8.quant_matmul_int8(jnp.asarray(x), jnp.asarray(w_q),
                                                jnp.asarray(s), jnp.asarray(b)))
    got = matmul_int8.quant_matmul_int8(_t(x), _t(w_q), _t(s), _t(b))
    assert got.dtype == torch.float32 and got.shape == (M, 384)
    err, _ = report(f"B2 M={M}", got.numpy(), want)
    assert err <= 1e-5


@pytest.mark.parametrize("M", [256, 200])
def test_proj_residual_ln_plain_matches_pallas(M):
    x, w_q, s, b = _layer_problem(M + 1, M, 128, 128)
    r = np.random.default_rng(M)
    res = r.standard_normal((M, 128)).astype(np.float32)
    g = (r.standard_normal(128) * 0.2 + 1.0).astype(np.float32)
    beta = (r.standard_normal(128) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm8.proj_residual_ln_int8(
            jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b),
            jnp.asarray(res), jnp.asarray(g), jnp.asarray(beta), 1e-12))
    got = matmul_int8.proj_residual_ln_int8(_t(x), _t(w_q), _t(s), _t(b), _t(res),
                                            _t(g), _t(beta), 1e-12)
    err, _ = report(f"B9 M={M}", got.numpy(), want)
    assert err <= 1e-4


def _ffn_problem(seed, M, D=128, F=512):
    r = np.random.default_rng(seed)
    h = (r.standard_normal((M, D)) * 0.5).astype(np.float32)
    ctx = (r.standard_normal((M, D)) * 0.5).astype(np.float32)
    mats = {}
    for name, shape in (("o", (D, D)), ("w1", (D, F)), ("w2", (F, D))):
        q, s = jenc8.quantize_weight(jnp.asarray(
            (r.standard_normal(shape) * 0.05).astype(np.float32)))
        mats[name] = (np.asarray(q), np.asarray(s),
                      (r.standard_normal(shape[1]) * 0.01).astype(np.float32))
    lns = [((1.0 + 0.1 * r.standard_normal(D)).astype(np.float32),
            (0.1 * r.standard_normal(D)).astype(np.float32)) for _ in range(2)]
    return h, ctx, mats, lns


# two problems at each M: seeds M and M + 3
@pytest.mark.parametrize("M,seed", [(512, 512), (320, 320), (512, 515), (320, 323)],
                         ids=["512", "320", "512-seed515", "320-seed323"])
def test_ffn_block_plain_matches_pallas(M, seed):
    h, _, m, lns = _ffn_problem(seed, M)
    args = (*m["w1"], *m["w2"], *lns[0])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jffn.ffn_block_int8(
            jnp.asarray(h), *[jnp.asarray(a) for a in args], 1e-12))
    got = ffn_int8.ffn_block_int8(_t(h), *[_t(a) for a in args], 1e-12)
    err, cos = report(f"B3 M={M} seed={seed}", got.numpy(), want)
    assert cos >= 0.9999 and err <= 0.05


@pytest.mark.parametrize("M", [512, 320])
def test_attn_ffn_block_plain_matches_pallas(M):
    h, ctx, m, lns = _ffn_problem(M + 7, M)
    args = (*m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jffn.attn_ffn_block_int8(
            jnp.asarray(ctx), jnp.asarray(h), *[jnp.asarray(a) for a in args], 1e-12))
    got = ffn_int8.attn_ffn_block_int8(_t(ctx), _t(h), *[_t(a) for a in args], 1e-12)
    err, cos = report(f"B8 M={M}", got.numpy(), want)
    assert cos >= 0.9999 and err <= 0.05


def test_gelu_tanh_matches_jax():
    x = np.linspace(-6.0, 6.0, 4001).astype(np.float32)
    np.testing.assert_allclose(ffn_int8._gelu_tanh(_t(x)).numpy(),
                               np.asarray(jffn._gelu_tanh(jnp.asarray(x))), atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, w_q, s, b = _layer_problem(0, 64, 128, 384)
    with pytest.raises(ValueError, match="multiple of 128"):
        matmul_int8.quant_matmul_int8(_t(x[:, :100]), _t(w_q[:100]), _t(s), _t(b))
    with pytest.raises(ValueError, match="int8"):
        matmul_int8.quant_matmul_int8(_t(x), _t(w_q.astype(np.float32)), _t(s), _t(b))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul_int8.quant_matmul_int8(_t(x).double(), _t(w_q), _t(s), _t(b))
    with pytest.raises(ValueError, match="multiple of 64"):
        matmul_int8.quant_matmul_int8(_t(x), _t(w_q[:, :100]), _t(s[:100]), _t(b[:100]))


# ---------------------------------------------------------------------------
# the int8 forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_encoder():
    jcfg = jenc.EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                              num_heads=2, intermediate_size=256,
                              max_position_embeddings=64, pooling="mean")
    jq = jenc8.quantize_encoder_for_inference(jenc.init_params(0, jcfg))
    cfg = tenc.EncoderConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS})
    r = np.random.default_rng(2)
    ids = r.integers(1, 512, size=(8, 32)).astype(np.int32)
    lens = r.integers(4, 33, size=8)
    lens[0] = 32
    mask = (np.arange(32)[None, :] < lens[:, None]).astype(np.int32)
    return jcfg, jq, cfg, convert.encoder_int8_params_from_jax(jq), ids, mask


@pytest.mark.parametrize("fuse_o_proj", [False, True])
def test_fused_forward_matches_jax(small_encoder, fuse_o_proj):
    jcfg, jq, cfg, params, ids, mask = small_encoder
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc8.encoder_forward_int8(
            jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.float32,
            use_fused_ffn=True, fuse_o_proj=fuse_o_proj))
    got = tenc8.encoder_forward_int8(params, _t(ids), _t(mask), cfg,
                                     compute_dtype=torch.float32, use_fused_ffn=True,
                                     fuse_o_proj=fuse_o_proj)
    _, cos = report(f"fused forward fuse_o_proj={fuse_o_proj}", got.numpy(), want)
    assert cos >= 0.9999


def test_forward_matches_jax_on_the_cpu_path(small_encoder):
    """use_fused_ffn=None: the non-fused path in both packages on the CPU."""
    jcfg, jq, cfg, params, ids, mask = small_encoder
    want = np.asarray(jenc8.encoder_forward_int8(
        jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.float32))
    got = tenc8.encoder_forward_int8(params, _t(ids), _t(mask), cfg,
                                     compute_dtype=torch.float32)
    err, cos = report("non-fused forward", got.numpy(), want)
    assert cos >= 0.9999 and err <= 0.05
    emb = tenc8.embed_texts_device_int8(params, _t(ids), _t(mask), cfg,
                                        compute_dtype=torch.float32, pooling="mean")
    jemb = jenc8.embed_texts_device_int8(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                         compute_dtype=jnp.float32, pooling="mean")
    assert row_cosine(emb.numpy(), jemb).min() >= 0.9999
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=1), 1.0, atol=1e-5)


def test_bf16_forward_matches_jax(small_encoder):
    jcfg, jq, cfg, params, ids, mask = small_encoder
    want = np.asarray(jenc8.encoder_forward_int8(
        jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, compute_dtype=jnp.bfloat16))
    got = tenc8.encoder_forward_int8(params, _t(ids), _t(mask), cfg,
                                     compute_dtype=torch.bfloat16)
    _, cos = report("bf16 forward", got.numpy(), want)
    assert cos >= 0.999


def test_int8_forward_stays_near_the_float_forward():
    """ac-tiny, int8 vs float32 forward: the JAX package's envelope."""
    texts = [t for rows in INTENTS["test"].values() for t in rows][:64]
    enc8 = tenc.Encoder(str(TINY), compute_dtype="float32", device="cpu",
                        quantization="int8")
    enc = tenc.Encoder(str(TINY), compute_dtype="float32", device="cpu")
    assert row_cosine(enc8.embed(texts).numpy(), enc.embed(texts).numpy()).min() > 0.99


# ---------------------------------------------------------------------------
# whole classifiers
# ---------------------------------------------------------------------------

def intents_rows(block):
    if block in ("train", "new_classes"):
        rows = [(t, lbl) for lbl, ts in INTENTS[block].items() for t in ts]
    else:
        rows = [(t, lbl) for lbl in INTENTS["train"] for t in INTENTS["test"][lbl]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def assert_same_predictions(got, want, atol):
    assert [row[0][0] for row in got] == [row[0][0] for row in want]
    for g, w in zip(got, want):
        gs = dict(g)
        for label, score in w:
            if label in gs:
                assert abs(gs[label] - score) <= atol, (label, gs[label], score)


#: the zoo's build config (checkpoints/zoo/manifest.json), int8, float32
PRODUCTION_INT8 = {"lexical_dim": 32768, "head_type": "ridge", "fusion_weights": "auto",
                   "ridge_lambda": "auto", "compute_dtype": "float32",
                   "embedding_cache_size": 0, "quantization": "int8"}


def test_int8_classifier_add_examples_matches_jax():
    """Both packages on the same int8 weights (the JAX Encoder's, which XLA
    quantized under jit): the same resolved knobs and predictions."""
    clf = AdaptiveClassifier(str(TINY), device="cpu", config=dict(PRODUCTION_INT8))
    jclf = JaxClassifier(str(TINY), config=dict(PRODUCTION_INT8))
    assert clf.encoder.quantization == jclf.encoder.quantization == "int8"
    clf.encoder.params = convert.encoder_int8_params_from_jax(jclf.encoder.params)
    texts, labels = intents_rows("train")
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    assert (clf.lexical.grams, clf.lexical.weight, clf.config.ridge_lambda,
            clf._fusion_alpha) == (jclf.lexical.grams, jclf.lexical.weight,
                                   jclf.config.ridge_lambda, jclf._fusion_alpha)
    test, _ = intents_rows("test")
    emb = clf.encoder.embed(test).numpy()
    jemb = np.asarray(jclf.encoder.embed(test))
    assert row_cosine(emb, jemb).min() >= 0.9999
    assert_same_predictions(clf.predict_batch(test, k=3), jclf.predict_batch(test, k=3),
                            atol=1e-3)


_RESTORE_CFG = {"head_type": "ridge", "train_size_buckets": [64],
                "class_capacity_buckets": [16],
                "example_capacity_buckets": [32], "embedding_cache_size": 0,
                "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def saved_exports(tmp_path_factory):
    """ac-tiny classifiers saved by the JAX package from a float encoder
    (the ``standard`` export) and from an int8 one (``runtime_int8_tree``),
    then the base encoder removed."""
    root = tmp_path_factory.mktemp("exports")
    enc = root / "enc"
    shutil.copytree(TINY, enc)
    texts, labels = intents_rows("train")
    out = {}
    for fmt, quant in (("standard", None), ("runtime_int8_tree", "int8")):
        jclf = JaxClassifier(str(enc), config={**_RESTORE_CFG, "quantization": quant})
        jclf.add_examples(texts[::4], labels[::4])
        jclf.save(str(root / fmt))
        qcfg = json.loads((root / fmt / "quantized" / "quantize_config.json").read_text())
        assert qcfg["format"] == fmt and qcfg["encoder_pretrained"]
        out[fmt] = root / fmt
    shutil.rmtree(enc)
    return out


def _with_quantization(src: Path, dst: Path, quant):
    shutil.copytree(src, dst)
    cfg = json.loads((dst / "config.json").read_text())
    cfg["config"]["quantization"] = quant
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


@pytest.mark.parametrize("fmt", ["standard", "runtime_int8_tree"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_restore_from_int8_export_matches_jax(saved_exports, tmp_path, fmt, quant):
    """No base encoder on the machine: both packages build the encoder from
    the export, as float weights or as the int8 state, and predict alike."""
    path = _with_quantization(saved_exports[fmt], tmp_path / "clf", quant)
    jclf = JaxClassifier.load(str(path))
    clf = AdaptiveClassifier.load(path, device="cpu")
    assert clf.encoder.pretrained and jclf.encoder.pretrained
    assert clf.encoder.quantization == jclf.encoder.quantization == quant
    if quant == "int8":
        assert "layers.0.qkv_w.int8" in clf.encoder.params
    test, _ = intents_rows("test")
    test = test[::5]
    assert_same_predictions(clf.predict_batch(test, k=2), jclf.predict_batch(test, k=2),
                            atol=1e-3)


def test_restore_refuses_an_export_without_vocab(saved_exports, tmp_path):
    path = _with_quantization(saved_exports["runtime_int8_tree"], tmp_path / "clf", "int8")
    (path / "quantized" / "vocab.txt").unlink()
    with pytest.raises(ValueError, match="vocab.txt"):
        AdaptiveClassifier.load(path, device="cpu")


def test_load_quantized_export_both_wants(saved_exports):
    """``want="int8"`` of a runtime export is its stored state exactly;
    ``want="float"`` of it is the dequantized tree the float path loads."""
    qdir = saved_exports["runtime_int8_tree"] / "quantized"
    params, enc_cfg, qcfg = quantization.load_quantized_encoder_params(qdir, want="int8")
    assert enc_cfg["hidden_size"] == 128 and qcfg["format"] == "runtime_int8_tree"
    assert params["layers.1.qkv_w.int8"].dtype == torch.int8
    tree, _, _ = quantization.load_quantized_encoder_params(qdir, want="float")
    w = params["layers.1.qkv_w.int8"].float() * params["layers.1.qkv_w.scale"]
    np.testing.assert_array_equal(tree["layers"]["k_w"][1], w[:, 128:256].numpy())


def _zoo_rows(task):
    if task == "banking-intents":
        return intents_rows("test")
    data = json.loads((REPO / "data" / "hallucination.json").read_text())
    rows = [(f"Context: {d['context']}\nQuestion: {d.get('question', '')}\n"
             f"Answer: {d['response']}",
             "HALLUCINATED" if d["label"] == "HALLUCINATED" else "NOT_HALLUCINATED")
            for d in data["test"]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def _zoo_copy(task, dst, quant):
    shutil.copytree(REPO / "checkpoints" / "zoo" / task, dst)
    cfg = json.loads((dst / "config.json").read_text())
    cfg["config"]["quantization"] = quant
    cfg["model_name"] = str(REPO / "checkpoints" / "ac-base-v2")
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


@pytest.mark.parametrize("task", ["banking-intents", "hallucination-detector"])
def test_int8_zoo_agreement_with_float_matches_jax(task, tmp_path):
    """A zoo classifier served with int8 (bf16 compute, the zoo's) against
    the same classifier's float forward: the port's int8 forward changes
    top-1 on no more rows, and costs no more accuracy, than the JAX
    package's int8 forward does (within 0.02; both on the CPU path)."""
    texts, labels = _zoo_rows(task)
    out = {}
    for quant in (None, "int8"):
        path = _zoo_copy(task, tmp_path / str(quant), quant)
        out[quant] = (
            [p[0][0] for p in AdaptiveClassifier.load(path, device="cpu")
             .predict_batch(texts, k=1)],
            [p[0][0] for p in JaxClassifier.load(str(path)).predict_batch(texts, k=1)])
    agree = [np.mean([a == b for a, b in zip(out[None][i], out["int8"][i])])
             for i in (0, 1)]
    acc = [np.mean([p == y for p, y in zip(out["int8"][i], labels)]) for i in (0, 1)]
    print(f"{task}: int8/float top-1 agreement port {agree[0]:.4f} jax {agree[1]:.4f}; "
          f"int8 accuracy port {acc[0]:.4f} jax {acc[1]:.4f}")
    assert agree[0] >= agree[1] - 0.02
    assert acc[0] >= acc[1] - 0.02
