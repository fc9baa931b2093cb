"""The port's ONNX export (``adaptive_classifier_tpu_torch/onnx_export.py``)
against the JAX package's, and ``AdaptiveClassifier.to``.

The same offline weights (``init_params`` draws them alike in both
packages) give the same ``model.onnx`` and ``model_quantized.onnx`` bytes;
either package's ``OnnxLiteModel`` runs the other's file with equal
outputs; the artifact computes the port's float32 forward (JAX
``tests/test_onnx_export.py``'s bounds)."""

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import onnx_export as jonnx
from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch import onnx_export as tonnx
from adaptive_classifier_tpu_torch.models import encoder as tenc

SMALL = dict(vocab_size=512, hidden_size=64, num_heads=4, intermediate_size=128)
CONFIGS = {
    "bert-3x64": dict(SMALL, num_layers=3, max_position_embeddings=64),
    "roberta-position-ids": dict(SMALL, num_layers=2, max_position_embeddings=66,
                                 type_vocab_size=1, pad_token_id=1, arch="roberta"),
    "electra-projection-mean": dict(SMALL, num_layers=2, max_position_embeddings=64,
                                    embedding_size=32, arch="electra", pooling="mean"),
}
TINY_BUCKETS = {"train_size_buckets": [64], "class_capacity_buckets": [8],
                "example_capacity_buckets": [32]}


def _inputs(B=2, S=12, V=500, seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(5, V, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[-1, S - 4:] = 0
    return ids, mask


def _port_forward(tree, cfg, ids, mask):
    params = tenc.params_from_tree(tree, matrix_dtype=torch.float32)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    hidden = tenc.encoder_forward(params, ids_t, mask_t, cfg, torch.float32)
    return hidden.numpy(), tenc.pool_and_normalize(hidden, mask_t, cfg.pooling).numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_onnx_files_equal_the_jax_export(name, tmp_path):
    jcfg = jenc.EncoderConfig(**CONFIGS[name])
    tcfg = tenc.config_from_dict(jcfg.__dict__)
    tree = tenc.init_params(0, tcfg)
    ids, mask = _inputs()
    if jcfg.arch == "roberta":
        ids[mask == 0] = 1                       # the pad token at pad positions
    feeds = {"input_ids": ids, "attention_mask": mask}
    outs = {}
    for quantize in (False, True):
        mine = tonnx.build_encoder_graph(tree, tcfg, quantize=quantize)
        theirs = jonnx.build_encoder_graph(jenc.init_params(0, jcfg), jcfg, quantize=quantize)
        assert mine == theirs
        path = tmp_path / f"q{int(quantize)}.onnx"
        path.write_bytes(mine)
        model = tonnx.OnnxLiteModel(path)
        assert model.input_names == ["input_ids", "attention_mask"]
        assert model.output_names == ["last_hidden_state", "sentence_embedding"]
        out = model.run(feeds)
        other = jonnx.OnnxLiteModel(path).run(feeds)
        for key in out:
            np.testing.assert_array_equal(out[key], other[key])
        outs[quantize] = out
    hidden, sent = _port_forward(tree, tcfg, ids, mask)
    np.testing.assert_allclose(outs[False]["last_hidden_state"], hidden, atol=1e-4)
    np.testing.assert_allclose(outs[False]["sentence_embedding"], sent, atol=1e-5)
    cos = (outs[False]["sentence_embedding"] * outs[True]["sentence_embedding"]).sum(-1)
    assert (cos > 0.99).all(), cos


def test_quantized_artifact_smaller_and_close(tmp_path):
    cfg = tenc.EncoderConfig(**CONFIGS["bert-3x64"])
    tree = tenc.init_params(0, cfg)
    fp, qp = tmp_path / "model.onnx", tmp_path / "model_quantized.onnx"
    fp.write_bytes(tonnx.build_encoder_graph(tree, cfg, quantize=False))
    qp.write_bytes(tonnx.build_encoder_graph(tree, cfg, quantize=True))
    assert qp.stat().st_size < 0.55 * fp.stat().st_size
    ids, mask = _inputs()
    feeds = {"input_ids": ids, "attention_mask": mask}
    sf = tonnx.OnnxLiteModel(fp).run(feeds)["sentence_embedding"]
    sq = tonnx.OnnxLiteModel(qp).run(feeds)["sentence_embedding"]
    assert ((sf * sq).sum(-1) > 0.99).all()


def test_classifier_export_onnx_surface(tmp_path):
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu", config=TINY_BUCKETS)
    out = clf.export_onnx(tmp_path / "onnx", quantization_config="avx512")
    assert out == tmp_path / "onnx"
    for name in ("model.onnx", "model_quantized.onnx", "quantized/model_int8.safetensors",
                 "quantized/quantize_config.json"):
        assert (out / name).exists(), name
    ids, mask = _inputs(V=500)
    sent = tonnx.OnnxLiteModel(out / "model.onnx").run(
        {"input_ids": ids, "attention_mask": mask})["sentence_embedding"]
    enc = tenc.Encoder("prajjwal1/bert-tiny", compute_dtype="float32", device="cpu", seed=42)
    ours = enc.embed_ids(ids.astype(np.int32), mask.astype(np.int32)).numpy()
    assert ((sent * ours).sum(-1) > 0.9999).all()
    only = clf.export_quantized(tmp_path / "q")
    assert (only / "model_int8.safetensors").exists()
    assert not (only / "model.onnx").exists()


@pytest.mark.parametrize("arch", ["mpnet", "deberta", "modernbert"])
def test_unsupported_families_fail_loudly(arch):
    cfg = tenc.EncoderConfig(arch=arch, **SMALL, num_layers=2)
    with pytest.raises(ValueError, match="ONNX export supports"):
        tonnx.build_encoder_graph({}, cfg)


def test_int8_encoder_refuses_float_export(tmp_path):
    enc = tenc.Encoder("prajjwal1/bert-tiny", device="cpu", quantization="int8")
    assert enc.quantization == "int8"
    with pytest.raises(ValueError, match="runtime-int8"):
        tonnx.export_encoder_onnx(enc, tmp_path)
    assert not (tmp_path / "model.onnx").exists()


def test_to_returns_self_and_never_falls_back_to_the_cpu():
    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu", config=TINY_BUCKETS)
    clf.add_examples(["card lost", "lost my card", "pin change", "change pin"],
                     ["lost", "lost", "pin", "pin"])
    before = clf.predict_batch(["my card is gone"], k=2)
    assert clf.to("cpu") is clf and clf.to(torch.device("cpu")) is clf
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            clf.to("cuda")
    assert clf.device.type == "cpu" and clf.memory.state.proto.device.type == "cpu"
    assert clf.predict_batch(["my card is gone"], k=2) == before


def test_int8_encoder_to_the_cpu_drops_the_k_contiguous_copies():
    """An int8 encoder moved to the CPU keeps no K-contiguous copy (the
    copies a GPU load makes are stood in for by ``prepare_int8_weights``
    on the CPU tensors) and embeds as before; its classifier predicts as
    before."""
    from adaptive_classifier_tpu_torch.ops.ffn_int8 import prepare_int8_weights

    clf = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu",
                             config=dict(TINY_BUCKETS, quantization="int8"))
    enc = clf.encoder
    assert enc.quantization == "int8"
    clf.add_examples(["card lost", "lost my card", "pin change", "change pin"],
                     ["lost", "lost", "pin", "pin"])
    before = clf.predict_batch(["my card is gone", "new pin"], k=2)
    ids, mask = _inputs()
    emb = enc.embed_ids(ids.astype(np.int32), mask.astype(np.int32))
    prepare_int8_weights(enc.params)
    int8_keys = [k for k in enc.params if k.endswith("_w.int8")]
    assert int8_keys and all(hasattr(enc.params[k], "_ac_k_contiguous") for k in int8_keys)
    assert enc.to("cpu") is enc and enc.device.type == "cpu"
    assert not any(hasattr(w, "_ac_k_contiguous") for w in enc.params.values())
    assert torch.equal(enc.embed_ids(ids.astype(np.int32), mask.astype(np.int32)), emb)
    assert clf.predict_batch(["my card is gone", "new pin"], k=2) == before
