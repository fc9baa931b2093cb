"""The port's encoder families against the JAX package's and against the
``transformers`` models (CPU, float32 unless named).

Each family is built with random weights at 2-3 layers and D 64 by its
``transformers`` config class (the configs of ``tests/test_hf_parity.py``),
saved with ``save_pretrained``, and loaded by both packages' ``Encoder``.
Tolerances: the last hidden state and the pooled embeddings within
``atol=1e-4`` of the JAX package's (f32 on both sides; the matrix products
sum in other orders), and the CLS embedding within cosine 0.999 of the
``transformers`` model's.  Also: the offline configs and weights of every
``KNOWN_ARCHS`` family bit for bit, the relative-position helpers element
for element, DistilBERT's bf16 forward, the int8 forward of DistilBERT and
RoBERTa, and the int8 request on the families the int8 forward does not
take (a warning, then the float forward).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from adaptive_classifier_tpu.models import encoder as jenc
from adaptive_classifier_tpu.models import encoder_int8 as jenc8
from adaptive_classifier_tpu_torch import convert
from adaptive_classifier_tpu_torch.models import encoder as tenc
from adaptive_classifier_tpu_torch.models import encoder_int8 as tenc8

VOCAB = 512
_WP_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(507)]
_DIMS = dict(vocab_size=VOCAB, hidden_size=64, num_attention_heads=4, intermediate_size=128)


def _hf_models():
    """name → (config class, model class, config kwargs, pad id): the
    families' tiny configs."""
    return {
        "bert": ("BertConfig", "BertModel",
                 dict(**_DIMS, num_hidden_layers=3, max_position_embeddings=128), 0),
        "distilbert": ("DistilBertConfig", "DistilBertModel",
                       dict(vocab_size=VOCAB, dim=64, n_layers=3, n_heads=4, hidden_dim=128,
                            max_position_embeddings=128), 0),
        "roberta": ("RobertaConfig", "RobertaModel",
                    dict(**_DIMS, num_hidden_layers=3, max_position_embeddings=130,
                         type_vocab_size=1, pad_token_id=1, bos_token_id=0,
                         eos_token_id=2), 1),
        "electra": ("ElectraConfig", "ElectraModel",
                    dict(**_DIMS, embedding_size=32, num_hidden_layers=3,
                         max_position_embeddings=128), 0),
        "electra-noproj": ("ElectraConfig", "ElectraModel",
                           dict(**_DIMS, embedding_size=64, num_hidden_layers=2,
                                max_position_embeddings=128), 0),
        "mpnet": ("MPNetConfig", "MPNetModel",
                  dict(**_DIMS, num_hidden_layers=3, max_position_embeddings=130,
                       pad_token_id=1, relative_attention_num_buckets=32), 1),
        "deberta": ("DebertaV2Config", "DebertaV2Model",
                    dict(**_DIMS, num_hidden_layers=3, max_position_embeddings=128,
                         type_vocab_size=0, relative_attention=True, position_buckets=8,
                         norm_rel_ebd="layer_norm", share_att_key=True,
                         pos_att_type="p2c|c2p", position_biased_input=True,
                         conv_kernel_size=0), 0),
        "deberta-proj": ("DebertaV2Config", "DebertaV2Model",
                         dict(**_DIMS, embedding_size=32, num_hidden_layers=2,
                              max_position_embeddings=128, type_vocab_size=0,
                              relative_attention=True, position_buckets=8,
                              norm_rel_ebd="layer_norm", share_att_key=True,
                              pos_att_type="c2p", position_biased_input=False,
                              conv_kernel_size=0), 0),
    }


FAMILIES = list(_hf_models())


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name → (directory, the transformers model, pad id), built once."""
    out = {}
    for name, (cfg_cls, model_cls, kwargs, pad) in _hf_models().items():
        torch.manual_seed(0)
        model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kwargs))
        model.eval()
        d = tmp_path_factory.mktemp(name)
        model.save_pretrained(d)
        (d / "vocab.txt").write_text("\n".join(_WP_VOCAB))
        out[name] = (d, model, pad)
    return out


def _ids_and_mask(pad, seed=0, B=3, S=24):
    r = np.random.default_rng(seed)
    ids = r.integers(5, VOCAB - 12, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 16:] = 0
    mask[2, 7:] = 0
    return np.where(mask > 0, ids, pad).astype(np.int32), mask


def _jax_cfg_as_port(jcfg) -> tenc.EncoderConfig:
    return tenc.EncoderConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax_and_transformers(checkpoints, name):
    path, model, pad = checkpoints[name]
    jax_enc = jenc.Encoder(str(path), compute_dtype="float32")
    enc = tenc.Encoder(str(path), device="cpu", compute_dtype="float32")
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jax_enc.config)
    ids, mask = _ids_and_mask(pad)
    want_hidden = np.asarray(jenc.encoder_forward(
        jax_enc.params, jnp.asarray(ids), jnp.asarray(mask), jax_enc.config,
        compute_dtype=jnp.float32))
    hidden = tenc.encoder_forward(enc.params, torch.from_numpy(ids), torch.from_numpy(mask),
                                  enc.config, compute_dtype=torch.float32)
    valid = mask.astype(bool)
    np.testing.assert_allclose(hidden.numpy()[valid], want_hidden[valid], atol=1e-4)
    emb = enc.embed_ids(ids, mask).numpy()
    want = np.asarray(jax_enc._embed_jit(jax_enc.params, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(emb, want, atol=1e-4)
    for pooling in ("cls", "mean"):
        np.testing.assert_allclose(
            tenc.pool_and_normalize(hidden, torch.from_numpy(mask), pooling).numpy(),
            np.asarray(jenc.embed_texts_device(
                jax_enc.params, jnp.asarray(ids), jnp.asarray(mask), jax_enc.config,
                compute_dtype=jnp.float32, pooling=pooling)), atol=1e-4)
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state[:, 0]
    ref = torch.nn.functional.normalize(out, dim=1).numpy()
    cos = (emb * ref).sum(axis=1)
    assert (cos > 0.999).all(), cos


@pytest.mark.parametrize("name", FAMILIES)
def test_read_hf_config_and_weights_match_jax(checkpoints, name):
    path = checkpoints[name][0]
    jcfg = jenc._read_hf_config(path)
    cfg = tenc._read_hf_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jtree = jenc._map_hf_weights(jenc._load_state_dict(path), jcfg)
    tree = tenc._map_hf_weights(tenc._load_state_dict(path), cfg)
    for group in ("embeddings", "layers"):
        assert set(tree[group]) == set(jtree[group])
        for k, v in jtree[group].items():
            np.testing.assert_array_equal(tree[group][k], np.asarray(v), err_msg=k)


def test_pytorch_model_bin_loads_like_safetensors(checkpoints, tmp_path):
    """A checkpoint saved as ``pytorch_model.bin`` reads the same tensors."""
    model = checkpoints["roberta"][1]
    model.save_pretrained(tmp_path, safe_serialization=False)
    assert (tmp_path / "pytorch_model.bin").exists()
    assert not (tmp_path / "model.safetensors").exists()
    cfg = tenc._read_hf_config(tmp_path)
    a = tenc._map_hf_weights(tenc._load_state_dict(tmp_path), cfg)
    b = tenc._map_hf_weights(tenc._load_state_dict(checkpoints["roberta"][0]), cfg)
    for group in ("embeddings", "layers"):
        for k in a[group]:
            np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)


@pytest.mark.parametrize("change,match", [
    ({"conv_kernel_size": 3}, "ConvLayer"),
    ({"share_att_key": False}, "share_att_key"),
])
def test_deberta_refusals_match_jax(checkpoints, tmp_path, change, match):
    import json

    src = checkpoints["deberta"][0]
    cfg = {**json.loads((src / "config.json").read_text()), **change}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        jenc._read_hf_config(tmp_path)
    with pytest.raises(ValueError, match=match):
        tenc._read_hf_config(tmp_path)


# -- offline configs and weights ---------------------------------------------

@pytest.mark.parametrize("name", list(jenc.KNOWN_ARCHS) + [
    "my-deberta-xsmall", "some-distil-model", "org/electra-small-thing", "an-electra",
    "ModernBERT-large-ft", "modernbert-x", "my-mpnet", "deberta-custom", "tiny-model",
    "a-large-one", "unknown/model"])
def test_config_for_model_name_matches_jax(name):
    assert (dataclasses.asdict(tenc.config_for_model_name(name))
            == dataclasses.asdict(jenc.config_for_model_name(name)))


def _shrunk(name):
    """A ``KNOWN_ARCHS`` config at tiny dims, its family fields kept."""
    cfg = jenc.KNOWN_ARCHS[name]
    small = dict(vocab_size=97, hidden_size=32, num_layers=2, intermediate_size=48,
                 max_position_embeddings=40)
    small["num_heads"] = 4 if cfg.num_heads % 4 == 0 else 2
    if cfg.embedding_size:
        small["embedding_size"] = 16
    if cfg.rel_att_span:
        small["rel_att_span"] = 12
    return dataclasses.replace(cfg, **small)


_FAMILY_NAMES = ["distilbert-base-uncased", "answerdotai/ModernBERT-base",
                 "google/electra-small-discriminator", "google/electra-base-discriminator",
                 "microsoft/mpnet-base", "microsoft/deberta-v3-base",
                 "microsoft/deberta-v3-xsmall"]


@pytest.mark.parametrize("name", _FAMILY_NAMES)
def test_init_params_bit_for_bit(name):
    jcfg = _shrunk(name)
    tree = tenc.init_params(5, _jax_cfg_as_port(jcfg))
    jtree = jenc.init_params(5, jcfg)
    assert list(tree) == list(jtree)
    for group in jtree:
        if isinstance(jtree[group], dict):
            assert list(tree[group]) == list(jtree[group])
            for k, v in jtree[group].items():
                assert tree[group][k].dtype == np.float32
                assert np.array_equal(tree[group][k], np.asarray(v)), (group, k)
        else:
            assert np.array_equal(tree[group], np.asarray(jtree[group]))


@pytest.mark.parametrize("name", _FAMILY_NAMES)
def test_offline_family_forward_matches_jax(name):
    """The tiny offline weights of each family through both forwards."""
    jcfg = _shrunk(name)
    jparams = jenc.init_params(3, jcfg)
    cfg = _jax_cfg_as_port(jcfg)
    ids, mask = _ids_and_mask(cfg.pad_token_id, seed=4, S=16)
    ids = np.minimum(ids, 96)
    want = np.asarray(jenc.encoder_forward(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                           jcfg, compute_dtype=jnp.float32))
    got = tenc.encoder_forward(convert.encoder_params_from_jax(jparams),
                               torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                               compute_dtype=torch.float32).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("S", [8, 64, 512])
def test_relative_position_helpers_equal_jax(S):
    for buckets, dist in ((32, 128), (8, 16)):
        assert np.array_equal(tenc._relative_position_buckets(S, buckets, dist),
                              jenc._relative_position_buckets(S, buckets, dist))
    for size, max_pos in ((256, 512), (8, 128), (0, 0)):
        assert np.array_equal(tenc._deberta_rel_positions(S, size, max_pos),
                              jenc._deberta_rel_positions(S, size, max_pos))


# -- bf16 and int8 -------------------------------------------------------------

def test_distilbert_bf16_forward_matches_jax(checkpoints):
    """DistilBERT's bf16 forward, a B1 family: each linear layer rounds once
    as the JAX package's, so at least 98% of the valid tokens' hidden values
    equal the JAX forward's bit for bit (as ``test_bf16_forward_matches_jax``
    holds BERT's)."""
    path, _, pad = checkpoints["distilbert"]
    jax_enc = jenc.Encoder(str(path), compute_dtype="float32")
    cfg = _jax_cfg_as_port(jax_enc.config)
    ids, mask = _ids_and_mask(pad, seed=1, B=8, S=32)
    want = np.asarray(jenc.encoder_forward(jax_enc.params, jnp.asarray(ids),
                                           jnp.asarray(mask), jax_enc.config,
                                           compute_dtype=jnp.bfloat16, attn_impl="einsum"))
    params = convert.encoder_params_from_jax(jax_enc.params, matrix_dtype=torch.bfloat16)
    got = tenc.encoder_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                               compute_dtype=torch.bfloat16).numpy()
    valid = mask.astype(bool)
    equal = float((got[valid] == want[valid]).mean())
    print(f"distilbert bf16: {equal:.6f} of the hidden values equal the JAX forward's")
    assert equal >= 0.98


def _row_cosine(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _int8_pair(path, pad, fused, seed=2):
    """(port, JAX) int8 hidden states of one checkpoint on the same int8
    weights (the JAX package's eager quantization), at [8, 32]."""
    from jax.experimental.pallas import tpu as pltpu

    jax_enc = jenc.Encoder(str(path), compute_dtype="float32")
    jq = jenc8.quantize_encoder_for_inference(jax_enc.params)
    ids, mask = _ids_and_mask(pad, seed=seed, B=8, S=32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc8.encoder_forward_int8(
            jq, jnp.asarray(ids), jnp.asarray(mask), jax_enc.config,
            compute_dtype=jnp.float32, use_fused_ffn=fused))
    got = tenc8.encoder_forward_int8(convert.encoder_int8_params_from_jax(jq),
                                     torch.from_numpy(ids), torch.from_numpy(mask),
                                     _jax_cfg_as_port(jax_enc.config),
                                     compute_dtype=torch.float32, use_fused_ffn=fused).numpy()
    valid = mask.astype(bool)
    return got[valid], want[valid]


@pytest.mark.parametrize("name", ["distilbert", "roberta", "electra-noproj"])
def test_int8_forward_matches_jax(checkpoints, name):
    """The int8 forward on the same int8 weights: hidden states within
    cosine 0.9999 and 0.05, as ``tests/test_torch_int8.py`` holds BERT's."""
    path, _, pad = checkpoints[name]
    got, want = _int8_pair(path, pad, fused=False)
    assert _row_cosine(got, want).min() >= 0.9999
    assert np.abs(got - want).max() <= 0.05


def test_int8_fused_roberta_matches_jax(tmp_path):
    """RoBERTa at D 128 (the width B2 and B3 take) through the plain
    versions of B2 and B3, against the Pallas kernels in interpret mode."""
    cfg = transformers.RobertaConfig(vocab_size=VOCAB, hidden_size=128, num_hidden_layers=2,
                                     num_attention_heads=4, intermediate_size=256,
                                     max_position_embeddings=130, type_vocab_size=1,
                                     pad_token_id=1)
    torch.manual_seed(1)
    transformers.RobertaModel(cfg).save_pretrained(tmp_path)
    (tmp_path / "vocab.txt").write_text("\n".join(_WP_VOCAB))
    got, want = _int8_pair(tmp_path, 1, fused=True)
    assert _row_cosine(got, want).min() >= 0.9999
    assert np.abs(got - want).max() <= 0.05


@pytest.mark.parametrize("name", ["distilbert", "roberta"])
def test_int8_encoder_stays_near_float(checkpoints, name):
    """``Encoder(..., quantization="int8")`` runs the int8 forward on these
    families; its embeddings within cosine 0.99 of the float encoder's (the
    JAX package's int8 envelope)."""
    path, _, pad = checkpoints[name]
    enc8 = tenc.Encoder(str(path), device="cpu", compute_dtype="float32",
                        quantization="int8")
    assert enc8.quantization == "int8" and "layers.0.qkv_w.int8" in enc8.params
    enc = tenc.Encoder(str(path), device="cpu", compute_dtype="float32")
    ids, mask = _ids_and_mask(pad, seed=3, B=6, S=24)
    assert _row_cosine(enc8.embed_ids(ids, mask).numpy(),
                       enc.embed_ids(ids, mask).numpy()).min() > 0.99


@pytest.mark.parametrize("name", ["mpnet", "deberta", "electra"])
def test_int8_request_runs_float_with_a_warning(checkpoints, name, caplog):
    """MPNet, DeBERTa and projected ELECTRA: the JAX package's rule, a
    warning and the float forward, decided from the config before any
    weight is made (ModernBERT: tests/test_torch_modernbert.py)."""
    path, _, pad = checkpoints[name]
    with caplog.at_level(logging.WARNING):
        enc8 = tenc.Encoder(str(path), device="cpu", compute_dtype="float32",
                            quantization="int8")
    assert enc8.quantization is None
    assert f"'{enc8.config.arch}'" in caplog.text and "int8" in caplog.text
    assert not any(k.endswith(".int8") for k in enc8.params)
    jax_enc = jenc.Encoder(str(path), compute_dtype="float32", quantization="int8")
    assert jax_enc.quantization is None
    enc = tenc.Encoder(str(path), device="cpu", compute_dtype="float32")
    ids, mask = _ids_and_mask(pad, seed=5)
    assert torch.equal(enc8.embed_ids(ids, mask), enc.embed_ids(ids, mask))
    with pytest.raises(ValueError, match="int8 forward"):
        tenc8.encoder_forward_int8(enc.params, torch.from_numpy(ids),
                                   torch.from_numpy(mask), enc.config)


def test_int8_rule_by_config():
    ok = [tenc.EncoderConfig(arch=a) for a in ("bert", "distilbert", "roberta", "electra")]
    refused = [tenc.EncoderConfig(arch="electra", embedding_size=128)] + [
        tenc.EncoderConfig(arch=a) for a in ("mpnet", "deberta", "modernbert")]
    assert all(tenc.check_int8_arch(c, "int8") == "int8" for c in ok)
    assert all(tenc.check_int8_arch(c, "int8") is None for c in refused)
    assert all(tenc.check_int8_arch(c, None) is None for c in ok + refused)


def test_attn_impl_of_the_own_attention_families(checkpoints, monkeypatch):
    """MPNet and DeBERTa run their own attention on any device: the policy
    names "einsum" there, even forced, and never raises B1's envelope error;
    the B1 families keep the kernel policy."""
    monkeypatch.setenv("AC_ATTN_IMPL", "flash")
    for name in ("mpnet", "deberta"):
        enc = tenc.Encoder(str(checkpoints[name][0]), device="cpu", compute_dtype="float32")
        enc.device = torch.device("cuda")          # the GPU's policy, asked here
        assert enc._attn_impl(60) == enc._attn_impl(64) == enc._attn_impl(2048) == "einsum"
    enc = tenc.Encoder(str(checkpoints["roberta"][0]), device="cpu", compute_dtype="float32")
    assert enc._attn_impl(64) == "flash"
    monkeypatch.delenv("AC_ATTN_IMPL")
    enc.device = torch.device("cuda")
    assert enc._attn_impl(64) == "fusedqkv"


def test_int8_export_round_trips(checkpoints, tmp_path):
    """``save_quantized_encoder`` → ``from_quantized_export`` on DistilBERT
    and RoBERTa: the config, the tokenizer and the int8 state come back."""
    from adaptive_classifier_tpu_torch import quantization

    for name in ("distilbert", "roberta"):
        path, _, pad = checkpoints[name]
        enc8 = tenc.Encoder(str(path), device="cpu", compute_dtype="float32",
                            quantization="int8")
        quantization.save_quantized_encoder(enc8, tmp_path / name)
        back = tenc.Encoder.from_quantized_export(tmp_path / name, "gone/model",
                                                  device="cpu", compute_dtype="float32",
                                                  quantization="int8")
        assert back.config == enc8.config
        assert set(back.params) == set(enc8.params)
        for k, v in enc8.params.items():
            assert torch.equal(back.params[k], v), k
        ids, mask = _ids_and_mask(pad, seed=6)
        assert torch.equal(back.embed_ids(ids, mask), enc8.embed_ids(ids, mask))
