"""The K-contiguous weight copies kernel B3 reads (ops/ffn_int8.py
``k_contiguous``): the copy is the weight transposed, bit for bit; it is
made once per weight, by the int8 load path on a CUDA device, never per
call; and the CPU path never reads it.  The kernel itself is held to its
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu_torch.models import encoder_int8
from adaptive_classifier_tpu_torch.models.encoder import EncoderConfig, Encoder
from adaptive_classifier_tpu_torch.ops import ffn_int8
from adaptive_classifier_tpu_torch.quantization import quantize_weight


def _weight(seed, shape):
    r = np.random.default_rng(seed)
    q, s = quantize_weight(torch.from_numpy(
        (0.05 * r.standard_normal(shape)).astype(np.float32)))
    b = torch.from_numpy((0.01 * r.standard_normal(shape[1])).astype(np.float32))
    return q, s, b


def _layer(seed, M=40, D=128, F=256):
    r = np.random.default_rng(seed)
    h = torch.from_numpy((0.5 * r.standard_normal((M, D))).astype(np.float32))
    ln = (torch.from_numpy((1 + 0.1 * r.standard_normal(D)).astype(np.float32)),
          torch.from_numpy((0.1 * r.standard_normal(D)).astype(np.float32)))
    return h, _weight(seed + 1, (D, F)), _weight(seed + 2, (F, D)), ln


@pytest.mark.parametrize("shape", [(128, 256), (512, 2048), (2048, 512), (768, 3072)])
def test_k_contiguous_is_the_transpose_bit_for_bit(shape):
    w, _, _ = _weight(0, shape)
    before = ffn_int8.k_contiguous_copies
    kc = ffn_int8.k_contiguous(w)
    assert kc.dtype == torch.int8 and kc.shape == shape[::-1] and kc.is_contiguous()
    assert torch.equal(kc, w.t())
    assert ffn_int8.k_contiguous_copies == before + 1


def test_k_contiguous_is_made_once_per_weight():
    w, _, _ = _weight(1, (256, 512))
    first = ffn_int8.k_contiguous(w)
    before = ffn_int8.k_contiguous_copies
    for _ in range(3):
        assert ffn_int8.k_contiguous(w) is first
    assert ffn_int8.k_contiguous_copies == before
    other, _, _ = _weight(1, (256, 512))       # equal values, another weight
    assert ffn_int8.k_contiguous(other) is not first
    assert ffn_int8.k_contiguous_copies == before + 1


def test_prepare_ffn_weights_copies_each_ffn_weight_once():
    params = {f"layers.{i}.{name}.int8": _weight(i, (128, 256) if "in" in name
                                                  else (256, 128))[0]
              for i in range(3) for name in ("ffn_in_w", "ffn_out_w")}
    params["layers.0.qkv_w.int8"] = _weight(9, (128, 384))[0]
    params["layers.0.o_w.int8"] = _weight(10, (128, 128))[0]
    before = ffn_int8.k_contiguous_copies
    ffn_int8.prepare_ffn_weights(params)
    assert ffn_int8.k_contiguous_copies == before + 6
    for key, w in params.items():
        assert hasattr(w, "_ac_k_contiguous") == ("ffn_" in key)
    ffn_int8.prepare_ffn_weights(params)        # a second pass copies nothing
    assert ffn_int8.k_contiguous_copies == before + 6


def test_cpu_path_never_reads_the_copy():
    """A K-contiguous copy that is wrong on purpose changes nothing on the
    CPU: the wrapper takes the plain version on the [K, N] weights."""
    h, (w1, s1, b1), (w2, s2, b2), (g, beta) = _layer(3)
    args = (h, w1, s1, b1, w2, s2, b2, g, beta, 1e-12)
    want = ffn_int8.ffn_block_int8_ref(*args)
    w1._ac_k_contiguous = torch.zeros_like(w1.t()).contiguous()
    w2._ac_k_contiguous = torch.full_like(w2.t(), 7).contiguous()
    before = ffn_int8.k_contiguous_copies
    got = ffn_int8.ffn_block_int8(*args)
    assert torch.equal(got, want)
    assert ffn_int8.k_contiguous_copies == before


def test_cpu_int8_encoder_makes_no_copy():
    """The int8 load path makes the copies only on a CUDA device; a CPU
    forward through the fused FFN's plain version (B3's) makes none."""
    before = ffn_int8.k_contiguous_copies
    enc = Encoder("prajjwal1/bert-tiny", device="cpu", quantization="int8")
    assert not any(hasattr(v, "_ac_k_contiguous") for v in enc.params.values())
    cfg: EncoderConfig = enc.config
    r = np.random.default_rng(4)
    ids = torch.from_numpy(r.integers(1, cfg.vocab_size, (4, 64)).astype(np.int32))
    mask = torch.ones((4, 64), dtype=torch.int32)
    for _ in range(2):
        out = encoder_int8.encoder_forward_int8(enc.params, ids, mask, cfg,
                                                compute_dtype=torch.float32,
                                                use_fused_ffn=True)
        assert torch.isfinite(out).all()
    assert ffn_int8.k_contiguous_copies == before
