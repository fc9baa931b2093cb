"""The port on an NVIDIA GPU: each CUDA kernel against its plain torch
version, the launch counts, and the paths that must raise on the GPU.

Marked ``cuda``; every test takes the ``cuda`` fixture, which skips when no
GPU is present, so the same tests are collected everywhere.  On a machine
with a GPU: ``python -m pytest tests/test_torch_cuda.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import adaptive_classifier_tpu_torch as port
from adaptive_classifier_tpu_torch.ops import knn
from adaptive_classifier_tpu_torch.ops.attention_qkv import (
    attention_from_qkv,
    attention_from_qkv_ref,
)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, seed, dtype, B, S, H, Dh, masked_row=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * Dh), generator=g).to(dev, dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(torch.int32)
    if masked_row is not None:
        mask[masked_row] = 0
    return qkv, mask.to(dev)


@pytest.mark.parametrize("dtype,B,S,H,Dh", [
    (torch.float32, 4, 128, 8, 64),
    (torch.float32, 3, 72, 4, 128),
    (torch.float32, 2, 200, 3, 24),
    (torch.bfloat16, 256, 64, 8, 64),
    (torch.bfloat16, 8, 512, 8, 64),
    (torch.bfloat16, 5, 40, 6, 32),
])
def test_attention_kernel_matches_plain(cuda, dtype, B, S, H, Dh):
    qkv, mask = _inputs(cuda, 0, dtype, B, S, H, Dh)
    got = attention_from_qkv(qkv, mask, H, Dh)
    want = attention_from_qkv_ref(qkv, mask, H, Dh)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H * Dh)
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    else:
        # bf16 probabilities: kernel and plain version round in other places
        assert (g * w).sum() / (g.norm() * w.norm()) > 0.999
        torch.testing.assert_close(g, w, atol=0.05, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_fully_masked_row(cuda, dtype):
    B, S, H, Dh = 3, 64, 2, 64
    qkv, mask = _inputs(cuda, 1, dtype, B, S, H, Dh, masked_row=1)
    got = attention_from_qkv(qkv, mask, H, Dh).float()
    assert torch.isfinite(got).all()
    uniform = qkv[1, :, 2 * H * Dh:].float().mean(dim=0)
    atol = 1e-4 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(got[1], uniform.expand(S, -1), atol=atol, rtol=0)


def test_attention_counts_launches(cuda):
    qkv, mask = _inputs(cuda, 2, torch.bfloat16, 2, 64, 8, 64)
    port.reset_launch_counts()
    attention_from_qkv(qkv, mask, 8, 64)
    attention_from_qkv(qkv, mask, 8, 64)
    attention_from_qkv_ref(qkv, mask, 8, 64)
    assert port.launch_counts["attention_qkv"] == 2


def test_unported_kernels_raise_on_the_gpu(cuda):
    q = torch.zeros(2, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="B4"):
        knn.masked_sims(q, torch.zeros(512, 8, device=cuda),
                        torch.ones(512, dtype=torch.bool, device=cuda))


def test_zoo_predict_batch_on_the_gpu(cuda):
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, lbl) for lbl in data["train"] for t in data["test"][lbl]]
    port.reset_launch_counts()
    preds = clf.predict_batch([t for t, _ in rows], k=1)
    assert port.launch_counts["attention_qkv"] == clf.encoder.config.num_layers
    acc = np.mean([p[0][0] == lbl for p, (_, lbl) in zip(preds, rows)])
    assert acc >= 0.92 - 0.03
    with pytest.raises(NotImplementedError, match="B6"):
        clf.encoder._attn_impl(1024)
