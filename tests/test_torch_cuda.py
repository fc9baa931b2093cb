"""The port on an NVIDIA GPU: each CUDA kernel against its plain torch
version, the launch counts, and the paths that must raise on the GPU.

Marked ``cuda``; every test takes the ``cuda`` fixture, which skips when no
GPU is present, so the same tests are collected everywhere.  On a machine
with a GPU: ``python -m pytest tests/test_torch_cuda.py``.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import adaptive_classifier_tpu_torch as port
from adaptive_classifier_tpu_torch import quantization
from adaptive_classifier_tpu_torch.models import encoder_int8
from adaptive_classifier_tpu_torch.ops import ffn_int8, knn, knn_topk, matmul_int8
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


def _packed_views(qkv, H, Dh):
    D = H * Dh
    return [qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3)]


@pytest.mark.parametrize("kernel", ["attention_qkv", "oneshot_attention"])
@pytest.mark.parametrize("B,S", [(256, 32), (64, 128), (8, 512)])
def test_attention_kernel_rounds_like_the_plain_version(cuda, kernel, B, S):
    """B1 rounds p to bf16 after the softmax's division, as its TPU kernel
    (adaptive_classifier_tpu/ops/attention_qkv.py:40-44) and its plain
    version do: at least 95% of its bf16 outputs equal the plain version's
    bit for bit.  B7, which rounds in the same order, calibrates the bound;
    B6's order (p rounded before the division) leaves about half of them
    one bf16 step off."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    H, Dh = 8, 64
    qkv, mask = _inputs(cuda, 20 + S, torch.bfloat16, B, S, H, Dh)
    if kernel == "attention_qkv":
        got = attention_from_qkv(qkv, mask, H, Dh)
        want = attention_from_qkv_ref(qkv, mask, H, Dh)
    else:
        q, k, v = _packed_views(qkv, H, Dh)
        got = fa.oneshot_attention(q, k, v, mask)
        want = fa.oneshot_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert (got == want).float().mean().item() >= 0.95


# B1 in bf16 at the edges of its forms: one 32-key tile and 2 warps (S 8,
# 24), one 64-key tile (40), one pass over two tiles (72, 128), two passes
# (136, 512); Dh 24 and 40 (zero-padded), 32 and 128; a base off 16 bytes
# (rows staged element by element)
_B1_EDGES = [(64, 8, 8, 64, 0), (64, 24, 8, 64, 0), (32, 40, 8, 64, 0),
             (16, 72, 8, 64, 0), (16, 128, 8, 64, 0), (8, 136, 8, 64, 0),
             (3, 48, 4, 24, 0), (5, 40, 6, 32, 0), (3, 96, 4, 128, 0),
             (3, 200, 3, 128, 0), (3, 128, 4, 64, 1), (3, 24, 4, 64, 1),
             (2, 512, 4, 40, 3)]


@pytest.mark.parametrize("B,S,H,Dh,offset", _B1_EDGES)
def test_attention_kernel_tile_edges(cuda, B, S, H, Dh, offset):
    qkv, mask = _inputs(cuda, 30 + S, torch.bfloat16, B, S, H, Dh, masked_row=1)
    if offset:
        buf = torch.zeros(qkv.numel() + offset, dtype=qkv.dtype, device=cuda)
        buf[offset:] = qkv.reshape(-1)
        qkv = buf[offset:].view(qkv.shape)
    port.reset_launch_counts()
    got = attention_from_qkv(qkv, mask, H, Dh)
    want = attention_from_qkv_ref(qkv, mask, H, Dh)
    torch.cuda.synchronize()
    assert port.launch_counts["attention_qkv"] == 1
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert (g * w).sum() / (g.norm() * w.norm()) > 0.999
    torch.testing.assert_close(g, w, atol=0.05, rtol=0)


def test_attention_kernel_one_pass_instantiation(cuda):
    """At the hallucination chunk's S = 128 (bf16, Dh 64) B1 takes one pass:
    4 warps, Q and two 64-key K/V tiles with their biases in 45.5 KB of
    shared memory, every score of a warp's rows in at most 128 registers a
    thread, unspilled: four blocks share an SM."""
    from adaptive_classifier_tpu_torch.ops import attention_qkv as aq

    qkv, _ = _inputs(cuda, 40, torch.bfloat16, 2, 128, 8, 64)
    info = aq.kernel_info(qkv, 8, 64)
    assert info["threads"] == 128
    assert info["shared_bytes"] == 2 * (64 * 72 + 2 * 2 * 64 * 72) + 4 * 2 * 64
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= 4


def test_unported_kernels_raise_on_the_gpu(cuda, monkeypatch):
    """Every kernel is ported: S >= 1024 takes the flash kernel (B6), and
    what no kernel takes still raises."""
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    assert clf.encoder._attn_impl(1024) == "flash"
    with pytest.raises(NotImplementedError, match="envelope"):
        clf.encoder._attn_impl(60)


def test_zoo_predict_batch_on_the_gpu(cuda, monkeypatch):
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, lbl) for lbl in data["train"] for t in data["test"][lbl]]
    port.reset_launch_counts()
    preds = clf.predict_batch([t for t, _ in rows], k=1)
    assert port.launch_counts["attention_qkv"] == clf.encoder.config.num_layers
    acc = np.mean([p[0][0] == lbl for p, (_, lbl) in zip(preds, rows)])
    assert acc >= 0.92 - 0.03
    assert clf.encoder._attn_impl(1024) == "flash"


@pytest.mark.parametrize("gelu", [False, True], ids=["qkv_o_ffn_out", "ffn_in_gelu"])
def test_linear_rounds_once_on_the_gpu(cuda, gelu):
    """The float forward's linear layers on the card (``torch.mm`` with an
    f32 result) against the JAX package's order computed on the CPU: the
    exact products of the bf16 operands, f32 sums, the f32 bias (and GELU),
    one rounding (tests/test_torch_linear.py holds the CPU order to the JAX
    einsum).  At least 99% of the bf16 outputs equal it bit for bit."""
    from adaptive_classifier_tpu_torch.models import encoder as tenc

    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((4096, 512)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.05 * r.standard_normal((512, 1536))).astype(np.float32)).bfloat16()
    b = torch.from_numpy((0.1 * r.standard_normal(1536)).astype(np.float32))
    layer = tenc._linear_gelu if gelu else tenc._linear
    want = layer(x, w, b).bfloat16()
    got = layer(x.to(cuda), w.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32
    got = got.bfloat16().cpu()
    equal = (got == want).double().mean().item()
    print(f"_linear gelu={gelu} on {torch.cuda.get_device_name(cuda)} (torch "
          f"{torch.__version__}): {equal:.6f} of the bf16 outputs equal the JAX order's")
    assert equal >= 0.99


def _knn_inputs(dev, seed, B, C, D, n_valid=None, dup=False, near=False):
    """Unit-norm queries and prototypes (the real domain: d² in [0, 4]);
    ``dup`` copies prototype 3 onto 10 and 40 so similarities tie exactly;
    ``near`` makes each query a near duplicate of a random prototype
    (``p_c + 1e-3·noise``, renormalised: d² ~ 1e-6, where an error in d²
    reaches the output one for one)."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, D)).astype(np.float32)
    p = r.standard_normal((C, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    if dup:
        p[10] = p[40] = p[3]
        q[0] = p[3]
    if near:
        q = p[r.integers(0, C, B)] + 1e-3 * q
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.ones(C, bool) if n_valid is None else np.arange(C) < n_valid
    return (torch.from_numpy(q).to(dev), torch.from_numpy(p).to(dev),
            torch.from_numpy(valid).to(dev))


# B4: phase 7's chunk (split contraction) and its recalibration, phase 8's
# chunk (one split), C off the 128-prototype tile, D off 32 columns (500)
# and off 16 bytes (510: the wrapper pads the rows), the production width
# D 33,280, none valid, near-duplicate rows at D 512 and 33,280
@pytest.mark.parametrize("B,C,D,n_valid,near", [
    (256, 1024, 512, None, False),
    (250, 1021, 500, 700, False),
    (3, 1000, 33280, None, False),
    (5, 600, 40, 0, False),
    (256, 16384, 512, None, False),
    (2048, 1024, 512, None, True),
    (256, 1024, 512, None, True),
    (256, 1024, 33280, None, True),
    (64, 700, 510, 650, True),
])
def test_masked_sims_kernel_matches_plain(cuda, B, C, D, n_valid, near):
    q, p, valid = _knn_inputs(cuda, 0, B, C, D, n_valid, near=near)
    port.reset_launch_counts()
    got = knn.masked_sims(q, p, valid)
    want = knn.masked_sims_ref(q, p, valid)
    torch.cuda.synchronize()
    assert port.launch_counts["knn_sims"] == 1
    # f32 sums in another order on unit-norm rows; the product in 3xTF32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    if near:
        assert want.max().item() > 0.999      # the near duplicates are there


@pytest.mark.parametrize("D", [96, 256], ids=["one_split", "four_splits"])
@pytest.mark.parametrize("exact", [True, False], ids=["tf32_values", "f32_values"])
def test_masked_sims_planted_operands(cuda, D, exact):
    """One-hot rows: query b holds a_b at column k_b, prototype c holds v_c
    at column k_(c mod B), so each output says which query and prototype
    rows met in which column.  ``tf32_values``: a and v exact in TF32 (the
    split's lo is 0), which isolates the wgmma descriptors' layout;
    ``f32_values``: full f32 mantissas, which holds the split (a hardware
    that rounded the hi operand instead of keeping its top 19 bits would
    be off by ~1e-4)."""
    B, C = 133, 259
    r = np.random.default_rng(5)
    a = r.uniform(0.5, 1.0, B).astype(np.float32)
    v = r.uniform(0.2, 0.6, C).astype(np.float32)
    if exact:
        a = (a.view(np.uint32) & 0xffffe000).view(np.float32)
        v = (v.view(np.uint32) & 0xffffe000).view(np.float32)
    k = (np.arange(B) * 7 + 3) % D
    q = np.zeros((B, D), np.float32)
    q[np.arange(B), k] = a
    p = np.zeros((C, D), np.float32)
    p[np.arange(C), k[np.arange(C) % B]] = v
    q, p = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    valid = torch.ones(C, dtype=torch.bool, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, _ = knn.sims_splits(B, C, D, knn.sims_info(), sms)
    assert splits == (1 if D == 96 else 4)
    got = knn.masked_sims_cuda(q, p, valid)
    want = knn.masked_sims_ref(q, p, valid)
    torch.cuda.synchronize()
    err = (got - want).abs()
    bad = torch.nonzero(err > 1e-5)[:8].tolist()
    assert not bad, [(b, c, got[b, c].item(), want[b, c].item()) for b, c in bad]


def test_masked_sims_is_deterministic(cuda):
    """The split contraction adds its partial sums in split order, with no
    atomics: two calls give the same bits."""
    q, p, valid = _knn_inputs(cuda, 2, 256, 1024, 512, near=True)
    assert torch.equal(knn.masked_sims_cuda(q, p, valid), knn.masked_sims_cuda(q, p, valid))


def test_masked_sims_instantiation(cuda):
    """B4's first pass: one block an SM in the opt-in shared memory, no spills, and the whole register budget at
    launch (setmaxnreg hands the producer's registers to the consumers);
    the split choice fills the card at phase 7's chunk."""
    props = torch.cuda.get_device_properties(cuda)
    info = knn.sims_info()
    print(f"B4 instantiation: {info}")
    assert info["threads"] == 384 and info["blocks_per_sm"] == 1
    assert info["shared_bytes"] <= props.shared_memory_per_block_optin
    assert info["local_bytes"] == 0
    assert info["registers"] * info["threads"] >= 40 * 128 + 232 * 256
    splits, per = knn.sims_splits(256, 1024, 512, info, props.multi_processor_count)
    assert splits > 1 and 16 * splits <= props.multi_processor_count


def planted_topk_inputs(seed, B, C, D, k, bias=False, n_valid_per_query=None,
                        none_valid=False, dup=False):
    """Top-k inputs with no near-ties among each query's winners: query b's
    k+1 nearest prototypes are planted at growing distances, every other
    prototype is random (similarity ~0.14).  ``bias`` draws each class's
    shift from {0, -0.3}.  ``n_valid_per_query`` keeps only that many of
    each query's planted prototypes valid (and nothing else); ``dup`` copies
    query 0's nearest prototype onto two more slots (exact ties).
    → (q, p, valid, bias or None, planted [B, k+1])."""
    r = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    q = unit(r.standard_normal((B, D)))
    p = unit(r.standard_normal((C, D)))
    m = k + 1
    planted = r.permutation(C)[:B * m].reshape(B, m)
    t = np.linspace(0.2, 1.2, m)[:, None]
    for b in range(B):
        # noise orthogonal to q[b]: distance grows strictly with t
        n = r.standard_normal((m, D))
        n -= (n @ q[b])[:, None] * q[b][None, :]
        p[planted[b]] = unit(q[b] + t * unit(n))
    valid = np.ones(C, bool)
    if n_valid_per_query is not None:
        valid[:] = False
        valid[planted[:, :n_valid_per_query].reshape(-1)] = True
    if none_valid:
        valid[:] = False
    if dup:
        free = np.setdiff1d(np.arange(C), planted.reshape(-1))
        p[free[0]] = p[free[-1]] = p[planted[0, 0]]
    b = None
    if bias:
        # random on the others; on the planted ones a shift of the farther
        # half, which keeps the winners apart
        b = (-0.3 * r.integers(0, 2, C)).astype(np.float32)
        b[planted[:, :m // 2]] = 0.0
        b[planted[:, m // 2:]] = -0.3
    return q, p, valid, b, planted


def min_winner_gap(q, p, valid, bias, k):
    """Smallest gap between consecutive entries of each query's k+1 best
    valid values, in float64 (exact duplicates excluded)."""
    q, p = q.astype(np.float64), p.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] + (p * p).sum(1)[None, :] - 2.0 * q @ p.T
    v = np.exp(-np.maximum(d2, 0.0)) + (0.0 if bias is None else bias[None, :])
    v = np.where(valid[None, :], v, -np.inf)
    top = -np.sort(-v, axis=1)[:, :k + 1]
    finite = np.isfinite(top[:, 1:])
    gaps = np.where(finite, top[:, :-1] - np.where(finite, top[:, 1:], 0.0), 0.0)
    gaps = gaps[gaps > 0]
    return gaps.min() if gaps.size else np.inf


# B5: the main path's chunk (B 256, k 5), one ragged C, k 128 with bias, fewer
# valid prototypes than k, none valid, exact ties; then B off the 64-query
# tile and D off the 32-column slice (500) and off 16 bytes (510: the
# wrapper pads the rows with zero columns)
@pytest.mark.parametrize("B,C,k,bias,n_valid,none_valid,dup,D", [
    (256, 16384, 5, False, None, False, False, 512),
    (256, 16385, 1, True, None, False, False, 512),
    (64, 16384, 128, True, None, False, False, 512),
    (4, 16385, 20, False, 3, False, False, 512),
    (8, 16384, 5, False, None, True, False, 512),
    (16, 16384, 6, False, None, False, True, 512),
    (100, 16384, 5, True, None, False, False, 512),
    (70, 20000, 128, True, None, False, False, 512),
    (33, 5000, 7, False, None, False, False, 500),
    (33, 5000, 7, True, None, False, False, 510),
])
def test_topk_kernel_matches_plain(cuda, B, C, k, bias, n_valid, none_valid, dup, D):
    q, p, valid, b, planted = planted_topk_inputs(
        3, B, C, D, k, bias, n_valid, none_valid, dup)
    assert min_winner_gap(q, p, valid, b, k) > 1e-5
    q, p, valid = (torch.from_numpy(a).to(cuda) for a in (q, p, valid))
    b = None if b is None else torch.from_numpy(b).to(cuda)
    port.reset_launch_counts()
    vals, idx = knn_topk.topk_sims(q, p, valid, k, bias=b)
    want_v, want_i = knn_topk.topk_sims_ref(q, p, valid, k, bias=b)
    torch.cuda.synchronize()
    assert port.launch_counts["knn_topk"] == 1
    torch.testing.assert_close(vals, want_v, atol=1e-5, rtol=0)
    if dup:
        # exact ties rank by the lower prototype index
        free = np.setdiff1d(np.arange(C), planted.reshape(-1))
        assert idx[0, :3].tolist() == sorted([int(planted[0, 0]), int(free[0]),
                                              int(free[-1])])
    else:
        assert torch.equal(idx, want_i)
    scores, sidx = knn_topk.topk_scores_fused(q, p, valid, k, bias=b)
    assert torch.isfinite(scores).all()
    if none_valid:
        assert (sidx == -1).all() and (scores == 0).all()


def test_topk_instantiation_fills_the_card(cuda):
    """B5's first pass holds two blocks an SM at the main path's k and still
    fits at k 128 (one list a query row there, one a column warp up to k 8);
    its grid at the main path's chunk is one wave of at least one block an
    SM."""
    props = torch.cuda.get_device_properties(cuda)
    for k, per_sm, lists in ((5, 2, 4), (8, 2, 4), (9, 2, 1), (128, 1, 1)):
        info = knn_topk.topk_info(k)
        assert info["blocks_per_sm"] >= per_sm and info["lists"] == lists
        assert info["shared_bytes"] <= props.shared_memory_per_block_optin
    info = knn_topk.topk_info(5)
    splits, per = knn_topk._splits(256, 16384, info, cuda)
    rows = -(-256 // info["rows"])
    assert props.multi_processor_count <= splits * rows
    assert splits * rows <= info["blocks_per_sm"] * props.multi_processor_count
    assert splits <= info["max_splits"]


# ---------------------------------------------------------------------------
# the int8 kernels (B2, B3, B8, B9) and the int8 forward
# ---------------------------------------------------------------------------

def _int8_weight(r, shape, dev):
    w = torch.from_numpy((r.standard_normal(shape) * 0.05).astype(np.float32))
    q, s = quantization.quantize_weight(w)
    b = torch.from_numpy((r.standard_normal(shape[1]) * 0.01).astype(np.float32))
    return q.to(dev), s.to(dev), b.to(dev)


def _int8_layer(dev, seed, M, dtype, D=512, F=2048):
    """Rows of the zoo's widths (D 512, F 2048) and int8 weights for every
    product of a layer: O [D, D], QKV [D, 3D], W1 [D, F], W2 [F, D]."""
    r = np.random.default_rng(seed)
    rows = [torch.from_numpy((r.standard_normal((M, D)) * 0.5).astype(np.float32))
            .to(dev, dtype) for _ in range(2)]
    mats = {name: _int8_weight(r, shape, dev) for name, shape in
            (("o", (D, D)), ("qkv", (D, 3 * D)), ("w1", (D, F)), ("w2", (F, D)))}
    lns = [(torch.from_numpy((1.0 + 0.1 * r.standard_normal(D)).astype(np.float32)).to(dev),
            torch.from_numpy((0.1 * r.standard_normal(D)).astype(np.float32)).to(dev))
           for _ in range(2)]
    return rows, mats, lns


def _assert_int8_close(got, want, dtype, f32_atol=None):
    """f32: max abs error <= f32_atol, or (requantized GELU) per-row cosine
    >= 0.9999 and max abs error <= 0.05; bf16: cosine > 0.999."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    if dtype == torch.bfloat16:
        assert (g * w).sum() / (g.norm() * w.norm()) > 0.999
    elif f32_atol is not None:
        torch.testing.assert_close(g, w, atol=f32_atol, rtol=0)
    else:
        cos = (g * w).sum(1) / (g.norm(dim=1) * w.norm(dim=1))
        assert cos.min() >= 0.9999
        assert (g - w).abs().max() <= 0.05


_INT8_CASES = [(torch.float32, 8192), (torch.float32, 1000),
               (torch.bfloat16, 8192), (torch.bfloat16, 200)]


@pytest.mark.parametrize("dtype,M", _INT8_CASES)
def test_quant_matmul_kernel_matches_plain(cuda, dtype, M):
    (x, _), m, _ = _int8_layer(cuda, 0, M, dtype)
    port.reset_launch_counts()
    got = matmul_int8.quant_matmul_int8(x, *m["qkv"])
    want = matmul_int8.quant_matmul_int8_ref(x, *m["qkv"])
    torch.cuda.synchronize()
    assert port.launch_counts["matmul_int8"] == 1
    assert got.dtype == dtype and got.shape == (M, 1536)
    _assert_int8_close(got, want, dtype, f32_atol=1e-5)


# B2 at the zoo's N (1,536) and bert-base's (2,304), at a bert-base batch
# (M 4,096), a ragged banking chunk and a short batch: the int8 operands and
# int32 sums are exact and each epilogue step rounds as the plain version's,
# so every output equals it bit for bit
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4096, 8192 + 37, 200])
@pytest.mark.parametrize("D", [512, 768])
def test_quant_matmul_kernel_equals_plain_bit_for_bit(cuda, dtype, M, D):
    (x, _), m, _ = _int8_layer(cuda, 7, M, dtype, D=D, F=4 * D)
    port.reset_launch_counts()
    got = matmul_int8.quant_matmul_int8(x, *m["qkv"])
    want = matmul_int8.quant_matmul_int8_ref(x, *m["qkv"])
    torch.cuda.synchronize()
    assert port.launch_counts["matmul_int8"] == 1
    assert got.shape == (M, 3 * D) and got.dtype == dtype
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("dtype,M", _INT8_CASES)
def test_proj_residual_ln_kernel_matches_plain(cuda, dtype, M):
    (x, res), m, lns = _int8_layer(cuda, 1, M, dtype)
    args = (x, *m["o"], res, *lns[0], 1e-12)
    port.reset_launch_counts()
    got = matmul_int8.proj_residual_ln_int8(*args)
    want = matmul_int8.proj_residual_ln_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["proj_residual_ln_int8"] == 1
    _assert_int8_close(got, want, dtype, f32_atol=1e-4)


# B9 at a ragged banking chunk (32-row blocks at D 512) and at bert-base's
# width (16-row blocks at D 768), f32 to 1e-4 and bf16 to cosine 0.999
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(8192 + 37, 512), (4096, 768), (4096 + 5, 768)])
def test_proj_residual_ln_kernel_ragged_rows_and_widths(cuda, dtype, M, D):
    (x, res), m, lns = _int8_layer(cuda, 11, M, dtype, D=D, F=4 * D)
    args = (x, *m["o"], res, *lns[0], 1e-12)
    port.reset_launch_counts()
    got = matmul_int8.proj_residual_ln_int8(*args)
    want = matmul_int8.proj_residual_ln_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["proj_residual_ln_int8"] == 1
    assert got.shape == (M, D) and got.dtype == dtype
    _assert_int8_close(got, want, dtype, f32_atol=1e-4)


#: B9's local memory per thread (bytes) as measured on an H100: its
#: epilogue keeps the rows in the accumulators' registers under the
#: 128-register cap of two blocks an SM and spills some; without the cap
#: (one block an SM) it spills nothing and ran 1.2-1.3x slower
_B9_LOCAL_BYTES = {512: 224, 768: 112}


def test_proj_residual_ln_instantiation(cuda):
    """B9 on ring_gemm: 32-row blocks at D 512 and 16-row ones at D 768, two
    blocks an SM, no more local memory than measured for this design, a
    grid of at least one block an SM at every main-path shape; past D 1,024
    the wrapper raises."""
    props = torch.cuda.get_device_properties(cuda)
    for M, D, rows in ((8192, 512, 32), (32768, 512, 32), (4096, 768, 16)):
        info = matmul_int8.proj_residual_ln_info(M, D)
        assert info["rows"] == rows and info["threads"] == 256
        assert info["blocks_per_sm"] >= 2
        assert info["local_bytes"] <= _B9_LOCAL_BYTES[D]
        assert info["blocks"] >= props.multi_processor_count
    wide = torch.zeros((64, 1152), device=cuda)
    w = torch.zeros((1152, 1152), dtype=torch.int8, device=cuda)
    vec = torch.zeros(1152, device=cuda)
    with pytest.raises(ValueError, match="1024"):
        matmul_int8.proj_residual_ln_int8(wide, w, vec, vec, wide, vec, vec, 1e-12)


@pytest.mark.parametrize("dtype,M", _INT8_CASES)
def test_ffn_block_kernel_matches_plain(cuda, dtype, M):
    (h, _), m, lns = _int8_layer(cuda, 2, M, dtype)
    args = (h, *m["w1"], *m["w2"], *lns[0], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.ffn_block_int8(*args)
    want = ffn_int8.ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["ffn_int8"] == 1
    _assert_int8_close(got, want, dtype)


@pytest.mark.parametrize("dtype,M", _INT8_CASES)
def test_attn_ffn_block_kernel_matches_plain(cuda, dtype, M):
    (ctx, x), m, lns = _int8_layer(cuda, 3, M, dtype)
    args = (ctx, x, *m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.attn_ffn_block_int8(*args)
    want = ffn_int8.attn_ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["attn_ffn_int8"] == 1
    _assert_int8_close(got, want, dtype)


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    (x, _), m, lns = _int8_layer(cuda, 4, 64, torch.float32)
    w, s, b = m["qkv"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul_int8.quant_matmul_int8(x.half(), w, s, b)
    with pytest.raises(ValueError, match="multiple of 128"):
        matmul_int8.quant_matmul_int8(x[:, :500].contiguous(), w[:500].contiguous(), s, b)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_int8.quant_matmul_int8(x.t().contiguous().t(), w, s, b)
    with pytest.raises(ValueError, match="inputs on"):
        matmul_int8.quant_matmul_int8(x, w.cpu(), s, b)
    with pytest.raises(ValueError, match="int8"):
        ffn_int8.ffn_block_int8(x, m["w1"][0].float(), *m["w1"][1:], *m["w2"], *lns[0],
                                1e-12)
    with pytest.raises(ValueError, match="shared memory"):
        # F = 16,384: its q(f) tile alone needs more shared memory than a
        # block has
        r = np.random.default_rng(0)
        w1 = _int8_weight(r, (512, 16384), cuda)
        w2 = _int8_weight(r, (16384, 512), cuda)
        ffn_int8.ffn_block_int8(x, *w1, *w2, *lns[0], 1e-12)


@pytest.mark.parametrize("fuse_o", [False, True])
@pytest.mark.parametrize("dtype,M", [(torch.float32, 1000), (torch.bfloat16, 4096)])
def test_ffn_blocks_two_pass_at_bert_base_width(cuda, fuse_o, dtype, M):
    """At D 768, F 3,072 B3 and B8 run their two passes over W1 in 32-row
    blocks and match their plain versions."""
    (x, y), m, lns = _int8_layer(cuda, 5, M, dtype, D=768, F=3072)
    assert ffn_int8.ffn_block_info(768, 3072, o_proj=fuse_o)["rows"] == 32
    port.reset_launch_counts()
    if fuse_o:
        args = (x, y, *m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1], 1e-12)
        got = ffn_int8.attn_ffn_block_int8(*args)
        want = ffn_int8.attn_ffn_block_int8_ref(*args)
    else:
        args = (x, *m["w1"], *m["w2"], *lns[0], 1e-12)
        got = ffn_int8.ffn_block_int8(*args)
        want = ffn_int8.ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["attn_ffn_int8" if fuse_o else "ffn_int8"] == 1
    _assert_int8_close(got, want, dtype)


# B8 at the zoo's widths (64-row blocks) and bert-base's (32-row blocks), at
# M a multiple of the block, ragged past it, and short
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F,M", [(512, 2048, 8192), (512, 2048, 8192 + 37),
                                   (512, 2048, 200), (768, 3072, 4096),
                                   (768, 3072, 4096 + 37), (768, 3072, 200)])
def test_attn_ffn_block_kernel_ragged_rows_and_widths(cuda, dtype, D, F, M):
    (ctx, x), m, lns = _int8_layer(cuda, 8, M, dtype, D=D, F=F)
    args = (ctx, x, *m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.attn_ffn_block_int8(*args)
    want = ffn_int8.attn_ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["attn_ffn_int8"] == 1
    assert port.launch_counts["ffn_int8"] == 0
    assert got.shape == (M, D) and got.dtype == dtype
    _assert_int8_close(got, want, dtype)


# B3 at ragged M for its 64-row (D 512) and 32-row blocks, at the zoo's and
# bert-base's widths, at widths whose second product has an odd number of n8
# tiles a warp (D 128, 384) and at bert-large's (D 1,024, F 4,096: the
# largest shared-memory layout)
@pytest.mark.parametrize("dtype,M,D,F", [
    (torch.bfloat16, 8192 + 37, 512, 2048), (torch.float32, 8192 + 37, 512, 2048),
    (torch.bfloat16, 4096 + 37, 768, 3072), (torch.float32, 1000, 768, 3072),
    (torch.bfloat16, 1000, 128, 512), (torch.float32, 333, 384, 1152),
    (torch.bfloat16, 2048 + 5, 1024, 4096),
])
def test_ffn_block_kernel_ragged_rows_and_widths(cuda, dtype, M, D, F):
    (h, _), m, lns = _int8_layer(cuda, 6, M, dtype, D=D, F=F)
    args = (h, *m["w1"], *m["w2"], *lns[0], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.ffn_block_int8(*args)
    want = ffn_int8.ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["ffn_int8"] == 1
    assert got.shape == (M, D) and got.dtype == dtype
    _assert_int8_close(got, want, dtype)


def test_ffn_block_instantiation(cuda):
    """B3 takes 64 rows a block at the zoo's widths and 32 at bert-base's,
    one block of 16 warps per SM, within the card's shared memory."""
    props = torch.cuda.get_device_properties(cuda)
    for (D, F), rows in (((512, 2048), 64), ((768, 3072), 32), ((1024, 4096), 32)):
        info = ffn_int8.ffn_block_info(D, F)
        assert info["rows"] == rows and info["threads"] == 512
        assert info["blocks_per_sm"] == 1
        assert info["shared_bytes"] <= props.shared_memory_per_block_optin


#: B8's local memory per thread (bytes) as measured on an H100 at D 512,
#: 768 and 1,024: B3's (160, 48, 168) plus the frame of its non-inlined
#: O-projection stage; its spill stores (ptxas) are below B3's at D 512
_B8_LOCAL_BYTES = {512: 168, 768: 56, 1024: 232}


def test_post_attention_body_and_qkv_instantiation(cuda):
    """B8 runs B3's blocks (64 rows at the zoo's widths, 32 at bert-base's
    and bert-large's, 16 warps, one block per SM) with no more local memory
    than measured for this design; B2 runs at least two blocks per SM, on a
    grid of at least two blocks per SM at every main-path shape, with no
    spills."""
    props = torch.cuda.get_device_properties(cuda)
    for (D, F), rows in (((512, 2048), 64), ((768, 3072), 32), ((1024, 4096), 32)):
        b8 = ffn_int8.ffn_block_info(D, F, o_proj=True)
        assert b8["rows"] == rows and b8["threads"] == 512
        assert b8["blocks_per_sm"] == 1
        assert b8["shared_bytes"] <= props.shared_memory_per_block_optin
        assert b8["local_bytes"] <= _B8_LOCAL_BYTES[D]
    for M, D in ((8192, 512), (32768, 512), (4096, 768)):
        b2 = matmul_int8.quant_matmul_info(M, D, 3 * D)
        assert b2["blocks_per_sm"] >= 2
        assert b2["blocks"] >= 2 * props.multi_processor_count
        assert b2["local_bytes"] == 0


def test_int8_load_makes_the_k_contiguous_copies_once(cuda, tmp_path):
    """The int8 load path makes the K-contiguous weights of B2, B3 and B8
    once, four per layer (QKV, O and the FFN's two); serving makes none."""
    before = ffn_int8.k_contiguous_copies
    clf = port.AdaptiveClassifier.load(_int8_zoo(tmp_path))
    layers = clf.encoder.config.num_layers
    assert ffn_int8.k_contiguous_copies == before + 4 * layers
    for name in ("qkv_w", "o_w", "ffn_in_w", "ffn_out_w"):
        w = clf.encoder.params[f"layers.0.{name}.int8"]
        assert torch.equal(w._ac_k_contiguous, w.t())
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for ts in data["test"].values() for t in ts]
    for _ in range(2):
        clf._clear_embedding_caches()    # each pass runs the encoder
        port.reset_launch_counts()
        clf.predict_batch(texts, k=1)
        assert port.launch_counts["ffn_int8"] == layers
        assert port.launch_counts["matmul_int8"] == layers
    assert ffn_int8.k_contiguous_copies == before + 4 * layers


def _int8_zoo(tmp_path, task="banking-intents"):
    """A copy of a zoo classifier with ``quantization: "int8"``, its encoder
    named by absolute path."""
    dst = tmp_path / task
    shutil.copytree(REPO / "checkpoints/zoo" / task, dst)
    cfg = json.loads((dst / "config.json").read_text())
    cfg["config"]["quantization"] = "int8"
    cfg["model_name"] = str(REPO / "checkpoints/ac-base-v2")
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


def test_int8_zoo_predict_batch_on_the_gpu(cuda, tmp_path):
    clf = port.AdaptiveClassifier.load(_int8_zoo(tmp_path))
    assert clf.encoder.quantization == "int8"
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, lbl) for lbl in data["train"] for t in data["test"][lbl]]
    port.reset_launch_counts()
    preds = clf.predict_batch([t for t, _ in rows], k=1)
    layers = clf.encoder.config.num_layers
    assert port.launch_counts["matmul_int8"] == layers
    assert port.launch_counts["ffn_int8"] == layers
    assert port.launch_counts["attention_qkv"] == layers
    assert port.launch_counts["attn_ffn_int8"] == 0
    acc = np.mean([p[0][0] == lbl for p, (_, lbl) in zip(preds, rows)])
    assert acc >= 0.92 - 0.03


def test_int8_forward_fuse_o_proj_on_the_gpu(cuda, tmp_path):
    """fuse_o_proj=True sends every layer's post-attention body through B8.
    Per embedding (pooled, one per text): in f32 it computes the default
    int8 forward's function up to the LayerNorms' last bits (cosine >=
    0.999); in bf16 the default forward also rounds to bf16 between the
    products where B8 keeps f32 (the int8 envelope, cosine > 0.99)."""
    from adaptive_classifier_tpu_torch.models.encoder import pool_and_normalize

    clf = port.AdaptiveClassifier.load(_int8_zoo(tmp_path))
    enc = clf.encoder
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for ts in data["test"].values() for t in ts][:256]
    ids, mask = enc.tokenizer(texts, max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    ids, mask = torch.from_numpy(ids).to(cuda), torch.from_numpy(mask).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            base = encoder_int8.encoder_forward_int8(
                enc.params, ids, mask, enc.config, compute_dtype=dtype,
                attn_impl="fusedqkv")
            port.reset_launch_counts()
            fused = encoder_int8.encoder_forward_int8(
                enc.params, ids, mask, enc.config, compute_dtype=dtype,
                attn_impl="fusedqkv", fuse_o_proj=True)
        torch.cuda.synchronize()
        assert port.launch_counts["attn_ffn_int8"] == enc.config.num_layers
        assert port.launch_counts["ffn_int8"] == 0
        a = pool_and_normalize(base, mask, enc.config.pooling)
        b = pool_and_normalize(fused, mask, enc.config.pooling)
        cos = ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min()
        assert cos >= (0.999 if dtype == torch.float32 else 0.99)


# ---------------------------------------------------------------------------
# flash (B6) and one-shot (B7) attention, the fused add + LayerNorm (B10)
# ---------------------------------------------------------------------------

def _heads(dev, seed, dtype, B, S, H, Dh, masked_row=None):
    """q, k, v as ``[B, S, H, Dh]`` views of one packed ``[B, S, 3D]``
    tensor (the encoder's layout) and a ragged mask."""
    qkv, mask = _inputs(dev, seed, dtype, B, S, H, Dh, masked_row)
    D = H * Dh
    return [qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3)], mask


def _assert_attention_close(got, want, dtype):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    else:
        assert (g * w).sum() / (g.norm() * w.norm()) > 0.999
        torch.testing.assert_close(g, w, atol=0.05, rtol=0)


_FLASH_CASES = [(torch.float32, 4, 128, 8, 64), (torch.bfloat16, 256, 32, 8, 64),
                (torch.bfloat16, 4, 512, 12, 64), (torch.float32, 2, 1024, 12, 64),
                (torch.bfloat16, 2, 2048, 8, 64), (torch.float32, 3, 131, 3, 24),
                (torch.bfloat16, 2, 200, 2, 128)]


@pytest.mark.parametrize("dtype,B,S,H,Dh", _FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, Dh):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 5, dtype, B, S, H, Dh)
    port.reset_launch_counts()
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_attention"] == 1
    assert got.shape == (B, S, H, Dh) and got.dtype == dtype
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype,B,S,H,Dh", [c for c in _FLASH_CASES if c[2] <= 512]
                         + [(torch.float32, 2, 1000, 4, 64), (torch.bfloat16, 1, 2048, 2, 64)])
def test_oneshot_kernel_matches_plain(cuda, dtype, B, S, H, Dh):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 6, dtype, B, S, H, Dh)
    port.reset_launch_counts()
    got = fa.oneshot_attention(q, k, v, mask)
    want = fa.oneshot_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert port.launch_counts["oneshot_attention"] == 1
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("kernel", ["flash_attention", "oneshot_attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_fully_masked_row(cuda, kernel, dtype):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 7, dtype, 3, 100, 2, 64, masked_row=1)
    got = getattr(fa, kernel)(q, k, v, mask).float()
    uniform = v[1].float().mean(dim=0)
    atol = 1e-4 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(got[1], uniform.expand(100, -1, -1), atol=atol, rtol=0)


def _padded_heads(dev, seed, B, S, H, Dh, extra):
    """As ``_heads`` in bf16, with ``extra`` unused columns after each packed
    row, so an odd ``extra`` leaves the rows off 16 bytes."""
    qkv, mask = _inputs(dev, seed, torch.bfloat16, B, S, H, Dh)
    D = H * Dh
    if extra:
        wide = torch.zeros((B, S, 3 * D + extra), dtype=qkv.dtype, device=dev)
        wide[..., :3 * D] = qkv
        qkv = wide[..., :3 * D]
    return [qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3)], mask


# the bf16 tensor-core tile loop at its edges: rows that are not a multiple
# of 16 or 64 keys, Dh 20 (rows off 16 bytes: staged element by element),
# 24 and 32 (the 32-wide tiles), 40 (zero-padded to 64), 100 (off 16 bytes,
# 128-wide) and 128 at short and long rows, an odd row stride at Dh 64 at
# short and long rows, B7 at its longest row
_TILE_EDGES = [(3, 1, 4, 64, 0), (3, 17, 4, 64, 0), (3, 33, 4, 64, 0), (3, 65, 4, 64, 0),
               (2, 100, 3, 20, 0), (3, 20, 4, 32, 0), (2, 50, 2, 24, 0),
               (2, 100, 3, 40, 0), (2, 70, 2, 100, 0), (2, 30, 2, 128, 0),
               (2, 300, 2, 128, 0), (3, 25, 4, 64, 1), (2, 100, 4, 64, 1),
               (1, 2048, 4, 64, 0)]


@pytest.mark.parametrize("kernel", ["flash_attention", "oneshot_attention"])
@pytest.mark.parametrize("B,S,H,Dh,extra", _TILE_EDGES)
def test_tensor_core_tile_edges(cuda, kernel, B, S, H, Dh, extra):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _padded_heads(cuda, 9, B, S, H, Dh, extra)
    port.reset_launch_counts()
    got = getattr(fa, kernel)(q, k, v, mask)
    want = getattr(fa, kernel + "_ref")(q, k, v, mask)
    torch.cuda.synchronize()
    assert port.launch_counts[kernel] == 1
    assert got.shape == (B, S, H, Dh) and got.dtype == torch.bfloat16
    _assert_attention_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("kernel", ["flash_attention", "oneshot_attention"])
def test_flash_kernels_fully_masked_short_row(cuda, kernel):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 10, torch.bfloat16, 3, 17, 4, 64, masked_row=2)
    got = getattr(fa, kernel)(q, k, v, mask).float()
    uniform = v[2].float().mean(dim=0)
    torch.testing.assert_close(got[2], uniform.expand(17, -1, -1), atol=0.05, rtol=0)
    _assert_attention_close(got, getattr(fa, kernel + "_ref")(q, k, v, mask),
                            torch.bfloat16)


@pytest.mark.parametrize("kernel", ["flash_attention", "oneshot_attention"])
def test_flash_kernels_are_deterministic(cuda, kernel):
    """No atomics and a fixed order of sums: two launches agree bit for bit."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 11, torch.bfloat16, 4, 512, 12, 64)
    first = getattr(fa, kernel)(q, k, v, mask)
    second = getattr(fa, kernel)(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("oneshot", [False, True])
def test_tensor_core_instantiation_fits_four_blocks(cuda, oneshot):
    """At the main path's shape (bf16, Dh 64) a block is 4 warps with 45.5 KB
    of shared memory (Q, a two-slot K/V ring, the key biases) and at most
    128 registers a thread, unspilled: four blocks share an SM."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), _ = _heads(cuda, 12, torch.bfloat16, 2, 128, 8, 64)
    info = fa.kernel_info(q, k, v, oneshot)
    assert info["threads"] == 128
    assert info["shared_bytes"] == 2 * (64 * 72 + 2 * 2 * 64 * 72) + 4 * 2 * 64
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= 4


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 8, torch.float32, 2, 64, 2, 32)
    with pytest.raises(ValueError, match="share strides"):
        fa.flash_attention(q.contiguous(), k, v, mask)
    with pytest.raises(ValueError, match="one device"):
        fa.oneshot_attention(q, k, v, mask.cpu())
    big = torch.zeros(1, 2056, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fa.oneshot_attention(big, big, big, torch.ones(1, 2056, device=cuda))


_LN_CASES = [(torch.float32, 8192, 512), (torch.bfloat16, 32768, 512),
             (torch.bfloat16, 1000, 512), (torch.float32, 333, 768),
             (torch.bfloat16, 64, 128)]


def _bf16_step(w):
    """One bf16 step at |w|, taken at 2^-7 below it, where the f32 results'
    ~1e-6 absolute difference exceeds a step."""
    return 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -7))) - 7)


@pytest.mark.parametrize("dtype,M,D", _LN_CASES)
def test_add_layer_norm_kernel_matches_plain(cuda, dtype, M, D):
    from adaptive_classifier_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device="cpu").manual_seed(M + D)
    x, r = ((2.0 * torch.randn((M, D), generator=g) + 0.3).to(cuda, dtype)
            for _ in range(2))
    scale = (1.0 + 0.1 * torch.randn(D, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(D, generator=g)).to(cuda)
    port.reset_launch_counts()
    got = ln.add_layer_norm(x, r, scale, bias, 1e-12)
    want = ln.add_layer_norm_ref(x, r, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert port.launch_counts["add_layer_norm"] == 1
    assert got.dtype == dtype and got.shape == (M, D)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        w = want.float()
        assert ((got.float() - w).abs() <= _bf16_step(w)).all()


def test_add_layer_norm_refuses_what_it_does_not_take(cuda):
    from adaptive_classifier_tpu_torch.ops import layernorm as ln

    x = torch.zeros(16, 512, device=cuda)
    s, b = torch.ones(512, device=cuda), torch.zeros(512, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ln.add_layer_norm(x.t().contiguous().t(), x, s, b, 1e-12)
    with pytest.raises(ValueError, match="aligned"):
        y = torch.zeros(16 * 512 + 1, device=cuda)[1:].view(16, 512)
        ln.add_layer_norm(y, x, s, b, 1e-12)
    with pytest.raises(ValueError, match="one device"):
        ln.add_layer_norm(x, x, s.cpu(), b, 1e-12)


@pytest.mark.parametrize("impl,kernel", [("flash", "flash_attention"),
                                         ("oneshot", "oneshot_attention")])
def test_zoo_predict_batch_through_flash_kernels(cuda, monkeypatch, impl, kernel):
    """AC_ATTN_IMPL sends every layer through B6 or B7, as in the JAX
    package; the answers stay those of the packed-QKV kernel."""
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for lbl in data["train"] for t in data["test"][lbl]]
    base = [p[0][0] for p in clf.predict_batch(texts, k=1)]
    clf._clear_embedding_caches()    # the second pass runs the encoder again
    monkeypatch.setenv("AC_ATTN_IMPL", impl)
    port.reset_launch_counts()
    preds = [p[0][0] for p in clf.predict_batch(texts, k=1)]
    assert port.launch_counts[kernel] == clf.encoder.config.num_layers
    assert port.launch_counts["attention_qkv"] == 0
    assert np.mean([a == b for a, b in zip(preds, base)]) >= 0.99


def test_bf16_forward_through_fused_layer_norm(cuda, monkeypatch):
    from adaptive_classifier_tpu_torch.models import encoder as tenc

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    enc = tenc.Encoder(str(REPO / "checkpoints/ac-base-v2"), device=cuda)
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for ts in data["test"].values() for t in ts][:256]
    ids, mask = enc.tokenizer(texts, max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    ids, mask = torch.from_numpy(ids).to(cuda), torch.from_numpy(mask).to(cuda)

    def embed(flag):
        with torch.inference_mode():
            return tenc.embed_texts_device(enc.params, ids, mask, enc.config,
                                           enc.compute_dtype, attn_impl="fusedqkv",
                                           use_fused_ln=flag)

    base = embed(False)
    port.reset_launch_counts()
    fused = embed(True)
    torch.cuda.synchronize()
    assert port.launch_counts["add_layer_norm"] == 2 * enc.config.num_layers
    assert ((fused * base).sum(-1)).min() >= 0.999


def test_offline_encoder_on_the_gpu(cuda, monkeypatch):
    """The offline bert-tiny on the card against the same weights on the
    CPU (float32; the card's kernels against the CPU's plain versions)."""
    from adaptive_classifier_tpu_torch.models import encoder as tenc

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    texts = ["where is my card?", "I was charged twice for a top-up", ""]
    gpu = tenc.Encoder("prajjwal1/bert-tiny", compute_dtype="float32", device=cuda)
    cpu = tenc.Encoder("prajjwal1/bert-tiny", compute_dtype="float32", device="cpu")
    torch.testing.assert_close(gpu.embed(texts).cpu(), cpu.embed(texts), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the gradient fit and saving on the card
# ---------------------------------------------------------------------------

def _fit_inputs(dev, seed=0, n=70, n_cap=128, D=64, C=16, n_classes=6):
    from adaptive_classifier_tpu_torch.models import head as thead

    g = torch.Generator().manual_seed(seed)
    centers = 2.0 * torch.randn((n_classes, D), generator=g)
    y = torch.zeros((n_cap,), dtype=torch.int64)
    y[:n] = torch.arange(n) % n_classes
    emb = torch.zeros((n_cap, D))
    emb[:n] = centers[y[:n]] + 0.5 * torch.randn((n, D), generator=g)
    params = thead.init_head(D, C, n_classes, hidden_dims=[D, D // 2],
                             generator=torch.Generator().manual_seed(seed + 1))
    params = thead.ensure_skip(params, D)
    move = lambda t: t.to(dev)
    from adaptive_classifier_tpu_torch.training import tree_map

    return (tree_map(move, params), emb.to(dev), y.to(dev), (torch.arange(n_cap) < n).to(dev),
            (torch.arange(C) < n_classes).to(dev))


def test_fit_head_on_the_gpu_matches_the_cpu(cuda, monkeypatch):
    """The same draws (the CPU run's, recorded and handed to the card's
    run): at the config's learning rate the card's fit equals the CPU's
    within 1e-5 (TF32 off).  (Once the loss nears 0, AdamW's ``m/sqrt(v)``
    of vanishing gradients turns last-bit differences into steps of the
    learning rate: at a much larger rate the two fits part by more.)"""
    from adaptive_classifier_tpu_torch import training
    from adaptive_classifier_tpu_torch.models import head as thead

    draws = []
    perm, keep = training._epoch_permutation, thead._keep_mask
    monkeypatch.setattr(training, "_epoch_permutation",
                        lambda g, v: draws.append(perm(g, v)) or draws[-1])
    monkeypatch.setattr(thead, "_keep_mask", lambda g, s: draws.append(keep(g, s)) or draws[-1])
    kw = dict(lr=1e-3, loss_type="ce", max_epochs=8, patience=3, use_scheduler=True)
    cpu = training.fit_head(*_fit_inputs("cpu"), torch.Generator().manual_seed(3), **kw)
    replay = [d.to(cuda) for d in draws]
    monkeypatch.setattr(training, "_epoch_permutation", lambda g, v: replay.pop(0))
    monkeypatch.setattr(thead, "_keep_mask", lambda g, s: replay.pop(0))
    gpu = training.fit_head(*_fit_inputs(cuda), torch.Generator(cuda).manual_seed(3), **kw)
    assert replay == [] and gpu.epochs_run == cpu.epochs_run
    assert abs(gpu.final_loss - cpu.final_loss) <= 1e-5
    for a, b in zip(training.tree_leaves(gpu.params), training.tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def test_grad_masked_fit_keeps_frozen_entries_on_the_gpu(cuda):
    from adaptive_classifier_tpu_torch import training

    params, emb, y, valid, active = _fit_inputs(cuda, seed=5)
    C = params["out"]["w"].shape[1]
    new = (torch.arange(C, device=cuda) >= 4).float()
    mask = training.tree_map(torch.zeros_like, params)
    mask["out"]["w"] = new[None, :].expand_as(params["out"]["w"]).clone()
    mask["out"]["b"] = new
    mask["skip"]["w"] = new[None, :].expand_as(params["skip"]["w"]).clone()
    onehot = torch.nn.functional.one_hot(y, C).float()
    res = training.fit_head(params, emb, onehot, valid, active,
                            torch.Generator(cuda).manual_seed(0), lr=0.05, loss_type="bce",
                            max_epochs=6, patience=10, use_scheduler=False, grad_mask=mask)
    x = emb[:8]
    from adaptive_classifier_tpu_torch.models.head import head_forward

    assert torch.equal(head_forward(res.params, x)[:, :4], head_forward(params, x)[:, :4])
    for p0, p1, m in zip(*(training.tree_leaves(t) for t in (params, res.params, mask))):
        assert torch.equal(p1[m == 0], p0[m == 0])
        if (m > 0).any():
            assert not torch.equal(p1[m > 0], p0[m > 0])


def test_save_on_the_gpu_loads_on_the_cpu(cuda, tmp_path, monkeypatch):
    """The default configuration (MLP head) built on the card, saved, and
    loaded on the CPU: the same predictions, scores within 1e-4."""
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    cfg = {"compute_dtype": "float32", "train_size_buckets": [64, 256],
           "class_capacity_buckets": [8, 16, 32], "example_capacity_buckets": [32, 128]}
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for ts in data["train"].values() for t in ts]
    labels = [l for l, ts in data["train"].items() for _ in ts]
    clf = port.AdaptiveClassifier(str(REPO / "checkpoints/ac-base-v2"), device=cuda, config=cfg)
    clf.add_examples(texts, labels)
    clf.save(tmp_path / "ckpt")
    back = port.AdaptiveClassifier.load(tmp_path / "ckpt", device="cpu")
    queries = [t for ts in data["test"].values() for t in ts][:40]
    got, want = back.predict_batch(queries, k=3), clf.predict_batch(queries, k=3)
    assert [[l for l, _ in r] for r in got] == [[l for l, _ in r] for r in want]
    np.testing.assert_allclose([[s for _, s in r] for r in got],
                               [[s for _, s in r] for r in want], atol=1e-4)


# ---------------------------------------------------------------------------
# serving on the card: the device embedding cache, concurrent predicts,
# calibration, exact launch counts
# ---------------------------------------------------------------------------

def test_device_cache_on_the_gpu(cuda):
    """A padded chunk writes only its rows (no out-of-bounds write, so no
    device assert), the ring evicts the oldest slot, and a gather returns
    the stored rows bit for bit."""
    from adaptive_classifier_tpu_torch.utils.cache import DeviceEmbeddingCache

    c = DeviceEmbeddingCache(capacity=4, dim=96, device=cuda)
    r = torch.Generator(device=cuda).manual_seed(0)
    rows = torch.randn(64, 96, device=cuda, generator=r)
    c.store(["a", "b", "c"], 32, rows)
    torch.cuda.synchronize()
    assert torch.equal(c._buf[3], torch.zeros(96, device=cuda))
    hits, misses = c.lookup(["a", "b", "c", "x"], 32)
    assert misses == [3]
    assert torch.equal(c.gather([s for _, s in hits]), rows[:3])
    c.store(["d", "e"], 32, rows[10:18])
    _, misses = c.lookup(["a", "b", "c", "d", "e"], 32)
    assert misses == [0]
    hits, _ = c.lookup(["d", "e"], 32)
    assert torch.equal(c.gather([s for _, s in hits]), rows[10:12])


def test_two_threads_predict_like_serial_calls(cuda, monkeypatch):
    """Two threads calling predict_batch at once on one classifier (the
    caches on) give the answers of serial calls on a fresh one."""
    import threading

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for lbl in data["train"] for t in data["test"][lbl]]
    halves = [texts[0::2], texts[1::2]]
    serial = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    want = [serial.predict_batch(h, k=3) for h in halves]
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    got, errors = [None, None], []

    def run(i):
        try:
            for _ in range(3):
                got[i] = clf.predict_batch(halves[i], k=3)
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for g, w in zip(got, want):
        assert [p[0][0] for p in g] == [p[0][0] for p in w]
        np.testing.assert_allclose([p[0][1] for p in g], [p[0][1] for p in w], atol=1e-3)


def test_temperature_fit_on_the_gpu_equals_the_cpu(cuda):
    from adaptive_classifier_tpu_torch.calibration import TemperatureScaler

    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(5) * 0.7, size=800).astype(np.float32)
    y = np.asarray([rng.choice(5, p=row / row.sum()) for row in p], np.int64)
    gpu = TemperatureScaler(device=cuda).fit(p, y)
    cpu = TemperatureScaler(device="cpu").fit(p, y)
    assert gpu.grid_index == cpu.grid_index
    assert gpu.temperature == pytest.approx(cpu.temperature, rel=1e-6)
    np.testing.assert_allclose(gpu.transform(p), cpu.transform(p), atol=1e-6)


def test_masked_sims_first_call_in_a_new_thread(cuda):
    """B4's first launch from a host thread that has made no CUDA call yet,
    every tensor it allocates served from the allocator's cache (a serving
    worker's case): the tensor-map encoder needs the device's context bound
    to that thread, and the launcher binds it."""
    import threading

    q = torch.randn(64, 128, device=cuda)
    p = torch.randn(1024, 128, device=cuda)
    valid = torch.ones(1024, dtype=torch.bool, device=cuda)
    want = knn.masked_sims_cuda(q, p, valid).clone()   # out and scratch now cached
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(knn.masked_sims_cuda(q, p, valid))
        except Exception as e:   # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)


def test_launch_counts_stay_exact_under_two_threads(cuda):
    import threading

    q = torch.randn(64, 128, device=cuda)
    p = torch.randn(1024, 128, device=cuda)
    valid = torch.ones(1024, dtype=torch.bool, device=cuda)
    port.reset_launch_counts()
    n = 300

    def run():
        for _ in range(n):
            knn.masked_sims_cuda(q, p, valid)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    assert port.launch_counts["knn_sims"] == 2 * n
