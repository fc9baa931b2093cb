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
    # ELECTRA-small's width: D 256, 4 heads of 64
    (torch.bfloat16, 256, 32, 4, 64),
    (torch.float32, 8, 128, 4, 64),
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


# B1 in bf16 at the edges of its forms: the tile loop's one 32-key tile and
# 2 warps (S 8, 24) and one 64-key tile (40, 48); the wgmma kernel's rows
# kept whole by a warpgroup (72, 96, 128, 136, 200) and split between the
# two (512); Dh 24 and 40 (zero-padded), 32 and 128; a base off 16 bytes
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
    """At the hallucination chunk's S = 128 (bf16, Dh 64) B1 runs the wgmma
    kernel of csrc/attention_hopper.cuh in its one-pass ROWS form: a
    producer warpgroup and two consumer warpgroups (384 threads), each
    warpgroup's [64, 128] scores in registers, unspilled; two Q buffers of
    128 rows, a ring of 16 K/V tiles of 64 keys with their key biases and
    the barriers in 165 KB of shared memory, one block an SM (persistent)."""
    from adaptive_classifier_tpu_torch.ops import attention_qkv as aq

    qkv, _ = _inputs(cuda, 40, torch.bfloat16, 2, 128, 8, 64)
    info = aq.kernel_info(qkv, 8, 64)
    assert info["threads"] == 384 and info["warpgroups"] == 2
    assert info["wgmma_form"] == "rows" and info["tma"]
    assert info["shared_bytes"] == (2 * 128 * 64 * 2 + 16 * (64 * 64 * 2 + 64 * 4)
                                    + 8 * (4 + 2 * 16) + 1024)
    assert info["local_bytes"] == 0
    assert info["blocks_per_sm"] == 1


# the wgmma kernel's forms (csrc/attention_hopper.cuh) by row length, head
# width and alignment: S, Dh, element offset of the base -> form, TMA-fed
_WGMMA_FORMS = [(72, 64, 0, "rows", True), (128, 64, 0, "rows", True),
                (136, 64, 0, "rows", True), (256, 64, 0, "rows", True),
                (264, 64, 0, "split keys", True), (512, 64, 0, "split keys", True),
                (520, 64, 0, "two passes", True), (256, 128, 0, "rows", True),
                (512, 128, 0, "split keys", True), (512, 32, 0, "split keys", True),
                (128, 64, 1, "rows", False), (512, 64, 3, "split keys", False)]


@pytest.mark.parametrize("S,Dh,offset,form,tma", _WGMMA_FORMS)
def test_attention_wgmma_instantiations(cuda, S, Dh, offset, form, tma):
    """Each form B1 launches above 64 keys is unspilled (ptxas keeps the
    score block in registers) and fits one block an SM."""
    from adaptive_classifier_tpu_torch.ops import attention_qkv as aq

    qkv, _ = _inputs(cuda, 41, torch.bfloat16, 2, S, 4, Dh)
    if offset:
        buf = torch.zeros(qkv.numel() + offset, dtype=qkv.dtype, device=cuda)
        qkv = buf[offset:].view(qkv.shape)
    info = aq.kernel_info(qkv, 4, Dh)
    assert (info["wgmma_form"], info["tma"]) == (form, tma)
    assert info["threads"] == 384 and info["warpgroups"] == 2
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 1


# B1 and B7 at the edges of the wgmma forms: the last ROWS rows (S 136:
# three tiles in four, 256), the first and last SPLIT rows (264, 512), the
# first two-pass row (520), two passes at 1,024 and 2,048; Dh 32
# (zero-padded to 64) and 128 (two swizzle atoms) in each one-pass form;
# batch row 1 fully masked
_WGMMA_EDGES = [(8, 136, 8, 64), (4, 256, 8, 64), (4, 264, 4, 64), (4, 512, 12, 64),
                (2, 520, 4, 64), (4, 128, 8, 32), (3, 256, 4, 32), (3, 512, 4, 32),
                (4, 128, 4, 128), (3, 256, 4, 128), (3, 512, 2, 128), (2, 520, 2, 128)]


@pytest.mark.parametrize("kernel", ["attention_qkv", "oneshot_attention"])
@pytest.mark.parametrize("B,S,H,Dh", _WGMMA_EDGES + [(2, 1024, 4, 64), (2, 2048, 4, 64)])
def test_attention_wgmma_edges(cuda, kernel, B, S, H, Dh):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    qkv, mask = _inputs(cuda, 50 + S + Dh, torch.bfloat16, B, S, H, Dh, masked_row=1)
    port.reset_launch_counts()
    if kernel == "attention_qkv":
        got = attention_from_qkv(qkv, mask, H, Dh)
        want = attention_from_qkv_ref(qkv, mask, H, Dh)
        v = qkv[1, :, 2 * H * Dh:].unflatten(-1, (H, Dh))
    else:
        q, k, v3 = _packed_views(qkv, H, Dh)
        got = fa.oneshot_attention(q, k, v3, mask).flatten(-2)
        want = fa.oneshot_attention_ref(q, k, v3, mask).flatten(-2)
        v = v3[1]
    torch.cuda.synchronize()
    assert port.launch_counts[kernel] == 1
    _assert_attention_close(got, want, torch.bfloat16)
    # a fully masked row is the uniform average of V over exactly S keys
    uniform = v.float().mean(dim=0).flatten()
    torch.testing.assert_close(got[1].float(), uniform.expand(S, -1), atol=0.05, rtol=0)


@pytest.mark.parametrize("S", [128, 512])
def test_attention_kernel_never_reads_the_next_batch_row(cuda, S):
    """B1's tensor maps see qkv as [B, S, H, Dh] at each of the q, k, v
    offsets: a box clips at its own batch row's S, so NaN in batch row 1
    leaves rows 0 and 2 as the plain version computes them."""
    B, H, Dh = 3, 4, 64
    qkv, mask = _inputs(cuda, 60 + S, torch.bfloat16, B, S, H, Dh)
    qkv[1] = float("nan")
    got = attention_from_qkv(qkv, mask, H, Dh)
    want = attention_from_qkv_ref(qkv, mask, H, Dh)
    torch.cuda.synchronize()
    for b in (0, 2):
        _assert_attention_close(got[b], want[b], torch.bfloat16)


@pytest.mark.parametrize("kernel", ["attention_qkv", "oneshot_attention", "flash_attention"])
def test_attention_wgmma_first_call_in_a_new_thread(cuda, kernel):
    """The first launch from a host thread that has made no CUDA call yet,
    every tensor it allocates served from the allocator's cache (a serving
    worker's case): the tensor-map encoder needs the device's context bound
    to that thread, and the launcher binds it."""
    import threading

    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    H, Dh = 8, 64
    qkv, mask = _inputs(cuda, 70, torch.bfloat16, 16, 128, H, Dh)
    q, k, v = _packed_views(qkv, H, Dh)
    if kernel == "attention_qkv":
        call = lambda: attention_from_qkv(qkv, mask, H, Dh)   # noqa: E731
    else:
        call = lambda: getattr(fa, kernel)(q, k, v, mask)     # noqa: E731
    want = call().clone()                                     # out now cached
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(call())
        except Exception as e:   # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)


def test_unported_kernels_raise_on_the_gpu(cuda, monkeypatch):
    """Every kernel is ported: S >= 1024 takes the flash kernel (B6), and a
    length outside B1's envelope the plain attention, as the JAX package
    takes its plain ``jnp`` attention there."""
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints/zoo/banking-intents")
    assert clf.encoder._attn_impl(1024) == "flash"
    assert clf.encoder._attn_impl(64) == "fusedqkv"
    assert clf.encoder._attn_impl(60) == "einsum"


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
    with pytest.raises(ValueError, match="1024"):
        # D = 1,152: past the widest W2 share the kernel keeps in registers
        r = np.random.default_rng(0)
        wide = torch.zeros((64, 1152), device=cuda)
        w1 = _int8_weight(r, (1152, 4608), cuda)
        w2 = _int8_weight(r, (4608, 1152), cuda)
        vec = torch.zeros(1152, device=cuda)
        ffn_int8.ffn_block_int8(wide, *w1, *w2, vec, vec, 1e-12)


@pytest.mark.parametrize("fuse_o", [False, True])
@pytest.mark.parametrize("dtype,M", [(torch.float32, 1000), (torch.bfloat16, 4096)])
def test_ffn_blocks_two_pass_at_bert_base_width(cuda, fuse_o, dtype, M):
    """At D 768, F 3,072 B3 and B8 run their two passes over W1 (B3 on 64-row
    tiles shared by a cluster of two blocks, B8 on 64-row tiles of one) and
    match their plain versions."""
    (x, y), m, lns = _int8_layer(cuda, 5, M, dtype, D=768, F=3072)
    info = ffn_int8.ffn_block_info(768, 3072, o_proj=fuse_o, M=M)
    assert info["rows"] == 64 and info["cluster"] == (1 if fuse_o else 2)
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


# B8 on s8 wgmma (csrc/int8_hopper.cuh): one row, a ragged and a whole
# 64-row tile, the banking and hallucination chunks at the zoo's widths,
# bert-base's and bert-large's widths, D 384 (a chunk pair whose second
# 128-column chunk is past D), and D 128 and 256 (q(f)'s ring at its
# two-slot floor; ac-tiny's width), f32 and bf16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(1, 512, 2048), (63, 512, 2048), (64, 512, 2048),
                                   (8192, 512, 2048), (32768, 512, 2048),
                                   (4096, 768, 3072), (2048 + 5, 1024, 4096),
                                   (333, 384, 1152), (1000, 128, 512),
                                   (333, 256, 1024)])
def test_attn_ffn_wgmma_cases(cuda, dtype, M, D, F):
    (ctx, x), m, lns = _int8_layer(cuda, 12, M, dtype, D=D, F=F)
    args = (ctx, x, *m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.attn_ffn_block_int8(*args)
    want = ffn_int8.attn_ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["attn_ffn_int8"] == 1
    assert ffn_int8.ffn_block_info(D, F, o_proj=True)["warpgroups"] == 4
    assert got.shape == (M, D) and got.dtype == dtype
    _assert_int8_close(got, want, dtype)


# B3 on s8 wgmma (csrc/ffn_block_int8.cu): one row, a tile less one, a
# whole tile and one more (M 1, 63, 64, 65), a ragged banking chunk, the
# widths B3 takes in one block (D 128, where a q(f) ring of one slot would
# never refill; D 256, 384) and in a cluster of two (bert-base, D 640 with its
# uneven warpgroups, bert-large), f32 and bf16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(1, 512, 2048), (63, 512, 2048), (64, 512, 2048),
                                   (65, 512, 2048), (8192 + 37, 512, 2048),
                                   (4096, 768, 3072), (2048 + 5, 1024, 4096),
                                   (333, 384, 1152), (1000, 128, 512), (1, 256, 1024),
                                   (333, 640, 2560)])
def test_ffn_block_on_the_wgmma_body(cuda, dtype, M, D, F):
    (h, _), m, lns = _int8_layer(cuda, 14, M, dtype, D=D, F=F)
    args = (h, *m["w1"], *m["w2"], *lns[0], 1e-12)
    port.reset_launch_counts()
    got = ffn_int8.ffn_block_int8(*args)
    want = ffn_int8.ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["ffn_int8"] == 1
    assert got.shape == (M, D) and got.dtype == dtype
    _assert_int8_close(got, want, dtype)


def _nan_past_m(dev, M, D, dtype, seed):
    """Rows [M, D] that are a view of a buffer whose row M holds NaN."""
    r = np.random.default_rng(seed)
    big = torch.from_numpy((r.standard_normal((M + 1, D)) * 0.5).astype(np.float32)).to(dev, dtype)
    big[M] = float("nan")
    return big[:M]


@pytest.mark.parametrize("M", [63, 8192 + 37])
def test_int8_kernels_read_no_row_past_m(cuda, M):
    """Batch row M of the buffer under the rows holds NaN: B2 and B3 read
    their rows below M only (no TMA box or vector load reaches it), so their
    outputs are finite and equal the plain versions' on rows < M (B2 bit for
    bit)."""
    (_, _), m, lns = _int8_layer(cuda, 15, 64, torch.bfloat16)
    x = _nan_past_m(cuda, M, 512, torch.bfloat16, 16)
    got = matmul_int8.quant_matmul_int8(x, *m["qkv"])
    want = matmul_int8.quant_matmul_int8_ref(x, *m["qkv"])
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and torch.equal(got, want)
    args = (x, *m["w1"], *m["w2"], *lns[0], 1e-12)
    got = ffn_int8.ffn_block_int8(*args)
    want = ffn_int8.ffn_block_int8_ref(*args)
    torch.cuda.synchronize()
    _assert_int8_close(got, want, torch.bfloat16)


def test_quant_matmul_and_ffn_block_first_call_in_a_new_thread(cuda):
    """B2's and B3's first launches from a host thread that has made no CUDA
    call yet: the output and activation tensor maps are encoded there (the
    weights' maps were made in the main thread and are reused)."""
    import threading

    (x, _), m, lns = _int8_layer(cuda, 17, 4096, torch.bfloat16)
    b3 = (x, *m["w1"], *m["w2"], *lns[0], 1e-12)
    want2 = matmul_int8.quant_matmul_int8(x, *m["qkv"]).clone()
    want3 = ffn_int8.ffn_block_int8(*b3).clone()
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(matmul_int8.quant_matmul_int8(x, *m["qkv"]))
            got.append(ffn_int8.ffn_block_int8(*b3))
        except Exception as e:   # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got[0], want2) and torch.equal(got[1], want3)


def test_int8_weight_maps_are_made_once_per_weight(cuda):
    """A weight's TMA map is made on its first B2 or B3 launch and kept beside
    its K-contiguous copy: a second launch makes none; a new weight of the
    same shape at another address gets its own, and the kernels read it."""
    (x, _), m, lns = _int8_layer(cuda, 18, 1000, torch.bfloat16)
    b3 = lambda w1, w2: (x, *w1, *w2, *lns[0], 1e-12)
    matmul_int8.quant_matmul_int8(x, *m["qkv"])
    ffn_int8.ffn_block_int8(*b3(m["w1"], m["w2"]))
    before = ffn_int8.weight_maps_made
    for _ in range(2):
        matmul_int8.quant_matmul_int8(x, *m["qkv"])
        ffn_int8.ffn_block_int8(*b3(m["w1"], m["w2"]))
    assert ffn_int8.weight_maps_made == before
    qkv = (m["qkv"][0].flip(0).contiguous(),) + m["qkv"][1:]
    w1 = (m["w1"][0].flip(1).contiguous(),) + m["w1"][1:]
    assert qkv[0].data_ptr() != m["qkv"][0].data_ptr()
    got2 = matmul_int8.quant_matmul_int8(x, *qkv)
    got3 = ffn_int8.ffn_block_int8(*b3(w1, m["w2"]))
    torch.cuda.synchronize()
    assert ffn_int8.weight_maps_made == before + 2
    assert torch.equal(got2, matmul_int8.quant_matmul_int8_ref(x, *qkv))
    _assert_int8_close(got3, ffn_int8.ffn_block_int8_ref(*b3(w1, m["w2"])), torch.bfloat16)


def test_attn_ffn_first_call_in_a_new_thread(cuda):
    """B8's first launch from a host thread that has made no CUDA call yet,
    its output and scratch served from the allocator's cache: the tensor
    maps' encoder needs the device's context bound to that thread."""
    import threading

    (ctx, x), m, lns = _int8_layer(cuda, 13, 4096, torch.bfloat16)
    args = (ctx, x, *m["o"], *lns[0], *m["w1"], *m["w2"], *lns[1], 1e-12)
    want = ffn_int8.attn_ffn_block_int8(*args).clone()
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(ffn_int8.attn_ffn_block_int8(*args))
        except Exception as e:   # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)


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


#: B3's local memory per thread (bytes) as ptxas reports it for this design
#: (sm_90a, one instantiation a width): at 96 registers a thread the tile
#: loop's state is reloaded once a tile, and from D 768 the W2 epilogue's
#: loads spill beside its sums (PERF.md: zero is the aim not yet met)
_B3_LOCAL_BYTES = {512: 48, 768: 192, 1024: 336}


def test_ffn_block_instantiation(cuda):
    """B3 runs s8 wgmma on 64-row tiles: a producer warpgroup and four
    consumer warpgroups (640 threads), one block an SM, unspilled at the main
    path's widths, in the shared memory of its layout (q(h) [64, D], the
    weight ring, the row scales, the exchanges and the barriers); a tile to
    a cluster of two blocks from D 512, and a persistent grid that fills the
    card at the banking, hallucination and bert-base chunks; no more local
    memory than measured for this design."""
    props = torch.cuda.get_device_properties(cuda)
    sms = props.multi_processor_count
    for M, D, F in ((8192, 512, 2048), (32768, 512, 2048), (4096, 768, 3072),
                    (2048, 1024, 4096), (1000, 128, 512)):
        info = ffn_int8.ffn_block_info(D, F, M=M)
        assert info["rows"] == 64 and info["threads"] == 640 and info["warpgroups"] == 4
        assert info["blocks_per_sm"] == 1
        assert info["cluster"] == (2 if D >= 512 else 1)
        assert info["shared_bytes"] <= props.shared_memory_per_block_optin
        tiles = -(-M // 64)
        assert info["blocks"] >= min(tiles * info["cluster"], sms - 1)
        if D in _B3_LOCAL_BYTES:
            assert info["local_bytes"] <= _B3_LOCAL_BYTES[D]


def test_post_attention_body_and_qkv_instantiation(cuda):
    """B8 runs the wgmma kernel of csrc/int8_hopper.cuh at every width: 64
    rows a tile, a producer warpgroup and four consumer warpgroups (640
    threads), unspilled, one block an SM, in the shared memory of its
    layout (q(h) [64, D], at least two 64 x 128-byte boxes of q(f), a ring
    of 16 weight boxes of 64 x 128 bytes, the row scales, the exchange
    buffers and the barriers, from a 1024-byte boundary), whatever F; B2
    runs s8 wgmma (a producer warp and two consumer warpgroups, 288
    threads), two blocks an SM, unspilled, on a grid of 64-row units that
    gives every SM work at every main-path shape."""
    props = torch.cuda.get_device_properties(cuda)
    for D, F in ((512, 2048), (768, 3072), (1024, 4096), (128, 512)):
        b8 = ffn_int8.ffn_block_info(D, F, o_proj=True)
        assert b8["rows"] == 64 and b8["threads"] == 640 and b8["warpgroups"] == 4
        assert b8["cluster"] == 1
        assert b8["blocks_per_sm"] == 1 and b8["local_bytes"] == 0
        assert b8["shared_bytes"] == (max(64 * D, 2 * 64 * 128) + 16 * 64 * 128 + 64 * 4 + 2 * 4 * 64 * 4
                                      + 8 * (2 * 16 + 2 * 8 + 1) + 1024)
        assert b8["shared_bytes"] <= props.shared_memory_per_block_optin
    for M, D in ((8192, 512), (32768, 512), (4096, 768)):
        b2 = matmul_int8.quant_matmul_info(M, D, 3 * D)
        assert b2["threads"] == 288 and b2["rows"] == 64
        assert b2["blocks_per_sm"] >= 2
        assert b2["blocks"] >= props.multi_processor_count
        assert b2["blocks"] * b2["columns"] >= -(-M // 64) * 3 * D
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


# B6 on the wgmma kernel's flash form: the first row past the tile loop (S
# 65), one and two query tiles (128, 136), K and V kept in the ring for a
# (b, h)'s query tiles (512 at Dh <= 64) or streamed per query tile (1,024,
# 2,048, and Dh 128 past 256), at Dh 32 (zero-padded to 64), 64 and 128 (two
# swizzle atoms); batch row 1 fully masked
@pytest.mark.parametrize("S", [65, 128, 136, 512, 1024, 2048])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_flash_wgmma_edges(cuda, S, Dh):
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    B, H = (3, 4) if S <= 512 else (2, 2)
    (q, k, v), mask = _heads(cuda, 80 + S + Dh, torch.bfloat16, B, S, H, Dh, masked_row=1)
    port.reset_launch_counts()
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_attention"] == 1
    assert fa.kernel_info(q, k, v, False)["wgmma_form"] == "flash"
    assert got.shape == (B, S, H, Dh) and got.dtype == torch.bfloat16
    _assert_attention_close(got, want, torch.bfloat16)
    # a fully masked row is the uniform average of V over exactly S keys
    uniform = v[1].float().mean(dim=0)
    torch.testing.assert_close(got[1].float(), uniform.expand(S, -1, -1), atol=0.05, rtol=0)


def test_flash_wgmma_fully_masked_row_at_1024(cuda):
    """At the policy's first flash length every query of a fully masked
    batch row averages V over its 1,024 keys, streamed tile by tile."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), mask = _heads(cuda, 90, torch.bfloat16, 3, 1024, 4, 64, masked_row=2)
    got = fa.flash_attention(q, k, v, mask).float()
    torch.cuda.synchronize()
    uniform = v[2].float().mean(dim=0)
    torch.testing.assert_close(got[2], uniform.expand(1024, -1, -1), atol=0.05, rtol=0)
    _assert_attention_close(got, fa.flash_attention_ref(q, k, v, mask), torch.bfloat16)


@pytest.mark.parametrize("S", [128, 512, 1024])
def test_flash_kernel_never_reads_the_next_batch_row(cuda, S):
    """B6's tensor maps see q, k, v as [B, S, H, Dh]: a box clips at its own
    batch row's S, so NaN in batch row 1 leaves rows 0 and 2 as the plain
    version computes them."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    qkv, mask = _inputs(cuda, 95 + S, torch.bfloat16, 3, S, 4, 64)
    qkv[1] = float("nan")
    q, k, v = _packed_views(qkv, 4, 64)
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    for b in (0, 2):
        _assert_attention_close(got[b], want[b], torch.bfloat16)


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
    """At the hallucination chunk's S 128 (bf16, Dh 64) B6 and B7 run the
    wgmma kernel of csrc/attention_hopper.cuh: a producer warpgroup and two
    consumer warpgroups (384 threads) fed by TMA, unspilled, two Q buffers
    of 128 rows and a ring of 16 K/V tiles in 165 KB, one persistent block
    an SM; B6 in its flash form (the online recurrence), B7 in its rows
    form.  At the banking chunk's S 32 both run the tile loop of
    csrc/attention_tile.cuh: 2 warps and one 32-key tile, unspilled, at
    least four blocks an SM."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    (q, k, v), _ = _heads(cuda, 12, torch.bfloat16, 2, 128, 8, 64)
    info = fa.kernel_info(q, k, v, oneshot)
    assert info["threads"] == 384 and info["warpgroups"] == 2
    assert info["wgmma_form"] == ("rows" if oneshot else "flash") and info["tma"]
    assert info["shared_bytes"] == (2 * 128 * 64 * 2 + 16 * (64 * 64 * 2 + 64 * 4)
                                    + 8 * (4 + 2 * 16) + 1024)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 1
    (q, k, v), _ = _heads(cuda, 12, torch.bfloat16, 2, 32, 8, 64)
    short = fa.kernel_info(q, k, v, oneshot)
    assert short["threads"] == 64 and short["warpgroups"] == 0
    assert short["wgmma_form"] == "none" and not short["tma"]
    assert short["shared_bytes"] == 2 * (32 + 2 * 32) * 72 + 4 * 32
    assert short["local_bytes"] == 0 and short["blocks_per_sm"] >= 4


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
             (torch.bfloat16, 64, 128),
             # ELECTRA-small's D 256 and DeBERTa-v3-xsmall's D 384
             (torch.bfloat16, 8192, 256), (torch.bfloat16, 8192, 384),
             (torch.float32, 1000, 384)]


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


@pytest.mark.parametrize("name,kernels", [
    ("distilbert-base-uncased", {"attention_qkv": 6, "add_layer_norm": 12}),
    ("answerdotai/ModernBERT-base", {"attention_qkv": 0, "add_layer_norm": 0}),
])
def test_family_forward_on_the_gpu_matches_the_cpu(cuda, monkeypatch, name, kernels):
    """An offline family encoder's bf16 forward on the card (DistilBERT
    through B1 and B10, ModernBERT in plain torch) against the port's
    float32 forward of the same weights on the CPU: every embedding within
    cosine 0.99 (bf16 against f32), the kernels launched once per layer
    (B1) and twice (B10), or never."""
    from adaptive_classifier_tpu_torch.models.encoder import Encoder

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    enc = Encoder(name, device="cuda")
    ref = Encoder(name, device="cpu", compute_dtype="float32")
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for rows in data["test"].values() for t in rows][:16]
    ids, mask = enc.tokenizer(texts, max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    port.reset_launch_counts()
    got = enc.embed_ids(ids, mask)
    torch.cuda.synchronize()
    assert {k: port.launch_counts[k] for k in kernels} == kernels
    want = ref.embed_ids(ids, mask)
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want, dim=1)
    assert cos.min().item() >= 0.99, cos


def _bert_checkpoint(directory: Path, hidden: int, heads: int, layers: int,
                     ffn: int, seed: int = 0) -> Path:
    """A BERT checkpoint written at run time: HF ``config.json`` and
    ``model.safetensors`` under HF tensor names, weights normal(0.02) from
    ``seed`` with numpy, unit LayerNorms, mean pooling, and
    ``checkpoints/ac-base-v2``'s vocabulary."""
    from adaptive_classifier_tpu_torch import io_safetensors

    vocab = (REPO / "checkpoints/ac-base-v2/vocab.txt").read_text(encoding="utf-8")
    V = len(vocab.splitlines())
    r = np.random.default_rng(seed)

    def nrm(*shape):
        return r.standard_normal(shape, np.float32) * 0.02

    D = hidden
    t = {"embeddings.word_embeddings.weight": nrm(V, D),
         "embeddings.position_embeddings.weight": nrm(512, D),
         "embeddings.token_type_embeddings.weight": nrm(2, D),
         "embeddings.LayerNorm.weight": np.ones(D, np.float32),
         "embeddings.LayerNorm.bias": np.zeros(D, np.float32)}
    for i in range(layers):
        pre = f"encoder.layer.{i}."
        for name, (n_out, n_in) in (("attention.self.query", (D, D)),
                                    ("attention.self.key", (D, D)),
                                    ("attention.self.value", (D, D)),
                                    ("attention.output.dense", (D, D)),
                                    ("intermediate.dense", (ffn, D)),
                                    ("output.dense", (D, ffn))):
            t[pre + name + ".weight"] = nrm(n_out, n_in)
            t[pre + name + ".bias"] = nrm(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[pre + name + ".weight"] = np.ones(D, np.float32)
            t[pre + name + ".bias"] = np.zeros(D, np.float32)
    cfg = {"model_type": "bert", "architectures": ["BertModel"], "vocab_size": V,
           "hidden_size": D, "num_hidden_layers": layers, "num_attention_heads": heads,
           "intermediate_size": ffn, "max_position_embeddings": 512,
           "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
           "hidden_act": "gelu", "ac_pooling": "mean"}
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(cfg, indent=2))
    (directory / "vocab.txt").write_text(vocab, encoding="utf-8")
    io_safetensors.save_file(t, directory / "model.safetensors")
    return directory


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_outside_the_kernel_envelope_on_the_gpu(cuda, tmp_path, monkeypatch, dtype):
    """A BERT checkpoint of hidden 312 and 12 heads (head_dim 26, the
    TinyBERT-4L-312 shape) runs on the card through the plain attention
    (B1 never launched, B10 twice per layer): every embedding
    within cosine 0.999 of the port's float32 forward on the CPU."""
    from adaptive_classifier_tpu_torch.models.encoder import _FUSED_LN_ON_CUDA, Encoder

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    path = str(_bert_checkpoint(tmp_path / "tinybert-312", 312, 12, 4, 1200))
    enc = Encoder(path, device="cuda", compute_dtype=dtype)
    ref = Encoder(path, device="cpu", compute_dtype="float32")
    assert enc.config.head_dim == 26 and enc._attn_impl(32) == "einsum"
    data = json.loads((REPO / "data/intents.json").read_text())
    texts = [t for rows in data["test"].values() for t in rows][:32]
    ids, mask = enc.tokenizer(texts, max_length=512, pad_to_buckets=enc.SEQ_BUCKETS)
    port.reset_launch_counts()
    got = enc.embed_ids(ids, mask)
    torch.cuda.synchronize()
    assert port.launch_counts["attention_qkv"] == 0
    assert port.launch_counts["add_layer_norm"] == (2 * 4 if _FUSED_LN_ON_CUDA else 0)
    want = ref.embed_ids(ids, mask)
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want, dim=1)
    assert cos.min().item() >= 0.999, cos


def test_strategic_mode_on_the_gpu_matches_the_cpu(cuda, monkeypatch):
    """A strategic ridge classifier (ac-base-v2, float32, lexical channel
    off) built on the card and on the CPU from the intents train rows: the
    same best-response rounds in each add, and the strategic, robust and
    dual top-1 labels of the test rows agree on >= 0.99 of them; B1 and B10
    launched by the strategic predictions."""
    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, lbl) for lbl, ts in data["train"].items() for t in ts]
    tests = [t for lbl in data["train"] for t in data["test"][lbl]]
    config = {"head_type": "ridge", "ridge_lambda": 1.0, "compute_dtype": "float32",
              "enable_strategic_mode": True, "cost_function_type": "linear",
              "cost_coefficients": [0.15] * 512}
    answers, rounds = {}, {}
    for dev in ("cuda", "cpu"):
        clf = port.AdaptiveClassifier(str(REPO / "checkpoints/ac-base-v2"), device=dev,
                                      config=dict(config))
        calls, inner = [], clf.strategic_cost_function.compute_best_response_chunked
        clf.strategic_cost_function.compute_best_response_chunked = \
            lambda x, f, *a, **k: calls.append(1) or inner(x, f, *a, **k)
        half = len(rows) // 2
        for part in (rows[:half], rows[half:]):
            clf.add_examples([t for t, _ in part], [lbl for _, lbl in part])
        rounds[dev] = len(calls)
        clf._clear_embedding_caches()
        port.reset_launch_counts()
        answers[dev] = {m: [p[0][0] for p in getattr(clf, m)(tests, 1)]
                        for m in ("predict_strategic_batch", "predict_robust_batch",
                                  "_predict_dual_batch")}
        if dev == "cuda":
            torch.cuda.synchronize()
            assert port.launch_counts["attention_qkv"] > 0
            assert port.launch_counts["add_layer_norm"] > 0
    assert rounds["cuda"] == rounds["cpu"]
    for m, got in answers["cuda"].items():
        assert np.mean([a == b for a, b in zip(got, answers["cpu"][m])]) >= 0.99, m


def test_kernels_refuse_autograd_on_the_gpu(cuda):
    """B1, B6, B7 and B10 raise where autograd would record their launch
    (they have no backward); under ``torch.no_grad`` they launch."""
    from adaptive_classifier_tpu_torch.ops.flash_attention import (
        flash_attention,
        oneshot_attention,
    )
    from adaptive_classifier_tpu_torch.ops.layernorm import add_layer_norm

    qkv, mask = _inputs(cuda, 3, torch.bfloat16, 2, 32, 4, 64)
    qkv.requires_grad_(True)
    q, k, v = (qkv.detach()[..., j * 256:(j + 1) * 256].unflatten(-1, (4, 64))
               .requires_grad_(True) for j in range(3))
    x = torch.randn(64, 512, device=cuda, requires_grad=True)
    r, scale, bias = torch.randn_like(x), torch.ones(512, device=cuda), torch.zeros(512, device=cuda)
    calls = [lambda: attention_from_qkv(qkv, mask, 4, 64),
             lambda: flash_attention(q, k, v, mask), lambda: oneshot_attention(q, k, v, mask),
             lambda: add_layer_norm(x, r, scale, bias, 1e-12)]
    port.reset_launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert sum(port.launch_counts.values()) == 0
    with torch.no_grad():
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert all(port.launch_counts[n] == 1 for n in (
        "attention_qkv", "flash_attention", "oneshot_attention", "add_layer_norm"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supcon_step_on_the_gpu_matches_the_cpu(cuda, dtype):
    """One SupCon step's loss and gradients (ac-base-v2, the same two views) on
    the card and on the CPU: loss within 1e-3 relative, each gradient
    tensor within cosine 0.99 (the key bias's, zero in exact arithmetic,
    only small); no kernel launched under autograd."""
    from adaptive_classifier_tpu_torch import finetune, pretrain, training
    from adaptive_classifier_tpu_torch.models.encoder import Encoder, tree_from_params

    enc = Encoder(str(REPO / "checkpoints/ac-base-v2"), device="cpu")
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, i) for i, ts in enumerate(data["train"].values()) for t in ts][:32]
    ids, mask = enc.tokenizer([t for t, _ in rows], max_length=512,
                              pad_to_buckets=enc.SEQ_BUCKETS)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    labels = torch.tensor([i for _, i in rows])
    views = pretrain.two_views(torch.Generator().manual_seed(0), ids, mask, 4,
                               enc.config.vocab_size, 0.08)

    def step(dev):
        def loss_fn(p):
            e = torch.cat([pretrain._mean_pool_embed(p, v.to(dev), mask.to(dev), enc.config,
                                                     compute_dtype=dtype) for v in views])
            y = torch.cat([labels, labels]).to(dev)
            return finetune._supcon(e, y[:, None] == y[None, :], 0.1)

        return training.value_and_grad(loss_fn, enc.master_params() if dev == "cpu" else
                                       {k: v.to(dev) for k, v in enc.master_params().items()})

    want_loss, want = step("cpu")
    port.reset_launch_counts()
    got_loss, got = step("cuda")
    torch.cuda.synchronize()
    assert sum(port.launch_counts.values()) == 0
    assert abs(got_loss.item() - want_loss.item()) <= 1e-3 * abs(want_loss.item())
    got, want = tree_from_params(got), tree_from_params(want)
    total = np.sqrt(sum(np.sum(np.square(a)) for s in ("embeddings", "layers")
                        for a in want[s].values()))
    for section in ("embeddings", "layers"):
        for name, w in want[section].items():
            g = got[section][name]
            if name == "k_b":
                assert max(np.linalg.norm(w), np.linalg.norm(g)) <= 1e-3 * total
                continue
            cos = float((w * g).sum() / (np.linalg.norm(w) * np.linalg.norm(g)))
            assert cos >= 0.99, (section, name, cos)


def test_finetune_encoder_on_the_gpu(cuda, tmp_path, monkeypatch):
    """finetune_encoder on the card (ac-base-v2, the ridge head without
    the lexical channel): finite losses, no B1 or B10 launch inside the
    chunks, both after them (re-embedding); save writes encoder/ and the
    load on the CPU embeds within cosine 0.999."""
    from adaptive_classifier_tpu_torch import finetune

    monkeypatch.delenv("AC_ATTN_IMPL", raising=False)
    data = json.loads((REPO / "data/intents.json").read_text())
    rows = [(t, lbl) for lbl, ts in data["train"].items() for t in ts]
    clf = port.AdaptiveClassifier(str(REPO / "checkpoints/ac-base-v2"), device="cuda",
                                  config={"head_type": "ridge", "ridge_lambda": 1.0})
    clf.add_examples([t for t, _ in rows], [lbl for _, lbl in rows])
    inside, real = [], finetune.supcon_chunk

    def counted(*a, **k):
        port.reset_launch_counts()
        out = real(*a, **k)
        torch.cuda.synchronize()
        inside.append(dict(port.launch_counts))
        port.reset_launch_counts()
        return out

    monkeypatch.setattr(finetune, "supcon_chunk", counted)
    rep = clf.finetune_encoder(steps=6, chunk_steps=3, batch=16, lr=1e-4)
    torch.cuda.synchronize()
    assert len(inside) == 2 and all(sum(c.values()) == 0 for c in inside)
    assert port.launch_counts["attention_qkv"] > 0 and port.launch_counts["add_layer_norm"] > 0
    assert all(np.isfinite(rep["chunk_losses"]))
    clf.save(tmp_path / "ck")
    assert (tmp_path / "ck" / "encoder" / "model.safetensors").exists()
    cpu = port.AdaptiveClassifier.load(tmp_path / "ck", device="cpu")
    texts = [t for t, _ in rows[:16]]
    a, b = clf._embed_uncached(texts), cpu._embed_uncached(texts)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() >= 0.999, cos.min()


def test_product_backward_on_the_gpu_is_the_f32_products(cuda):
    """The training forward's product on the card (bf16 operands,
    ``torch.mm(..., out_dtype=float32)``) and its backward (``_ProductF32``,
    f32 products): the forward equal to the CPU's upcast product to f32
    summation, the bf16 gradients equal to the CPU's on >= 0.99 of the
    entries and, on all, within one bf16 step plus the f32 sums' own
    difference (1e-5 of the sum of the terms' magnitudes), at a training
    step's shapes (64 x 32 tokens, D 512, F 2,048)."""
    from adaptive_classifier_tpu_torch.models.encoder import _product_f32

    g = torch.Generator().manual_seed(0)
    for K, N in ((512, 1536), (2048, 512)):
        x = torch.randn(2048, K, generator=g).bfloat16()
        w = (torch.randn(K, N, generator=g) / K ** 0.5).bfloat16()
        cot = torch.randn(2048, N, generator=g)
        grads = {}
        for dev in ("cuda", "cpu"):
            xs, ws = (t.to(dev).requires_grad_(True) for t in (x, w))
            out = _product_f32(xs, ws)
            out.backward(cot.to(dev))
            grads[dev] = (out.detach().cpu(), xs.grad.cpu(), ws.grad.cpu())
        torch.testing.assert_close(grads["cuda"][0], grads["cpu"][0], rtol=1e-5, atol=1e-4)
        scales = (cot.abs() @ w.float().abs().t(), x.float().abs().t() @ cot.abs())
        for got, want, scale in zip(grads["cuda"][1:], grads["cpu"][1:], scales):
            assert got.dtype == torch.bfloat16
            bound = want.float().abs() * 2.0 ** -7 + 1e-5 * scale
            assert ((got.float() - want.float()).abs() <= bound).all()
            assert (got == want).float().mean() >= 0.99
