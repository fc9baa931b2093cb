"""Plain versions of kernels B4 (masked kNN similarities) and B5 (streaming
top-k) against the JAX package's Pallas kernels, run in interpret mode on
the CPU as the JAX package's own tests run them; and the dispatchers around
them.  float32 throughout; tolerance 1e-5 (sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adaptive_classifier_tpu.ops import knn as jknn
from adaptive_classifier_tpu.ops import knn_topk as jknn_topk
from adaptive_classifier_tpu_torch.ops import knn, knn_topk


def unit(r, shape):
    x = r.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def scene(seed, B, C, D, valid="mixed", ties=False, bias=False, near=False):
    """``near``: each query a near duplicate of a random prototype, ``p_c +
    1e-3·noise`` renormalised (d² ~ 1e-6: an error in d² reaches the output
    one for one)."""
    r = np.random.default_rng(seed)
    q, p = unit(r, (B, D)), unit(r, (C, D))
    if near:
        q = p[r.integers(0, C, B)] + 1e-3 * q
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    if ties:
        p[7] = p[2]
        p[C - 1] = p[2]
        q[0] = p[2]
    v = {"all": np.ones(C, bool), "none": np.zeros(C, bool),
         "mixed": r.random(C) < 0.6, "few": np.arange(C) < 3}[valid]
    b = (-0.2 * r.random(C)).astype(np.float32) if bias else None
    return q, p, v, b


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,C,D,kind", [
    (10, 300, 40, "mixed"),
    (128, 128, 128, "all"),
    (7, 513, 33, "none"),
    (3, 1000, 200, "mixed"),
    (32, 300, 512, "near-duplicate"),
])
def test_masked_sims_plain_matches_pallas(B, C, D, kind):
    near = kind == "near-duplicate"
    q, p, v, _ = scene(0, B, C, D, "all" if near else kind, near=near)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jknn.masked_sims(jnp.asarray(q), jnp.asarray(p),
                                           jnp.asarray(v), use_pallas=True))
    got = knn.masked_sims(t(q), t(p), t(v), pallas_min_classes=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if near:
        assert want.max() > 0.999          # the near duplicates are there


# B4's split of the contraction on an H100 (132 SMs), for the instantiation
# ``knn.sims_info`` reports there (128 x 128 output tiles, 32-column slices,
# one block an SM): phase 8's chunk and the recalibration fill the card with
# output tiles alone; phase 7's chunk and the production width
# (D 512 + 32,768) split
H100_SIMS_INFO = {"rows": 128, "cols": 128, "slice": 32, "min_slices": 2,
                  "max_splits": 64, "blocks_per_sm": 1}


@pytest.mark.parametrize("B,C,D,want", [
    (256, 16384, 512, 1),
    (2048, 1024, 512, 1),
    (256, 1024, 512, 8),
    (256, 1024, 33280, 8),
    (3, 1000, 33280, 16),
    (5, 600, 40, 1),
    (133, 259, 256, 4),
])
def test_masked_sims_split_choice(B, C, D, want):
    sms, info = 132, H100_SIMS_INFO
    splits, per = knn.sims_splits(B, C, D, info, sms)
    assert splits == want
    tiles = -(-B // info["rows"]) * -(-C // info["cols"])
    slices = -(-D // info["slice"])
    # every split takes at least two slices, none is empty, all are covered
    assert splits * per >= slices and (splits - 1) * per < slices
    assert splits == 1 or per >= info["min_slices"]
    # one wave: the tiles and their splits fit the card, and one more split
    # would not (or would leave a split short of slices)
    assert tiles * splits <= max(sms, tiles)
    if splits > 1:
        assert tiles * (splits + 1) > sms or slices // (splits + 1) < info["min_slices"]
        # at the main path's shapes the wave fills most of the card
        assert tiles * splits > sms // 2 or per == info["min_slices"]


@pytest.mark.parametrize("D", [510, 512, 33, 40])
def test_staged_rows_pad_exactly(D):
    """B4 and B5 stage rows through one helper: D padded to a multiple of 4
    with zero columns (nothing added to a dot product or a norm), the
    values untouched, rows 16-byte aligned; an aligned D % 4 == 0 input is
    returned as it is."""
    r = np.random.default_rng(D)
    x = t(unit(r, (7, D)))
    y = knn.staged(x)
    assert y.shape == (7, D + (-D % 4)) and y.data_ptr() % 16 == 0
    assert torch.equal(y[:, :D], x) and not y[:, D:].any()
    if D % 4 == 0 and x.data_ptr() % 16 == 0:
        assert y is x
    # a view 4 bytes off alignment is copied to aligned memory
    base = torch.zeros(7 * D + 1)
    z = base[1:].view(7, D)
    z.copy_(x)
    assert z.data_ptr() % 16 != 0
    w = knn.staged(z)
    assert w.data_ptr() % 16 == 0 and torch.equal(w[:, :D], x) and not w[:, D:].any()
    assert not hasattr(knn_topk, "_staged")     # one helper for both wrappers


@pytest.mark.parametrize("B,C,k,valid,ties,bias", [
    (16, 640, 5, "all", False, False),
    (9, 1000, 7, "mixed", False, True),
    (4, 300, 12, "few", False, True),
    (5, 256, 4, "none", False, False),
    (6, 512, 3, "all", True, False),
    (3, 1030, 128, "mixed", False, True),
])
def test_topk_plain_matches_pallas(B, C, k, valid, ties, bias):
    q, p, v, b = scene(1, B, C, 32, valid, ties, bias)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(x) for x in jknn_topk.topk_scores_fused(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(v), k, tile_c=256,
            return_raw=True, bias=None if b is None else jnp.asarray(b))]
    got = knn_topk.topk_scores_fused(t(q), t(p), t(v), k, return_raw=True, bias=t(b))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-5, rtol=0)
    assert np.isfinite(got[0].numpy()).all()
    if ties:
        assert got[1][0, :3].tolist() == [2, 7, C - 1]   # lower index first
    if valid == "none":
        assert (got[1] == -1).all() and (got[0] == 0).all()


def test_topk_sims_ref_is_the_materialized_selection():
    q, p, v, b = scene(2, 8, 200, 16, "mixed", bias=True)
    vals, idx = knn_topk.topk_sims_ref(t(q), t(p), t(v), 6, bias=t(b))
    assert idx.dtype == torch.int32 and vals.shape == (8, 6)
    sims = knn.masked_sims_ref(t(q), t(p), t(v)) + t(b)[None, :]
    sims = torch.where(t(v)[None, :], sims, torch.full_like(sims, -1e9))
    want_v, want_i = knn.top_k_lower_index(sims, 6)
    assert torch.equal(idx.long(), want_i)
    assert torch.equal(vals, want_v)


@pytest.mark.parametrize("C,fused_min", [(300, 16384), (300, 100)])
def test_topk_scores_auto_matches_jax(C, fused_min):
    """On the CPU both packages take the materialized path; the port's
    result equals the JAX package's either way."""
    q, p, v, b = scene(3, 6, C, 24, "mixed", bias=True)
    want = [np.asarray(x) for x in jknn_topk.topk_scores_auto(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(v), 5,
        fused_min_classes=fused_min, return_raw=True, bias=jnp.asarray(b))]
    got = knn_topk.topk_scores_auto(t(q), t(p), t(v), 5, fused_min_classes=fused_min,
                                    return_raw=True, bias=t(b))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-6)


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    q, p, v, _ = scene(4, 2, 600, 8, "all")
    # CPU tensors: plain version, no launch counted
    from adaptive_classifier_tpu_torch.ops import launch_counts
    before = dict(launch_counts)
    knn.masked_sims(t(q), t(p), t(v))
    knn_topk.topk_sims(t(q), t(p), t(v), 3)
    assert dict(launch_counts) == before
    with pytest.raises(ValueError, match="CUDA"):
        knn.masked_sims_cuda(t(q), t(p), t(v))
    with pytest.raises(ValueError, match="CUDA"):
        knn_topk.topk_sims_cuda(t(q), t(p), t(v), 3)
    with pytest.raises(ValueError, match="k <= 128"):
        knn_topk.topk_sims(t(q), t(p), t(v), 129)
