"""The port's MLP head against the JAX package's (CPU): init bounds and
shapes, the eval-mode forward, the train-mode forward with the JAX
package's own dropout masks handed in, capacity growth, the skip probe,
masked probabilities, and the reference state dict both ways.  Single ops
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu.models import head as jhead
from adaptive_classifier_tpu_torch import convert
from adaptive_classifier_tpu_torch.models import head as thead

D, CAP, N_CLASSES = 24, 16, 5


def _jax_head(seed=0, hidden=(24, 12), skip=False):
    p = jhead.init_head(jax.random.PRNGKey(seed), D, CAP, N_CLASSES, hidden_dims=list(hidden))
    if skip:
        r = np.random.default_rng(seed)
        p = {**p, "skip": {"w": jnp.asarray(0.2 * r.standard_normal((D, CAP)).astype(np.float32))}}
    return p


def _x(seed, n=6):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("hidden", [None, [], [24, 12], [7]])
def test_init_bounds_and_shapes(hidden):
    g = torch.Generator().manual_seed(3)
    tp = thead.init_head(D, CAP, N_CLASSES, hidden_dims=hidden, generator=g)
    jp = jhead.init_head(jax.random.PRNGKey(0), D, CAP, N_CLASSES, hidden_dims=hidden)
    assert len(tp["hidden"]) == len(jp["hidden"])
    fan_in = D
    for tl, jl in zip(tp["hidden"], jp["hidden"]):
        assert tuple(tl["w"].shape) == jl["w"].shape and tuple(tl["b"].shape) == jl["b"].shape
        bound = np.sqrt(6.0 / fan_in)
        assert tl["w"].abs().max() <= bound and tl["w"].abs().max() > 0.8 * bound
        assert not tl["b"].any()
        fan_in = tl["w"].shape[1]
    bound = np.sqrt(6.0 / (fan_in + N_CLASSES))
    assert tuple(tp["out"]["w"].shape) == jp["out"]["w"].shape == (fan_in, CAP)
    assert tp["out"]["w"].abs().max() <= bound and tp["out"]["w"].abs().max() > 0.8 * bound
    assert not tp["out"]["b"].any()
    again = thead.init_head(D, CAP, N_CLASSES, hidden_dims=hidden,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(again["out"]["w"], tp["out"]["w"])


@pytest.mark.parametrize("skip", [False, True])
def test_head_forward_eval_matches_jax(skip):
    jp = _jax_head(1, skip=skip)
    x = _x(2)
    got = thead.head_forward(convert.head_params_from_jax(jp), torch.from_numpy(x))
    _close(got, jhead.head_forward(jp, jnp.asarray(x), train=False))
    # train mode without a draw is eval mode, in both packages
    _close(thead.head_forward(convert.head_params_from_jax(jp), torch.from_numpy(x), train=True),
           jhead.head_forward(jp, jnp.asarray(x), train=True))


def jax_keep_masks(key, batch, widths):
    """The masks JAX head_forward draws from ``dropout_rng=key``
    (``models/head.py:86-90``)."""
    masks = []
    for w in widths:
        key, sub = jax.random.split(key)
        masks.append(np.array(jax.random.bernoulli(sub, 1.0 - jhead.DROPOUT_RATE, (batch, w))))
    return masks


def test_head_forward_train_with_jax_keep_masks():
    jp = _jax_head(4, hidden=(24, 12), skip=True)
    x = _x(5, n=32)
    key = jax.random.PRNGKey(9)
    keep = jax_keep_masks(key, 32, [24, 12])
    assert 0.8 < np.mean(keep[0]) < 0.97
    want = jhead.head_forward(jp, jnp.asarray(x), dropout_rng=key, train=True)
    got = thead.head_forward(convert.head_params_from_jax(jp), torch.from_numpy(x), train=True,
                             keep=[torch.from_numpy(k) for k in keep])
    _close(got, want)
    # the port's own draw keeps ~90% of the units
    g = torch.Generator().manual_seed(0)
    assert thead._keep_mask(g, (400, 24)).float().mean().item() == pytest.approx(0.9, abs=0.02)


def test_grow_capacity_keeps_columns_and_pads_skip():
    jp = _jax_head(6, skip=True)
    tp = convert.head_params_from_jax(jp)
    g = torch.Generator().manual_seed(1)
    grown = thead.grow_capacity(tp, 32, g, num_classes=20)
    jgrown = jhead.grow_capacity(jp, 32, jax.random.PRNGKey(0), 20)
    for key in ("w", "b"):
        assert tuple(grown["out"][key].shape) == jgrown["out"][key].shape
        assert torch.equal(grown["out"][key][..., :CAP], tp["out"][key])
    assert not grown["out"]["b"][CAP:].any()
    bound = np.sqrt(6.0 / (12 + 20))
    fresh = grown["out"]["w"][:, CAP:]
    assert fresh.abs().max() <= bound and fresh.abs().max() > 0.5 * bound
    assert torch.equal(grown["skip"]["w"][:, :CAP], tp["skip"]["w"])
    assert not grown["skip"]["w"][:, CAP:].any()
    assert grown["hidden"] is tp["hidden"]
    assert thead.grow_capacity(grown, 16) is grown


def test_ensure_skip_leaves_the_function_unchanged():
    jp = _jax_head(7)
    tp = convert.head_params_from_jax(jp)
    with_skip = thead.ensure_skip(tp, D)
    assert tuple(with_skip["skip"]["w"].shape) == (D, CAP) and not with_skip["skip"]["w"].any()
    assert thead.ensure_skip(with_skip, D) is with_skip
    x = torch.from_numpy(_x(8))
    assert torch.equal(thead.head_forward(with_skip, x), thead.head_forward(tp, x))
    _close(with_skip["skip"]["w"], jhead.ensure_skip(jp, D)["skip"]["w"])


def test_masked_probs_matches_jax():
    logits = _x(10)[:, :CAP] * 3
    active = np.arange(CAP) < N_CLASSES
    got = thead.masked_probs(torch.from_numpy(logits), torch.from_numpy(active))
    _close(got, jhead.masked_probs(jnp.asarray(logits), jnp.asarray(active)))
    assert not got[:, N_CLASSES:].any()


@pytest.mark.parametrize("skip", [None, "zero", "nonzero"])
def test_state_dicts_both_ways(skip):
    jp = _jax_head(11, hidden=(24, 12), skip=skip == "nonzero")
    if skip == "zero":
        jp = jhead.ensure_skip(jp, D)
    tp = convert.head_params_from_jax(jp)
    want = jhead.to_torch_state_dict(jp, N_CLASSES)
    got = thead.to_torch_state_dict(tp, N_CLASSES)
    assert sorted(got) == sorted(want)
    assert ("skip.weight" in got) == (skip == "nonzero")
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    tback, tdims = thead.from_torch_state_dict(want, CAP)
    jback, jdims = jhead.from_torch_state_dict(want, CAP)
    assert tdims == jdims == [24, 12]
    want_leaves = jax.tree.leaves(jback)
    from adaptive_classifier_tpu_torch.training import tree_leaves

    got_leaves = tree_leaves(tback)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_head_params_from_jax_with_hidden_layers():
    jp = _jax_head(12, hidden=(24, 12, 6), skip=True)
    tp = convert.head_params_from_jax(jp)
    assert len(tp["hidden"]) == 3 and "skip" in tp
    for tl, jl in zip(tp["hidden"], jp["hidden"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    x = _x(13)
    _close(thead.head_forward(tp, torch.from_numpy(x)), jhead.head_forward(jp, jnp.asarray(x)))
