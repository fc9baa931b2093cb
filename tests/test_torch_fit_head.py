"""The port's gradient fit against the JAX package's (CPU): one AdamW
step, global-norm clipping, the three losses and the EWC penalty with
their gradients (1e-6), whole ``fit_head`` runs with the JAX package's own
shuffles and dropout masks handed to the port, including the plateau
schedule and the stopping epoch (1e-4), the gradient mask and padding
rows, and ``compute_fisher`` with the JAX package's sampled labels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import ewc as jewc
from adaptive_classifier_tpu import training as jtraining
from adaptive_classifier_tpu.models import head as jhead
from adaptive_classifier_tpu_torch import convert, ewc, training
from adaptive_classifier_tpu_torch.models import head as thead

D, CAP, N_CLASSES, HIDDEN = 16, 8, 5, [16, 8]
BATCH = jtraining.BATCH_SIZE


def data(n=50, n_cap=64, seed=0, n_classes=N_CLASSES):
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((n_classes, D)).astype(np.float32)
    y = np.zeros((n_cap,), np.int32)
    y[:n] = np.arange(n) % n_classes
    emb = np.zeros((n_cap, D), np.float32)
    emb[:n] = centers[y[:n]] + 0.5 * r.standard_normal((n, D)).astype(np.float32)
    valid = np.arange(n_cap) < n
    return emb, y, valid


def jax_head(seed=0, skip=False):
    p = jhead.init_head(jax.random.PRNGKey(seed), D, CAP, N_CLASSES, hidden_dims=HIDDEN)
    return jhead.ensure_skip(p, D) if skip else p


def jax_keep_masks(key, batch, widths):
    masks = []
    for w in widths:
        key, sub = jax.random.split(key)
        masks.append(np.array(jax.random.bernoulli(sub, 1.0 - jhead.DROPOUT_RATE, (batch, w))))
    return masks


def jax_fit_draws(key, valid, widths, max_epochs):
    """The shuffles and dropout masks JAX ``fit_head`` draws from ``key``
    (``training.py:196-214``), in the order the port consumes them."""
    n_batches = max((int(valid.sum()) + BATCH - 1) // BATCH, 1)
    perms, keeps = [], []
    rng = key
    for epoch in range(max_epochs):
        rng, prng, brng = jax.random.split(jax.random.fold_in(rng, epoch), 3)
        u = jax.random.uniform(prng, (len(valid),))
        perms.append(np.array(jnp.argsort(jnp.where(jnp.asarray(valid), u, 2.0 + u))))
        for _ in range(n_batches):
            brng, drng = jax.random.split(brng)
            keeps += jax_keep_masks(drng, BATCH, widths)
    return perms, keeps


@pytest.fixture
def inject(monkeypatch):
    """Hand the port a list of permutations and keep masks to consume."""
    def install(perms, keeps):
        state = {"perms": list(perms), "keeps": list(keeps)}

        def perm(generator, valid):
            return torch.from_numpy(state["perms"].pop(0))

        def keep(generator, shape):
            k = state["keeps"].pop(0)
            assert k.shape == tuple(shape)
            return torch.from_numpy(k)

        monkeypatch.setattr(training, "_epoch_permutation", perm)
        monkeypatch.setattr(thead, "_keep_mask", keep)
        return state
    return install


def t(a):
    return torch.from_numpy(np.array(a))


def assert_trees_close(got, want, atol):
    gl, wl = training.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=0)


def test_tree_leaves_follow_jax_order():
    jp = jax_head(0, skip=True)
    tp = convert.head_params_from_jax(jp)
    for a, b in zip(training.tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adamw_steps_match_jax():
    jp = jax_head(1, skip=True)
    tp = convert.head_params_from_jax(jp)
    r = np.random.default_rng(2)
    jopt, topt = jtraining.adamw_init(jp), training.adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(r.standard_normal(p.shape).astype(np.float32)), jp)
        tg = convert.head_params_from_jax(g)
        jp, jopt = jtraining.adamw_update(jp, g, jopt, 0.01)
        tp, topt = training.adamw_update(tp, tg, topt, 0.01)
        assert topt.step == int(jopt.step) == step + 1
        assert_trees_close(tp, jp, 1e-6)
        assert_trees_close(topt.m, jopt.m, 1e-6)
        assert_trees_close(topt.v, jopt.v, 1e-6)


@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_clip_global_norm_matches_jax(scale):
    r = np.random.default_rng(3)
    g = jax.tree.map(lambda p: jnp.asarray(scale * r.standard_normal(p.shape).astype(np.float32)),
                     jax_head(2))
    assert_trees_close(training.clip_global_norm(convert.head_params_from_jax(g)),
                       jtraining.clip_global_norm(g), 1e-6)


def _grads(loss, params):
    leaves = training.tree_leaves(params)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _with_grad(params):
    return training.tree_map(lambda p: p.clone().requires_grad_(True), params)


@pytest.mark.parametrize("loss", ["ce", "bce", "distill", "ewc"])
def test_losses_and_gradients_match_jax(loss):
    jp = jax_head(3, skip=True)
    emb, y, valid = data(n=27, n_cap=BATCH, seed=4)
    x, v = emb, valid.astype(np.float32)
    active = np.arange(CAP) < N_CLASSES
    drng = jax.random.PRNGKey(5)
    keep = [t(k) for k in jax_keep_masks(drng, BATCH, HIDDEN)]
    tp = _with_grad(convert.head_params_from_jax(jp))
    if loss == "ce":
        jfn = lambda p: jtraining._ce_loss(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                                           jnp.asarray(active), drng)
        got = training._ce_loss(thead.head_forward(tp, t(x), train=True, keep=keep),
                                t(y), t(v), t(active))
    elif loss == "bce":
        yh = np.eye(CAP, dtype=np.float32)[y]
        jfn = lambda p: jtraining._bce_loss(p, jnp.asarray(x), jnp.asarray(yh), jnp.asarray(v),
                                            jnp.asarray(active), drng)
        got = training._bce_loss(thead.head_forward(tp, t(x), train=True, keep=keep),
                                 t(yh), t(v), t(active))
    elif loss == "distill":
        old = np.asarray(jhead.head_forward(jax_head(6, skip=True), jnp.asarray(x)))
        old_active = np.arange(CAP) < 3
        jfn = lambda p: jtraining._distill_loss(p, jnp.asarray(x), jnp.asarray(old), jnp.asarray(v),
                                                jnp.asarray(old_active), drng, 2.0)
        got = training._distill_loss(thead.head_forward(tp, t(x), train=True, keep=keep),
                                     t(old), t(v), t(old_active), 2.0)
    else:
        old = jax_head(7, skip=True)
        r = np.random.default_rng(8)
        fisher = jax.tree.map(lambda p: jnp.asarray(r.random(p.shape).astype(np.float32)), old)
        jfn = lambda p: jtraining.ewc_penalty(p, old, fisher, 5.0, jnp.asarray(27.0))
        got = training.ewc_penalty(tp, convert.head_params_from_jax(old),
                                   convert.head_params_from_jax(fisher), 5.0, torch.tensor(27.0))
    want, jgrads = jax.value_and_grad(jfn)(jp)
    assert abs(got.item() - float(want)) <= 1e-6
    for a, b in zip(_grads(got, tp), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def frozen_mask(params_j):
    """Freeze everything but the output and skip columns >= 3."""
    new_rows = (jnp.arange(CAP) >= 3).astype(jnp.float32)
    m = jax.tree.map(jnp.zeros_like, params_j)
    m["out"]["w"] = jnp.broadcast_to(new_rows[None, :], params_j["out"]["w"].shape)
    m["out"]["b"] = new_rows
    m["skip"]["w"] = jnp.broadcast_to(new_rows[None, :], params_j["skip"]["w"].shape)
    return m


FITS = {
    # the MLP head's own fit: CE; on these rows the plateau schedule halves
    # the rate (epoch 7) and early stopping ends the fit (epoch 9 of 14)
    "ce": dict(lr=0.1, loss_type="ce", max_epochs=14, patience=5, use_scheduler=True),
    # new classes on a trained head: EWC + distillation, no schedule
    "incremental": dict(lr=0.01, loss_type="ce", max_epochs=8, patience=3,
                        use_scheduler=False),
    # the frozen probe after a lossy load: BCE, gradient mask
    "frozen": dict(lr=0.01, loss_type="bce", max_epochs=6, patience=10, use_scheduler=False),
}


@pytest.mark.parametrize("kind", list(FITS))
def test_fit_head_matches_jax_with_its_draws(kind, inject):
    kw = FITS[kind]
    emb, y, valid = data(n=70, n_cap=128, seed=10)
    active = np.arange(CAP) < N_CLASSES
    jp = jax_head(11, skip=kind == "frozen")
    key = jax.random.PRNGKey(12)
    jextra, textra = {}, {}
    labels = y
    if kind == "incremental":
        old = jax_head(13)
        old_active = np.arange(CAP) < 3
        fisher = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), old)
        old_logits = np.asarray(jhead.head_forward(old, jnp.asarray(emb)))
        jextra = dict(has_ewc=True, ewc_old=old, ewc_fisher=fisher, ewc_lambda=5.0,
                      has_distill=True, distill_logits=jnp.asarray(old_logits),
                      distill_active=jnp.asarray(old_active), distill_lambda=1.0,
                      distill_temperature=2.0)
        textra = dict(ewc_old=convert.head_params_from_jax(old),
                      ewc_fisher=convert.head_params_from_jax(fisher), ewc_lambda=5.0,
                      distill_logits=t(old_logits), distill_active=t(old_active),
                      distill_lambda=1.0, distill_temperature=2.0)
    if kind == "frozen":
        labels = np.eye(CAP, dtype=np.float32)[y]
        mask = frozen_mask(jp)
        jextra = dict(has_grad_mask=True, grad_mask=mask)
        textra = dict(grad_mask=convert.head_params_from_jax(mask))
    want = jtraining.fit_head(jp, jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(valid),
                              jnp.asarray(active), key, **kw, **jextra)
    perms, keeps = jax_fit_draws(key, valid, HIDDEN, kw["max_epochs"])
    state = inject(perms, keeps)
    got = training.fit_head(convert.head_params_from_jax(jp), t(emb), t(labels), t(valid),
                            t(active), None, **kw, **textra)
    assert got.epochs_run == int(want.epochs_run)
    assert len(state["perms"]) == kw["max_epochs"] - got.epochs_run
    assert abs(got.final_loss - float(want.final_loss)) <= 1e-4
    assert_trees_close(got.params, want.params, 1e-4)
    if kind == "ce":
        assert got.epochs_run < kw["max_epochs"]      # early stopping ran


def test_grad_mask_freezes_bit_for_bit_and_padding_rows_do_not_train():
    jp = jax_head(14, skip=True)
    tp = convert.head_params_from_jax(jp)
    mask = convert.head_params_from_jax(frozen_mask(jp))
    emb, y, valid = data(n=40, n_cap=64, seed=15)
    labels = np.eye(CAP, dtype=np.float32)[y]
    active = torch.arange(CAP) < N_CLASSES
    runs = []
    for pad in (0.0, 1e3):
        e = emb.copy()
        e[~valid] = pad
        g = torch.Generator().manual_seed(16)
        runs.append(training.fit_head(tp, t(e), t(labels), t(valid), active, g, lr=0.05,
                                      loss_type="bce", max_epochs=5, patience=10,
                                      use_scheduler=False, grad_mask=mask))
    a, b = (training.tree_leaves(r.params) for r in runs)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    for p0, p1, m in zip(training.tree_leaves(tp), a, training.tree_leaves(mask)):
        frozen = m == 0
        assert torch.equal(p1[frozen], p0[frozen])
        if (~frozen).any():
            assert not torch.equal(p1[~frozen], p0[~frozen])


def test_compute_fisher_matches_jax_with_its_samples(monkeypatch):
    jp = jax_head(17)
    emb, _, valid = data(n=45, n_cap=64, seed=18)
    active = np.arange(CAP) < N_CLASSES
    key = jax.random.PRNGKey(19)
    want = jewc.compute_fisher(jp, jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(active), key)
    # the JAX draws (ewc.py:50-66)
    rng, prng = jax.random.split(key)
    u = jax.random.uniform(prng, (len(valid),))
    perm = np.array(jnp.argsort(jnp.where(jnp.asarray(valid), u, 2.0 + u)))
    samples = []
    for b in range(2):
        rng, srng = jax.random.split(rng)
        x = jnp.asarray(emb[perm[b * BATCH:(b + 1) * BATCH]])
        lg = jnp.where(jnp.asarray(active)[None, :], jhead.head_forward(jp, x), jhead.NEG_INF)
        samples.append(np.array(jax.random.categorical(srng, lg, axis=-1)).astype(np.int64))
    monkeypatch.setattr(training, "_epoch_permutation", lambda g, v: torch.from_numpy(perm))
    monkeypatch.setattr(ewc, "_sample_labels", lambda g, logits: torch.from_numpy(samples.pop(0)))
    got = ewc.compute_fisher(convert.head_params_from_jax(jp), t(emb), t(valid), t(active), None)
    assert samples == []
    for a, b in zip(training.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-4)
    monkeypatch.undo()
    bundle = ewc.make_ewc_bundle(convert.head_params_from_jax(jp), t(emb), t(valid), t(active),
                                 torch.Generator().manual_seed(0), 5.0)
    assert bundle.ewc_lambda == 5.0
    assert all(torch.isfinite(f).all() and (f >= 0).all()
               for f in training.tree_leaves(bundle.fisher))
