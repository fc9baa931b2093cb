"""The port's sharded stack (``adaptive_classifier_tpu_torch/parallel``) on
4 gloo ranks (dp 2 x tp 2), held against the JAX package on its 8-device
virtual mesh (dp 4 x tp 2) and against the port's single-device functions.

The ranks run ``tests/torch_parallel_helpers.py`` (torch and the port
only) in two spawns, one per module-scoped fixture; each test reads its
part of the results.  The JAX side runs here, in the test process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adaptive_classifier_tpu import training as jtraining
from adaptive_classifier_tpu.models import head as jhead
from adaptive_classifier_tpu.models.encoder import EncoderConfig, init_params
from adaptive_classifier_tpu.ops import knn as jknn
from adaptive_classifier_tpu.parallel import mesh as jmesh
from adaptive_classifier_tpu.parallel.sharded import make_sharded_predict
from adaptive_classifier_tpu.parallel.sharded_knn import make_sharded_topk, shard_prototypes

from tests.torch_parallel_helpers import spawn

WORLD = 4
C_CAP = 16

#: the shipped zoo configuration with small buckets, as JAX
#: tests/test_parallel.py holds its facade
PROD_CFG = {
    "lexical_dim": 8192, "head_type": "ridge", "fusion_weights": "auto",
    "train_size_buckets": [64, 256], "class_capacity_buckets": [8],
    "example_capacity_buckets": [32], "embedding_cache_size": 0,
}


def _np_head(tree):
    return {"hidden": [{k: np.asarray(v) for k, v in l.items()} for l in tree["hidden"]],
            "out": {k: np.asarray(v) for k, v in tree["out"].items()}}


def _unit(r, shape):
    x = r.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def core_case(tmp_path_factory):
    """Inputs, the JAX package's answers, and the 4 ranks' results."""
    cfg = EncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128, max_position_embeddings=64)
    head = jhead.init_head(jax.random.PRNGKey(42), cfg.hidden_size, C_CAP, 4,
                           hidden_dims=[cfg.hidden_size, cfg.hidden_size // 2])
    r = np.random.default_rng(0)
    B, S = 8, 16
    ids = r.integers(0, 500, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[-1, 10:] = 0
    labels = (np.arange(B) % 4).astype(np.int32)
    labels[3] = -1                                   # a padding row
    active = np.arange(C_CAP) < 4
    r5, r6 = np.random.default_rng(5), np.random.default_rng(6)
    inp = {
        "enc_cfg": dict(cfg.__dict__), "head": _np_head(head), "ids": ids, "mask": mask,
        "labels": labels, "active": active,
        "topk_a": {"q": _unit(r5, (8, 16)), "p": _unit(r5, (32, 16)),
                   "valid": np.arange(32) < 27, "k": 5},
        "topk_b": {"q": r6.standard_normal((4, 8)).astype(np.float32),
                   "p": r6.standard_normal((16, 8)).astype(np.float32),
                   "valid": np.arange(16) < 3, "k": 6},
    }
    # exact ties across shards: each prototype twice, 16 rows apart
    half = _unit(r5, (16, 16))
    inp["topk_ties"] = {"q": _unit(r5, (8, 16)), "p": np.concatenate([half, half]),
                        "valid": np.ones(32, bool), "k": 6}
    r2 = np.random.default_rng(2)
    inp["predict"] = {"protos": r2.standard_normal((C_CAP, cfg.hidden_size)).astype(np.float32),
                      "valid": np.arange(C_CAP) < 4,
                      "pw": np.full((C_CAP,), 0.7, np.float32),
                      "hw": np.full((C_CAP,), 0.3, np.float32)}
    r3 = np.random.default_rng(3)
    inp["fusion"] = {
        "emb": _unit(r3, (8, cfg.hidden_size)) * 0.1 + inp["predict"]["protos"][:8] * 0.05,
        "valid": np.arange(C_CAP) % 3 != 1, "active": np.arange(C_CAP) < 11,
        "bias": r3.standard_normal(C_CAP).astype(np.float32) * 0.1}
    r11 = np.random.default_rng(11)
    lab = r11.integers(0, 5, (64,)).astype(np.int32)
    inp["ridge_dual"] = {"emb": r11.standard_normal((64, 48)).astype(np.float32),
                         "labels": lab, "valid": np.arange(64) < 40}
    inp["ridge_primal"] = {"emb": r11.standard_normal((64, 8)).astype(np.float32),
                           "labels": lab, "valid": np.arange(64) < 40}

    mesh = jmesh.make_mesh(8)
    want = {}
    for case in ("topk_a", "topk_b", "topk_ties"):
        c = inp[case]
        p, v = shard_prototypes(mesh, jnp.asarray(c["p"]), jnp.asarray(c["valid"]))
        want[case] = [np.asarray(a) for a in make_sharded_topk(mesh, c["k"])(
            jnp.asarray(c["q"]), p, v)]
        sims = jknn.masked_sims_ref(jnp.asarray(c["q"]), jnp.asarray(c["p"]),
                                    jnp.asarray(c["valid"]))
        want[case + "_single"] = [np.asarray(a) for a in jknn.topk_scores(
            sims, jnp.asarray(c["valid"]), c["k"])]
    pr = inp["predict"]
    want["predict"] = [np.asarray(a) for a in make_sharded_predict(
        mesh, cfg, k=3, compute_dtype=jnp.float32)(
        init_params(0, cfg), head, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(pr["protos"]), jnp.asarray(pr["valid"]), jnp.asarray(active),
        (jnp.asarray(pr["pw"]), jnp.asarray(pr["hw"])))]
    for name in ("ridge_dual", "ridge_primal"):
        rr = inp[name]
        want[name] = np.asarray(jtraining.ridge_solve(
            jnp.asarray(rr["emb"]), jnp.asarray(rr["labels"]), jnp.asarray(rr["valid"]),
            C_CAP, 1.0))
    directory = tmp_path_factory.mktemp("core")
    return inp, want, spawn("core", WORLD, directory, inp), directory


@pytest.fixture(scope="module")
def facade_case(tmp_path_factory):
    texts = ([f"the billing page crashed again case {i}" for i in range(6)]
             + [f"great service and quick delivery order {i}" for i in range(6)])
    labels = ["complaint"] * 6 + ["praise"] * 6
    new = [f"please cancel my subscription now ref {i}" for i in range(4)]
    inp = {"cfg": PROD_CFG, "batches": [(texts, labels), (new, ["cancel"] * 4)],
           "queries": ["the billing page crashed again case 9",
                       "great service and quick delivery order 9",
                       "please cancel my subscription now ref 9"]}
    return spawn("facade", WORLD, tmp_path_factory.mktemp("facade"), inp)


def test_ranks_form_a_2x2_mesh_without_jax(core_case, facade_case):
    for res in core_case[2] + facade_case:
        assert res["mesh"] == (2, 2)
        assert res["jax_loaded"] == []


def test_sharded_topk_matches_jax(core_case):
    inp, want, results, _ = core_case
    for res in results:
        assert res["topk_a_local_rows"] == 16
        scores, idx, raw = res["topk_a"]
        np.testing.assert_array_equal(idx, want["topk_a"][1])
        np.testing.assert_array_equal(idx, want["topk_a_single"][1])
        np.testing.assert_allclose(scores, want["topk_a"][0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(raw, want["topk_a"][2], rtol=1e-5, atol=1e-6)
        assert ((raw > 0) & (raw <= 1.0 + 1e-6)).all()


def test_sharded_topk_fewer_valid_than_k(core_case):
    inp, want, results, _ = core_case
    for res in results:
        scores, idx, _ = res["topk_b"]
        assert (idx[:, 3:] == -1).all()
        np.testing.assert_allclose(scores.sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(idx, want["topk_b"][1])
        np.testing.assert_allclose(scores, want["topk_b"][0], rtol=1e-5, atol=1e-6)


def test_sharded_topk_breaks_ties_to_the_lower_index(core_case):
    inp, want, results, _ = core_case
    for res in results:
        scores, idx, _ = res["topk_ties"]
        np.testing.assert_array_equal(idx, want["topk_ties_single"][1])
        np.testing.assert_array_equal(idx, want["topk_ties"][1])
        # every pair of equal prototypes is picked together, lower id first
        assert (idx[:, 0::2] < 16).all() and (idx[:, 1::2] == idx[:, 0::2] + 16).all()
        np.testing.assert_allclose(scores, want["topk_ties"][0], rtol=1e-5, atol=1e-6)


def test_sharded_predict_matches_jax(core_case):
    inp, want, results, _ = core_case
    for res in results:
        scores, ids = res["predict"]
        np.testing.assert_array_equal(ids, want["predict"][1])
        np.testing.assert_allclose(scores, want["predict"][0], atol=1e-5)


def test_shard_local_fusions_match_single_device(core_case):
    inp, want, results, _ = core_case
    for res in results:
        for name, (got, single) in res["fusions"].items():
            np.testing.assert_array_equal(got[1], single[1], err_msg=name)
            np.testing.assert_allclose(got[0], single[0], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            assert (got[1] >= 0).any(), name


@pytest.mark.parametrize("branch", ["ridge_dual", "ridge_primal"])
def test_sharded_ridge_solve_matches_jax(core_case, branch):
    inp, want, results, _ = core_case
    for res in results:
        assert res[f"{branch}_local_cols"] == C_CAP // 2
        np.testing.assert_allclose(res[branch], want[branch], rtol=1e-4, atol=1e-5)


def test_sharded_train_step_matches_single_device(core_case):
    inp, want, results, _ = core_case
    for res in results:
        t = res["train"]
        assert abs(t["loss"][0] - t["loss"][1]) < 1e-5
        assert t["head_diff"] < 1e-5 and t["opt_diff"] < 1e-5
        assert t["proto_diff"] < 1e-5 and t["emb_diff"] < 1e-5
        assert t["count_equal"]
        assert t["local_classes"] == C_CAP // 2
        # the step did something: the batch landed in memory, the head moved
        assert t["proto_changed"] > 0.1 and t["grad_moved"] > 1e-4
    for res in results[1:]:
        for a, b in zip(jax.tree.leaves(res["train"]["head"]),
                        jax.tree.leaves(results[0]["train"]["head"])):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_from_four_ranks_restores_in_one_process(core_case):
    import torch

    from adaptive_classifier_tpu_torch import training
    from adaptive_classifier_tpu_torch.parallel.checkpoint import restore_sharded

    inp, want, results, directory = core_case
    full = results[0]["ckpt_full"]
    template = training.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype),
                                 full)
    back = restore_sharded(directory / "ckpt", template)
    for a, b in zip(training.tree_leaves(back), training.tree_leaves(full)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert all(res["ckpt_mesh4"] for res in results)


def test_sharded_facade_production_config_matches_plain(facade_case):
    for res in facade_case:
        assert res["embedding_dim"] == 128 + 8192
        C = res["classes"]
        assert res["local_classes"] == {f: C // 2 for f in ("emb", "count", "proto", "pweight")}
        assert res["head_local_cols"] * 2 == res["head_cols"]
        assert res["predict_gathers"] == []
        for plain_alpha, shard_alpha in res["alpha"]:
            assert plain_alpha == shard_alpha
        plain_bias, shard_bias = res["proto_bias"]
        if plain_bias is not None:
            np.testing.assert_allclose(shard_bias, plain_bias, rtol=1e-4, atol=1e-5)
        pairs = res["predict"] + list(zip(*res["predict_batch"]))
        for p1, p2 in pairs:
            assert [l for l, _ in p1] == [l for l, _ in p2]
            for (_, a), (_, b) in zip(p1, p2):
                assert abs(a - b) < 1e-4
    for res in facade_case[1:]:
        assert res["predict"] == facade_case[0]["predict"]


def test_sharded_memory_routes_1024_classes_shard_local(facade_case):
    for res in facade_case:
        k = res["knn"]
        assert k["capacity"] == 1024 and k["routed"] and k["local_rows"] == 512
        assert k["searches"] == [5]
        assert [l for l, _ in k["got"]] == [l for l, _ in k["base"]]
        np.testing.assert_allclose([s for _, s in k["got"]], [s for _, s in k["base"]],
                                   rtol=1e-5, atol=1e-6)
        assert k["thresholded"] == []


def test_initialize_distributed_is_a_noop_on_one_process(monkeypatch):
    from adaptive_classifier_tpu_torch.parallel import multihost

    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_distributed() is False
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        multihost.global_mesh()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="num_processes unknown"):
        multihost.initialize_distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="process_id unknown"):
        multihost.initialize_distributed()


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorisation_equals_jax(n):
    from adaptive_classifier_tpu_torch.parallel.mesh import mesh_shape

    assert mesh_shape(n) == jmesh.make_mesh(n).devices.shape
