"""Rank workers of ``test_torch_parallel.py``: torch, numpy and the port only.

``spawn(group, world, directory, inputs)`` starts ``world`` processes of
this file, which meet through a ``file://`` rendezvous in ``directory``
(never a fixed port), run one group of checks on a gloo process group with
the port's ``parallel`` stack, and each write their results to
``directory/out<rank>.pkl``.  The parent waits under one deadline; when a
rank fails or the deadline passes, every rank still running is killed, so
none is left behind.

Groups: ``"core"`` (the sharded top-k, predict, ridge solve and train step,
and the checkpoint) and ``"facade"`` (the sharded classifier and memory).
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 90.0
C_CAP = 16


def spawn(group: str, world: int, directory: Path, inputs: dict,
          deadline_s: float = DEADLINE_S) -> list:
    """Run ``group`` on ``world`` gloo ranks → each rank's result dict."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, __file__, group, str(rank), str(world),
                               str(directory)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(world)]
    failure = None
    try:
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failure = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > end:
                failure = f"ranks still running after {deadline_s:.0f} s"
                break
            time.sleep(0.05)
        if failure is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failure = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if failure is not None:
        raise AssertionError(failure + "\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    return [pickle.loads((directory / f"out{rank}.pkl").read_bytes())
            for rank in range(world)]


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _head(tree):
    return {"hidden": [{"w": _t(l["w"]), "b": _t(l["b"])} for l in tree["hidden"]],
            "out": {"w": _t(tree["out"]["w"]), "b": _t(tree["out"]["b"])}}


def _np_tree(tree):
    from adaptive_classifier_tpu_torch import training

    return training.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _max_diff(a, b):
    from adaptive_classifier_tpu_torch import training

    return max(float((x - y).abs().max()) for x, y in
               zip(training.tree_leaves(a), training.tree_leaves(b)))


def core(mesh, inp, directory: Path) -> dict:
    """The functional stack against the inputs the parent drew: the
    sharded top-k (three cases, one of exact ties), predict, ridge solve
    (both branches), one train step against the single-device step, and a
    checkpoint."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from adaptive_classifier_tpu_torch import training
    from adaptive_classifier_tpu_torch.memory import init_state
    from adaptive_classifier_tpu_torch.models.encoder import (config_from_dict, init_params,
                                                              params_from_tree)
    from adaptive_classifier_tpu_torch.parallel import checkpoint, mesh as mesh_lib
    from adaptive_classifier_tpu_torch.parallel.sharded import (
        ShardedTrainState, make_sharded_predict, make_sharded_train_step,
        reference_train_step, shard_state, sharded_ridge_solve)
    from adaptive_classifier_tpu_torch.parallel.sharded_knn import (make_sharded_topk,
                                                                    shard_prototypes)

    out = {}
    for case in ("topk_a", "topk_b", "topk_ties"):
        c = inp[case]
        p, v = shard_prototypes(mesh, _t(c["p"]), _t(c["valid"]))
        out[f"{case}_local_rows"] = p.to_local().shape[0]
        scores, idx, raw = make_sharded_topk(mesh, c["k"])(_t(c["q"]), p, v)
        out[case] = (scores.numpy(), idx.numpy(), raw.numpy())

    cfg = config_from_dict(inp["enc_cfg"])
    enc = params_from_tree(init_params(0, cfg), matrix_dtype=torch.float32)
    head = _head(inp["head"])
    pr = inp["predict"]
    mem0 = init_state(16, 16, cfg.hidden_size)
    mem_sh, head_sh = shard_state(mesh, mem0, head)
    protos_sh, valid_sh = shard_prototypes(mesh, _t(pr["protos"]), _t(pr["valid"]))
    predict = make_sharded_predict(mesh, cfg, k=3, compute_dtype=torch.float32)
    s, i = predict(enc, head_sh, _t(inp["ids"]), _t(inp["mask"]), protos_sh, valid_sh,
                   _t(inp["active"]), (_t(pr["pw"]), _t(pr["hw"])))
    out["predict"] = (s.numpy(), i.numpy())

    # the classifier's two fusions on each rank's classes, against the
    # single-device ones (with a calibration bias, with and without a head)
    from adaptive_classifier_tpu_torch.ops import fusion
    from adaptive_classifier_tpu_torch.parallel.sharded import fuse_full_local, fuse_topk_local

    fu = inp["fusion"]
    emb, protos, valid = _t(fu["emb"]), _t(pr["protos"]), _t(fu["valid"])
    act, bias, pw = _t(fu["active"]), _t(fu["bias"]), _t(pr["pw"])
    tp = mesh.get_group("tp")
    C_l = C_CAP // mesh.size(1)
    off = mesh.get_local_rank("tp") * C_l
    cols = slice(off, off + C_l)
    head_local = {"hidden": head["hidden"],
                  "out": {"w": head["out"]["w"][:, cols], "b": head["out"]["b"][cols]}}
    fusions = {}
    for has_head in (True, False):
        fusions[f"topk_{has_head}"] = [
            [a.numpy() for a in fuse_topk_local(tp, emb, protos[cols], valid[cols], head_local,
                                                 act[cols], 0.6, 0.4, off, 3, has_head,
                                                 bias[cols])],
            [a.numpy() for a in fusion.fuse_topk_from_emb(emb, protos, valid, head, act, 0.6,
                                                          0.4, 3, has_head, proto_bias=bias)]]
        fusions[f"full_{has_head}"] = [
            [a.numpy() for a in fuse_full_local(tp, emb, protos[cols], valid[cols], head_local,
                                                act[cols], pw[cols], 1.0 - pw[cols], off, 3,
                                                has_head, bias[cols])],
            [a.numpy() for a in fusion.fuse_full_from_emb(emb, protos, valid, head, act, pw,
                                                          1.0 - pw, 3, has_head,
                                                          proto_bias=bias)]]
    out["fusions"] = fusions

    for name in ("ridge_dual", "ridge_primal"):
        r = inp[name]
        W = sharded_ridge_solve(mesh, _t(r["emb"]), _t(r["labels"]), _t(r["valid"]), 16, 1.0)
        out[f"{name}_local_cols"] = W.to_local().shape[1]
        out[name] = W.full_tensor().numpy()

    # one train step, sharded and on one device, from one seed
    ids, mask, labels = _t(inp["ids"]), _t(inp["mask"]), _t(inp["labels"])
    active = _t(inp["active"])
    step = make_sharded_train_step(mesh, cfg, compute_dtype=torch.float32)
    state = ShardedTrainState(head_sh, training.adamw_init(head_sh), mem_sh)
    state_sh, loss_sh = step(enc, state, ids, mask, labels, active,
                             torch.Generator().manual_seed(0))
    state_1, loss_1 = reference_train_step(
        enc, ShardedTrainState(head, training.adamw_init(head), mem0), ids, mask, labels,
        active, torch.Generator().manual_seed(0), cfg, compute_dtype=torch.float32)
    full_head = training.tree_map(mesh_lib.full, state_sh.head_params)
    out["train"] = {
        "loss": (float(loss_sh), float(loss_1)),
        "head_diff": _max_diff(full_head, state_1.head_params),
        "opt_diff": max(_max_diff(training.tree_map(mesh_lib.full, state_sh.opt.m),
                                  state_1.opt.m),
                        _max_diff(training.tree_map(mesh_lib.full, state_sh.opt.v),
                                  state_1.opt.v)),
        "proto_diff": float((state_sh.memory.proto.full_tensor()
                             - state_1.memory.proto).abs().max()),
        "emb_diff": float((state_sh.memory.emb.full_tensor()
                           - state_1.memory.emb).abs().max()),
        "count_equal": bool(torch.equal(state_sh.memory.count.full_tensor(),
                                        state_1.memory.count)),
        "local_classes": state_sh.memory.emb.to_local().shape[0],
        "head": _np_tree(full_head),
        "proto_changed": float(state_1.memory.proto.abs().max()),
        "grad_moved": _max_diff(state_1.head_params, head),
    }

    # the stepped state, written from every rank; the parent restores it
    # in one process, and here it is read back onto a 1 x 4 mesh
    ckpt = {"memory": {f: getattr(state_sh.memory, f) for f in ("emb", "count", "proto")},
            "head": state_sh.head_params}
    checkpoint.save_sharded(directory / "ckpt", ckpt)
    out["ckpt_full"] = {"memory": {f: getattr(state_sh.memory, f).full_tensor().numpy()
                                   for f in ("emb", "count", "proto")},
                        "head": _np_tree(full_head)}
    mesh4 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("dp", "tp"))
    spec4 = mesh_lib.memory_shardings(mesh4)
    template = {"memory": {f: mesh_lib.place(mesh4, torch.zeros_like(
        getattr(state_sh.memory, f).full_tensor()), spec4[f]) for f in ("emb", "count", "proto")}}
    back = checkpoint.restore_sharded(directory / "ckpt", template)
    rank4 = mesh4.get_local_rank("tp")
    out["ckpt_mesh4"] = all(
        back["memory"][f].to_local().shape[0] == 4
        and torch.equal(back["memory"][f].to_local(),
                        getattr(state_sh.memory, f).full_tensor().chunk(4)[rank4])
        for f in ("emb", "count", "proto"))
    dist.barrier()
    return out


def facade(mesh, inp, directory: Path) -> dict:
    """The production-config classifier sharded and plain, and the
    1,024-class memory's shard-local search."""
    import torch

    from adaptive_classifier_tpu_torch import AdaptiveClassifier, ModelConfig, PrototypeMemory
    from adaptive_classifier_tpu_torch.config import Example
    from adaptive_classifier_tpu_torch.parallel.facade import (ShardedAdaptiveClassifier,
                                                               ShardedPrototypeMemory)

    out = {}
    plain = AdaptiveClassifier("prajjwal1/bert-tiny", device="cpu", config=dict(inp["cfg"]))
    shard = ShardedAdaptiveClassifier("prajjwal1/bert-tiny", mesh=mesh, device="cpu",
                                      config=dict(inp["cfg"]))
    for texts, labels in inp["batches"]:
        plain.add_examples(texts, labels)
        shard.add_examples(texts, labels)
        out.setdefault("alpha", []).append((plain._fusion_alpha, shard._fusion_alpha))
    out["embedding_dim"] = shard.embedding_dim
    placed = shard.memory._placed
    out["classes"] = placed.emb.shape[0]
    out["local_classes"] = {f: getattr(placed, f).to_local().shape[0]
                            for f in ("emb", "count", "proto", "pweight")}
    out["head_local_cols"] = shard._head_placed["out"]["w"].to_local().shape[1]
    out["head_cols"] = shard.head_params["out"]["w"].shape[1]
    out["proto_bias"] = (plain._proto_bias, shard._proto_bias)
    # the predicts run shard-local: with the gathered views dropped, they
    # gather nothing
    import adaptive_classifier_tpu_torch.parallel.facade as facade_mod

    shard.memory._view, shard._head_full = None, None
    gathers, real_full = [], facade_mod.full
    facade_mod.full = lambda x: (gathers.append(tuple(x.shape)), real_full(x))[1]
    try:
        out["predict"] = [(plain.predict(q, k=2), shard.predict(q, k=2))
                          for q in inp["queries"]]
        out["predict_batch"] = (plain.predict_batch(inp["queries"], k=2),
                                shard.predict_batch(inp["queries"], k=2))
    finally:
        facade_mod.full = real_full
    out["predict_gathers"] = gathers

    D = 32
    cfg = ModelConfig({"class_capacity_buckets": [1024], "example_capacity_buckets": [4],
                       "max_examples_per_class": 4})
    mem = ShardedPrototypeMemory(D, config=cfg, mesh=mesh)
    base = PrototypeMemory(D, config=cfg)
    r = np.random.default_rng(3)
    for i in range(12):
        v = r.standard_normal(D).astype(np.float32)
        v /= np.linalg.norm(v)
        for m in (mem, base):
            m.add_example(Example(f"t{i}", f"label_{i:02d}", v), f"label_{i:02d}")
    q = r.standard_normal(D).astype(np.float32)
    out["knn"] = {"capacity": mem.state.class_capacity, "routed": mem._use_shard_knn(),
                  "local_rows": mem._placed.proto.to_local().shape[0],
                  "got": mem.get_nearest_prototypes(q, k=5),
                  "base": base.get_nearest_prototypes(q, k=5),
                  "searches": sorted(mem._sharded_topk),
                  "thresholded": mem.get_nearest_prototypes(q, k=5, min_similarity=1.5)}
    return out


def _rank_main(group: str, rank: int, world: int, directory: Path):
    import torch

    torch.set_num_threads(1)
    from adaptive_classifier_tpu_torch.parallel import multihost
    from adaptive_classifier_tpu_torch.parallel.mesh import make_mesh

    assert multihost.initialize_distributed(
        f"file://{directory / 'rendezvous'}", num_processes=world, process_id=rank,
        backend="gloo")
    try:
        mesh = make_mesh()
        inp = pickle.loads((directory / "inputs.pkl").read_bytes())
        out = {"core": core, "facade": facade}[group](mesh, inp, directory)
        out["mesh"] = tuple(mesh.shape)
        out["jax_loaded"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "adaptive_classifier_tpu.")) or m == "adaptive_classifier_tpu")
        (directory / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        multihost.shutdown_distributed()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
