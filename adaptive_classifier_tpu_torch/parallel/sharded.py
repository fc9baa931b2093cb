"""The sharded predict and train steps over a ("dp", "tp") mesh.

Counterpart of ``adaptive_classifier_tpu/parallel/sharded.py``.  The JAX
package writes them as ``jit`` programs with sharding annotations and lets
XLA insert the collectives; here they are plain functions that every rank
calls with the same arguments (SPMD), each rank working on its own slice
with the collectives written out:

- ``make_sharded_predict``: the encoder forward on the rank's dp rows
  (kernels B1 and B10 on a GPU), similarities against its tp shard of the
  prototypes (B4 on a GPU), the head's logits for its columns, and the
  ``fusion.fuse_full`` rule computed column-parallel
  (``fuse_full_local``), and the dp rows all-gathered at the end;
- ``fuse_full_local`` / ``fuse_topk_local``: the ``predict`` and
  ``predict_batch`` fusions on one tp shard's classes: the softmax maxima
  and sums, the row totals and the scorable count are all-reduced over
  tp, and each shard's top-k is all-gathered and merged (the sharded
  classifier's predicts run them too);
- ``make_sharded_train_step``: one step of the head on the batch: the
  encoder forward on the dp rows; the memory append (the dp rows
  all-gathered in batch order, each tp shard taking its own classes),
  capacity prune and prototype update; the masked cross-entropy with
  dropout over column-parallel logits (row max, sum of exponentials and
  target logit all-reduced over tp; the loss divided by the global count
  of valid rows); gradients all-reduced over dp (and over tp for the
  replicated hidden layers); global-norm clipping that counts each shard
  once; AdamW on each rank's slice;
- ``sharded_ridge_solve``: the closed-form ridge head with dp-sharded rows
  and tp-sharded class columns;
- ``reference_train_step``: the same step on one device with the
  single-device functions, which the sharded step is held to.

Sharded arguments are ``DTensor``s under the mesh's placements
(``shard_state``), or full tensors, which every rank holds alike and
slices for itself.  Dropout masks are drawn for the whole batch from one
``torch.Generator`` that every rank seeds alike; each rank keeps its
rows, so the sharded step equals the single-device one.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import training
from ..memory import MemoryState, add_batch, prune
from ..models import head as head_lib
from ..models.encoder import EncoderConfig, attention_policy, embed_texts_device
from ..ops import knn
from .mesh import (all_gather_cat, all_reduce, batch_sharding, dp_rank, head_shardings,
                   local, memory_shardings, place, tp_rank)

NEG = head_lib.NEG_INF


def _dp_rows(mesh: DeviceMesh, n: int) -> slice:
    ndp = mesh.size(0)
    if n % ndp:
        raise ValueError(f"a batch of {n} rows does not split over dp={ndp} "
                         f"(pad it with labels -1)")
    per = n // ndp
    return slice(dp_rank(mesh) * per, (dp_rank(mesh) + 1) * per)


def _embed(enc_params, ids, mask, cfg: EncoderConfig, compute_dtype):
    impl = attention_policy(cfg, ids.device, ids.shape[1])
    with torch.no_grad():
        return embed_texts_device(enc_params, ids, mask, cfg, compute_dtype, attn_impl=impl)


def _local_tree(mesh, tree, specs):
    return training.tree_map(lambda t, s: local(mesh, t, s), tree, specs)


def _placed_tree(mesh, tree, specs):
    return training.tree_map(lambda t, s: place(mesh, t, s), tree, specs)


def _col_softmax(x, mask, group, bias=None):
    """Softmax over every column of every tp shard of ``x [B, C/tp]``,
    masked columns at 0, ``bias`` added to the unmasked ones
    (``knn.full_scores`` / ``head.masked_probs``)."""
    if bias is not None:
        x = x + bias[None, :]
    neg = torch.where(mask[None, :], x, torch.full_like(x, NEG))
    m = all_reduce(neg.max(dim=1, keepdim=True).values, group, dist.ReduceOp.MAX)
    e = torch.exp(neg - m)
    p = e / all_reduce(e.sum(dim=1, keepdim=True), group)
    return torch.where(mask[None, :], p, torch.zeros_like(p))


def _normalize_rows(x, group):
    total = all_reduce(x.sum(dim=-1, keepdim=True), group)
    return torch.where(total > 0, x / torch.clamp(total, min=1e-12), x)


def _global_topk(x, k: int, off: int, group):
    """The top ``k`` of ``[B, C]`` over every tp shard's columns ``x [B,
    C/tp]`` (global ids from ``off``): each shard's top-k, the candidates
    gathered shard by shard, one merge, so a tie goes to the lower id."""
    vals, idx = knn.top_k_lower_index(x, min(k, x.shape[1]))
    cand_vals = all_gather_cat(vals, group, 1)
    cand_ids = all_gather_cat(idx + off, group, 1)
    if cand_vals.shape[1] < k:
        pad = k - cand_vals.shape[1]
        cand_vals = torch.nn.functional.pad(cand_vals, (0, pad), value=float("-inf"))
        cand_ids = torch.nn.functional.pad(cand_ids, (0, pad), value=-1)
    top, pos = knn.top_k_lower_index(cand_vals, k)
    return top, torch.gather(cand_ids, 1, pos)


def _scatter_local(vals, ids, off: int, C_l: int):
    """``[B, k]`` scores at global ids → this shard's ``[B, C_l]`` columns."""
    own = (ids >= off) & (ids < off + C_l)
    out = torch.zeros((vals.shape[0], C_l), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, torch.where(own, ids - off, torch.zeros_like(ids)),
                            torch.where(own, vals, torch.zeros_like(vals)))


def fuse_full_local(group, emb, proto, valid, head_params, active, proto_w, head_w,
                    off: int, k: int, has_head: bool, proto_bias=None):
    """``fusion.fuse_full_from_emb`` on one tp shard's classes ``[off, off
    + C/tp)``: ``proto`` / ``valid`` / ``active`` / ``proto_w`` /
    ``head_w`` / ``proto_bias`` and the head's output columns are the
    shard's; the softmax maxima and sums, the row totals and the scorable
    count are all-reduced over ``group`` and the shards' top-k merged →
    (scores, ids ``[B, k]``), the same on every rank."""
    sims = knn.masked_sims(emb, proto, valid, pallas_min_classes=0)
    combined = _col_softmax(sims, valid, group, proto_bias) * proto_w[None, :]
    scorable = valid
    if has_head:
        logits = head_lib.head_forward(head_params, emb)
        combined = combined + _col_softmax(logits, active, group) * head_w[None, :]
        scorable = valid | active
    combined = _normalize_rows(combined, group)
    ranked = torch.where(scorable[None, :], combined,
                         torch.full_like(combined, float("-inf")))
    top, ids = _global_topk(ranked, k, off, group)
    n_scorable = all_reduce(scorable.sum().reshape(1), group)
    in_range = torch.arange(k, device=emb.device)[None, :] < n_scorable
    return (torch.where(in_range, top, torch.zeros_like(top)),
            torch.where(in_range, ids, torch.full_like(ids, -1)))


def fuse_topk_local(group, emb, proto, valid, head_params, active, proto_weight: float,
                    head_weight: float, off: int, k: int, has_head: bool, proto_bias=None):
    """``fusion.fuse_topk_from_emb`` on one tp shard's classes, as
    ``fuse_full_local`` takes them: the prototype top-k and the head's
    top-k are each merged over the shards, scattered back onto each
    shard's columns, combined, normalized with all-reduced row totals and
    merged once more → (scores, ids ``[B, k]``), the same on every rank."""
    C_l = proto.shape[0]
    sims = knn.masked_sims(emb, proto, valid, pallas_min_classes=0)
    adj = sims if proto_bias is None else sims + proto_bias[None, :]
    vals, ids = _global_topk(torch.where(valid[None, :], adj, torch.full_like(adj, NEG)),
                             k, off, group)
    in_range = (torch.arange(k, device=emb.device)[None, :]
                < all_reduce(valid.sum().reshape(1), group))
    scores = torch.softmax(torch.where(in_range, vals, torch.full_like(vals, NEG)), dim=-1)
    scores = torch.where(in_range, scores, torch.zeros_like(scores))
    ids = torch.where(in_range, ids, torch.full_like(ids, -1))
    combined = _scatter_local(scores, ids, off, C_l) * proto_weight
    if has_head:
        probs = _col_softmax(head_lib.head_forward(head_params, emb), active, group)
        combined = combined + _scatter_local(*_global_topk(probs, k, off, group),
                                             off, C_l) * head_weight
    combined = _normalize_rows(combined, group)
    ranked = torch.where(combined > 0, combined, torch.full_like(combined, float("-inf")))
    top, ids = _global_topk(ranked, k, off, group)
    ok = top > float("-inf")
    return (torch.where(ok, top, torch.zeros_like(top)),
            torch.where(ok, ids, torch.full_like(ids, -1)))


def make_sharded_predict(mesh: DeviceMesh, enc_cfg: EncoderConfig, k: int,
                         compute_dtype=torch.bfloat16):
    """→ ``predict(enc_params, head_params, input_ids, attention_mask,
    protos, proto_valid, active, (proto_w, head_w)) → (scores [B, k],
    ids [B, k])``, the same on every rank.  ``input_ids`` / ``attention_mask``
    are the whole batch (B divisible by dp); ``protos`` / ``proto_valid``
    and the head's output layer are sharded on "tp" (or full);
    ``active`` and the weights are full ``[C]`` vectors."""
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")
    mspec = memory_shardings(mesh)

    def predict(enc_params, head_params, input_ids, attention_mask, protos, proto_valid,
                active, weights):
        rows = _dp_rows(mesh, input_ids.shape[0])
        emb = _embed(enc_params, input_ids[rows], attention_mask[rows], enc_cfg,
                     compute_dtype)
        p_l = local(mesh, protos, mspec["proto"])
        C_l, off = p_l.shape[0], tp_rank(mesh) * p_l.shape[0]
        cols = slice(off, off + C_l)
        pw, hw = weights
        with torch.no_grad():
            scores, ids = fuse_full_local(
                tp_group, emb, p_l, local(mesh, proto_valid, mspec["count"]),
                _local_tree(mesh, head_params, head_shardings(mesh, head_params)),
                active[cols], pw[cols], hw[cols], off, k, True)
        return all_gather_cat(scores, dp_group, 0), all_gather_cat(ids, dp_group, 0)

    return predict


class ShardedTrainState(NamedTuple):
    head_params: Any
    opt: training.AdamW
    memory: MemoryState


def _clone_memory(m: MemoryState) -> MemoryState:
    return MemoryState(emb=m.emb.clone(), count=m.count.clone(), proto=m.proto.clone(),
                       pweight=m.pweight.clone())


def _step_memory(memory: MemoryState, emb: torch.Tensor, labels: np.ndarray,
                 max_examples: Optional[int]) -> MemoryState:
    mem = _clone_memory(memory)
    add_batch(mem, emb, labels)
    cap = max_examples if max_examples is not None else max(memory.example_capacity - 1, 1)
    prune(mem, cap)
    return mem


def _keep_masks(generator, head_params, n: int):
    """One dropout draw per hidden layer for the whole ``n``-row batch."""
    return [head_lib._keep_mask(generator, (n, layer["w"].shape[1]))
            for layer in head_params["hidden"]]


def make_sharded_train_step(mesh: DeviceMesh, enc_cfg: EncoderConfig,
                            compute_dtype=torch.bfloat16, lr: float = 1e-3,
                            max_examples: Optional[int] = None):
    """One step, dp x tp sharded: tokens → encoder (dp rows) → [memory
    append, capacity prune, prototype update (tp classes)] → masked CE of
    the head with dropout (class columns on tp) → clipped AdamW.

    → ``train_step(enc_params, state, input_ids, attention_mask, labels,
    active, generator) → (state, loss)``.  ``labels == -1`` marks padding
    rows (a batch must split over dp): no loss and no append.  The
    generator must be seeded alike on every rank (and live on the
    parameters' device)."""
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")
    mspec = memory_shardings(mesh)

    def train_step(enc_params, state: ShardedTrainState, input_ids, attention_mask,
                   labels, active, generator):
        B = input_ids.shape[0]
        rows = _dp_rows(mesh, B)
        emb = _embed(enc_params, input_ids[rows], attention_mask[rows], enc_cfg,
                     compute_dtype)
        labels = labels.to(torch.int64)
        hspec = head_shardings(mesh, state.head_params)
        params = training.tree_map(lambda t: t.detach(),
                                   _local_tree(mesh, state.head_params, hspec))
        mem = MemoryState(**{f: local(mesh, getattr(state.memory, f), mspec[f])
                             for f in ("emb", "count", "proto", "pweight")})
        C_l = mem.class_capacity
        off = tp_rank(mesh) * C_l

        # the append ranks duplicate labels within the batch: every shard
        # sees the whole batch in order and takes its own classes
        cls = labels.cpu().numpy() - off
        cls[(cls < 0) | (cls >= C_l)] = -1
        mem = _step_memory(mem, all_gather_cat(emb, dp_group, 0), cls, max_examples)

        keep = [m[rows] for m in _keep_masks(generator, params, B)]
        y = labels[rows]
        vmask = (y >= 0).to(torch.float32)
        act_l = active[off:off + C_l]
        leaves = training.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits = head_lib.head_forward(params, emb, train=True, keep=keep)
            z = torch.where(act_l[None, :], logits, torch.full_like(logits, NEG))
            m = all_reduce(z.detach().max(dim=1, keepdim=True).values, tp_group,
                           dist.ReduceOp.MAX)
            e = torch.exp(z - m)
            s = all_reduce(e.detach().sum(dim=1), tp_group)
            t = torch.clamp(y, min=0) - off
            own = (t >= 0) & (t < C_l)
            zt = torch.where(own, torch.gather(z, 1, t.clamp(0, C_l - 1)[:, None])[:, 0],
                             torch.zeros_like(vmask))
            n = torch.clamp(all_reduce(vmask.sum(), dp_group), min=1.0)
            # its gradient is the CE's for this rank's rows and columns
            surrogate = torch.sum(vmask * (e.sum(dim=1) / s - zt)) / n
            grads = torch.autograd.grad(surrogate, leaves)
        for p in leaves:
            p.requires_grad_(False)
        with torch.no_grad():
            nll = torch.log(s) + m[:, 0] - all_reduce(zt.detach(), tp_group)
            loss = all_reduce(torch.sum(nll * vmask), dp_group) / n

            # the output layer (and skip probe) holds this shard's columns;
            # the hidden layers are whole on every rank
            column_leaves = {id(leaf) for key in ("out", "skip")
                             for leaf in training.tree_leaves(params.get(key, {}))}
            reduced, sq_sharded, sq_whole = [], 0.0, 0.0
            for leaf, g in zip(leaves, grads):
                g = all_reduce(g, dp_group)
                if id(leaf) in column_leaves:
                    sq_sharded = sq_sharded + torch.sum(g * g)
                else:
                    g = all_reduce(g, tp_group)
                    sq_whole = sq_whole + torch.sum(g * g)
                reduced.append(g)
            norm = torch.sqrt(all_reduce(torch.as_tensor(sq_sharded, device=emb.device),
                                         tp_group) + sq_whole)
            scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-6), max=1.0)
            grads = training._like(params, [g * scale for g in reduced])
            opt = training.AdamW(m=_local_tree(mesh, state.opt.m, hspec),
                                 v=_local_tree(mesh, state.opt.v, hspec), step=state.opt.step)
            new_params, new_opt = training.adamw_update(params, grads, opt, lr)
        place_local = lambda tree: training.tree_map(
            lambda t, s: _from_local(mesh, t, s), tree, hspec)
        new_state = ShardedTrainState(
            head_params=place_local(new_params),
            opt=training.AdamW(m=place_local(new_opt.m), v=place_local(new_opt.v),
                               step=new_opt.step),
            memory=MemoryState(**{f: _from_local(mesh, getattr(mem, f), mspec[f])
                                  for f in ("emb", "count", "proto", "pweight")}))
        return new_state, loss

    return train_step


def _from_local(mesh, t, placements):
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False)


def reference_train_step(enc_params, state: ShardedTrainState, input_ids, attention_mask,
                         labels, active, generator, enc_cfg: EncoderConfig,
                         compute_dtype=torch.bfloat16, lr: float = 1e-3,
                         max_examples: Optional[int] = None
                         ) -> Tuple[ShardedTrainState, torch.Tensor]:
    """The step of ``make_sharded_train_step`` on one device, from the
    single-device functions (``memory.add_batch`` / ``prune``,
    ``training._ce_loss``, ``value_and_grad``, ``clip_global_norm``,
    ``adamw_update``) with the same dropout draws: what the sharded step
    must reproduce."""
    emb = _embed(enc_params, input_ids, attention_mask, enc_cfg, compute_dtype)
    labels = labels.to(torch.int64)
    mem = _step_memory(state.memory, emb, labels.cpu().numpy(), max_examples)
    keep = _keep_masks(generator, state.head_params, input_ids.shape[0])
    vmask = (labels >= 0).to(torch.float32)
    loss, grads = training.value_and_grad(
        lambda p: training._ce_loss(head_lib.head_forward(p, emb, train=True, keep=keep),
                                    labels, vmask, active), state.head_params)
    grads = training.clip_global_norm(grads, 1.0)
    params, opt = training.adamw_update(state.head_params, grads, state.opt, lr)
    return ShardedTrainState(params, opt, mem), loss


def sharded_ridge_solve(mesh: DeviceMesh, emb: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor, class_capacity: int, lam: float = 1.0):
    """``training.ridge_solve`` with the rows sharded on "dp" and the class
    columns on "tp" → the ``[D, C]`` weights as a ``DTensor`` placed as the
    head's output layer (column shards).  ``emb`` / ``labels`` / ``valid``
    are ``DTensor``s with rows on "dp" (``batch_sharding``) or full
    tensors.  Primal form (rows > dims): the Gram matrices ``FᵀF`` and
    ``FᵀY`` are all-reduced over dp; dual form: the rows (the smaller
    side) are all-gathered over dp and ``K = FFᵀ`` is formed whole.  Each
    tp rank solves for its own classes' columns."""
    rows = batch_sharding(mesh, 2)
    dp_group = mesh.get_group("dp")
    F = local(mesh, emb, rows).to(torch.float32)
    v = local(mesh, valid, rows)
    lab = torch.clamp(local(mesh, labels, rows).to(torch.int64), min=0)
    F = torch.where(v[:, None], F, torch.zeros((), device=F.device))
    ntp = mesh.size(1)
    if class_capacity % ntp:
        raise ValueError(f"{class_capacity} classes do not split over tp={ntp}")
    C_l = class_capacity // ntp
    off = tp_rank(mesh) * C_l
    t = lab - off
    Y = ((t[:, None] == torch.arange(C_l, device=F.device)[None, :])
         & v[:, None]).to(torch.float32)
    N = F.shape[0] * mesh.size(0)
    D = F.shape[1]
    if N <= D:
        F = all_gather_cat(F, dp_group, 0)
        Y = all_gather_cat(Y, dp_group, 0)
        K = F @ F.T
        W = F.T @ training._spd_solve(K + lam * torch.eye(N, device=F.device), Y)
    else:
        G = all_reduce(F.T @ F, dp_group)
        FtY = all_reduce(F.T @ Y, dp_group)
        W = training._spd_solve(G + lam * torch.eye(D, device=F.device), FtY)
    return _from_local(mesh, W, (Replicate(), Shard(1)))


def shard_state(mesh: DeviceMesh, memory: MemoryState, head_params) -> Tuple[MemoryState, Any]:
    """Place a memory state and head params on the mesh with the standard
    layout (each rank keeps its slice of the full values it holds)."""
    mspec = memory_shardings(mesh)
    placed = MemoryState(**{f: place(mesh, getattr(memory, f), mspec[f])
                            for f in ("emb", "count", "proto", "pweight")})
    return placed, _placed_tree(mesh, head_params, head_shardings(mesh, head_params))
