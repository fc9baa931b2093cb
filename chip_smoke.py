"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. a CUDA device is present; prints its name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``adaptive_classifier_tpu_torch/csrc`` with
   nvcc (timed, with ptxas' register and shared-memory report);
3. holds every kernel against its plain torch version on the card, TF32
   off (asserted): attention (B1) in f32 to max abs error <= 1e-4 and in
   bf16 to cosine > 0.999 and max abs error <= 0.05 (at S 24 to 512,
   across its one-pass and two-pass forms; the share of bf16 outputs
   equal to the plain version's bit for bit is reported); the masked kNN
   similarities (B4) to max abs error <= 1e-5, near-duplicate rows at D 512
   and 33,280 and the split contraction included; the streaming top-k (B5) to
   identical indices on inputs with no near-ties, lower-index order on
   exact ties, and values within 1e-5 (k 1 to 128, B off its 64-query
   tile, D 500 and 510); the int8 kernels at the zoo's
   widths (M 8,192, and ragged for the 64-row blocks of B2, B3 and B8) and
   at bert-base's (D 768, F 3,072, where B3 and B8 take 32-row blocks; M
   16,384 and ragged), f32 and bf16: the QKV projection (B2) to
   1e-5 (the share of outputs equal to the plain version's bit for bit
   reported) and the projection + LayerNorm (B9) to 1e-4 in f32, the FFN block
   (B3) and the post-attention body (B8) to per-row cosine >= 0.9999 and
   max abs error <= 0.05 in f32, all to cosine > 0.999 in bf16; flash
   attention (B6) at S 32 to 2,048 and one-shot attention (B7) at S 32 to
   512, H 8 and 12, and both in bf16 at S 17 and at Dh 128, with ragged
   masks and a fully masked row, to B1's tolerances; the fused add +
   LayerNorm (B10) at M 8,192, 32,768 and 1,000, D 512, to 1e-5 in f32
   and one bf16 step in bf16;
4. holds the float forward's linear layers on the card to the JAX
   package's order (the f32 product, bias and GELU, one rounding): >= 99%
   of a projection's bf16 outputs equal it bit for bit;
   serves saved zoo classifiers on the full-width encoder
   (checkpoints/ac-base-v2: BERT, 8 layers, hidden 512, 8 heads):
   ``predict_batch`` on each task's test rows, with launch counts (B1 once
   and B10 twice per layer per chunk), accuracy against the zoo manifest,
   and top-1 agreement with the plain attention; the bf16 forward of one
   chunk timed with the parent commit's linear layers and the current ones
   in turns; the ten kernels with the most device time in one
   hallucination-detector chunk's forward (``torch.profiler``);
4i. serves the same classifiers with ``quantization: "int8"``: B2, B3 and
   B1 once per layer per chunk, every embedding within cosine 0.99 of the
   bf16 forward's, accuracy >= manifest - 0.03, top-1 agreement >= 0.95
   with phase 4 (the JAX package's own int8 forward agrees on 0.966 of
   hallucination-detector's rows); times the int8 and
   bf16 encoder forwards per chunk in turns, and profiles one
   hallucination-detector chunk's int8 forward as phase 4 does; on the
   first banking chunk,
   ``fuse_o_proj=True`` sends every layer through B8 (cosine >= 0.999 with
   the default int8 forward), and the two forwards are timed in turns;
4a. serves both zoo tasks with ``AC_ATTN_IMPL=flash`` and then
   ``=oneshot`` (bf16), and banking-intents int8 with each: B6 or B7 once
   per layer per chunk and B1 never, accuracy >= manifest - 0.03, top-1
   agreement >= 0.99 with phase 4 (4i) and every embedding within cosine
   0.999 of the default path's (0.99, the int8 envelope, in int8); then
   the bf16 encoder forward of one chunk of each task with the fused
   LayerNorm off / on / on / off (B10 twice per layer with it on, never
   with it off, embeddings within cosine 0.999), the timing behind
   ``_FUSED_LN_ON_CUDA``;
6. builds banking-intents from data/intents.json with ``add_examples`` on
   the production config (lexical_dim 32768, ridge head, auto knobs), then
   adds its three new classes; accuracy >= manifest - 0.03; 6i does the
   same with ``quantization: "int8"`` (B2, B3 launched in every step);
6m. builds a classifier on the default configuration (``config={}``: MLP
   head, ``fusion_weights: history``, no lexical channel) from the intents
   train rows, then adds the three new classes (balanced replay with EWC and
   distillation): old-class top-1 relative drop <= 0.10, new-class top-1
   >= 2/3, first-batch top-1 >= the JAX package's on the CPU - 0.05; B1 and
   B10 on every add; seconds and epochs per add;
6s. saves the 6m classifier and loads it back on the card: the checkpoint's
   files, 5 examples a class, top-1 agreement >= 0.99 and score drift < 0.01
   on all 218 test rows;
6l. adds the new classes to the loaded zoo checkpoint banking-intents (a
   lossy replay store): the frozen-probe branch, the old classes' head
   logits bit for bit (``torch.equal``), old-class top-1 drop <= the JAX
   package's on the CPU + 0.03;
7. grows a 1,024-class classifier (960 + 64 classes): kernel B4 carries
   the recalibration and every ``predict_batch`` chunk, with top-1
   agreement >= 0.99 against the plain versions on the same embeddings;
8. builds a 16,384-class classifier: kernel B5 carries ``predict_batch``
   (agreement >= 0.99 with the plain path), B4 ``predict`` and
   ``predict_proba``;
9. the attention A/B at bert-base width: ``Encoder("bert-base-uncased")``
   builds the JAX package's offline random weights (12 layers, hidden 768,
   12 heads); B = 32, S in {64, 128, 512}, bf16 and int8, through
   fusedqkv, oneshot, flash and einsum: ms per batch and embedding cosine
   >= 0.999 against fusedqkv; then ``AdaptiveClassifier("bert-base-uncased")``
   takes add_examples and answers predict_batch (random weights: launch
   counts and answers gated, accuracy reported);
10. serves banking-intents through ``BatchingClassifierServer``
   (max_batch_size 64, max_wait_ms 2, 2 workers) from 8 client threads in
   a shuffled order: (a) cold, every future resolved, top-1 agreement
   >= 0.99 with a direct ``predict_batch`` and scores within 1e-3, B1 and
   B10 launched with B10 = 2 x B1; (a2) again with the new classes'
   ``add_examples`` submitted mid-stream: it returns True, and the served
   classifier agrees with a copy grown directly on >= 0.99 of the 218 test
   rows; (b) again: 200 more device-cache hits, no B1 launch, top-1
   agreement >= 0.99 with a cold direct ``predict_batch``; (c) a
   ``MultiTenantServer`` of the bf16 and the int8 classifier with
   interleaved traffic: each tenant's answers agree with its own direct
   ones (>= 0.99), B2 and B3 launched by the int8 tenant's batches only;
   (d) phase 7's 2,048 queries to its 1,024-class classifier through a
   2-worker server: top-1 agreement >= 0.99 with phase 7, B4 on every
   served batch.  Requests/s, p50 and p99 latency and the mean batch are
   reported for each;
11. ``calibrate`` on hallucination-detector's even test rows (T, NLL and
   ECE before and after), ``predict_proba(calibrated=True)`` on the odd
   ones summing to 1 within 1e-5; the card's temperature within one step
   of the fine grid (10^(0.24/32)) of the CPU port's fit on the same
   probabilities;
12. ``predict_document`` on the topic classifier: 20 documents of 10 test
   rows at 64-token windows and one of 60 rows (over 512 tokens) at the
   512 window (B1's two-pass form), in the mean, max and vote pools: top-1
   >= the JAX package's on the CPU - 0.05, B1 once per layer per window
   batch; a one-window document has ``predict``'s top-1 and its mean-pool
   scores within 5e-3 of ``_predict_from_embedding``'s;
13. ``MultiLabelAdaptiveClassifier`` on ac-base-v2 (default config) from
   198 topic x emotion pairs in two adds (B1 and B10 on each):
   micro-F1 on the 200 test pairs >= the JAX package's on the CPU - 0.05,
   and the same label sets on >= 0.99 of them after save and load;
3b. times every kernel, its plain version and the nearest single PyTorch
   call at the shapes the main path gave it, on the main path's inputs, as
   device time (the stream held until the host has queued every timed
   call); B1, B6 and B7 also at bert-base [32, 512], B6 and B7 with their
   achieved TFLOP/s and the bound's share of their time; B4 also at the
   production classifier's width [256, 33,280] x [1,024, 33,280] (B4 and
   B5 bounded by their three TF32 products a pair); B1, B2, B3, B4,
   B5, B6, B7, B8 and B9 with the registers, shared bytes, blocks per SM
   and spill bytes of the instantiation that ran (B4 with its splits of
   the contraction);
5. prints the ``kernels`` JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Each phase prints its seconds; phases 4, 4i, 4a, 6, 6i, 6m, 6s, 6l, 7, 8, 9 and
10-13 zero the launch counts just before each step and read them just after.
Timings of ``predict_batch`` (phases 4, 4i and 8) are cold, the embedding
caches cleared before each call, so that every call runs the encoder; a
warm figure, served from the device cache, is printed beside them under
its own name, and phase 4's plain-attention agreement clears the caches
first.  B9 has no caller
on any path (in the JAX package too); it is held in phase 3 and timed in
3b, and the ``kernels`` line gives it 0 main-path launches.

Exits non-zero, without the last line, if there is no CUDA device, if the
package is not beside this file, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense): device memory rate, bf16 and int8
#: tensor-core rates, and the f32 rate outside the tensor cores (TF32 is
#: off here)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
#: the dense TF32 tensor-core rate, for B4's and B5's split product (three
#: TF32 products for each f32 one: their operations bound)
PEAK_TF32_FLOPS = 495e12

#: zoo classifiers the main path serves (checkpoints/zoo/<task>)
TASKS = ("banking-intents", "hallucination-detector")


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def qkv_inputs(seed, dtype, B, S, H, Dh, lengths=None, masked_rows=()):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * Dh), generator=g, device="cuda").to(dtype)
    if lengths is None:
        lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
        lengths[0] = S
    mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    for r in masked_rows:
        mask[r] = 0
    return qkv, mask


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    cos = (torch.sum(g * w) / (g.norm() * w.norm())).item()
    finite = bool(torch.isfinite(g).all().item())
    if dtype == torch.float32:
        ok = finite and err <= 1e-4
    else:
        ok = finite and err <= 0.05 and cos > 0.999
    return {"max_abs_err": err, "cosine": cos, "finite": finite, "ok": ok}


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queue_ahead: bool = False) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events.  With
    ``queue_ahead`` the stream is first held by a GPU sleep long enough for
    the host to enqueue all ``iters`` calls, so the interval is the device's
    time for them and not the host's launch pace (a kernel wrapper's Python
    costs tens of microseconds a call, more than a short kernel runs)."""
    for _ in range(warmup):
        fn()
    if queue_ahead:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9 * (0.002 + 2 * iters * host_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def top_device_ops(fn, n: int = 10) -> dict:
    """Where one call of ``fn`` spends device time, from ``torch.profiler``:
    the ``n`` kernels with the most device time (ms, and launches), their
    sum, and the device time of all kernels.  Names are the kernels' own
    (the port's hand-written ones are mangled C++ names, cut to 120
    characters)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((us / 1e3, e.count, e.key[:120]))
    kernels.sort(reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    if total <= 0:
        return {"device_ms_total": None,
                "note": "the profiler recorded no device time: not measured"}
    return {"device_ms_total": total,
            "top": [{"ms": ms, "launches": c, "kernel": k} for ms, c, k in kernels[:n]],
            "top_share": sum(ms for ms, _, _ in kernels[:n]) / total}


def kernel_ms(fn, iters: int = 20) -> float:
    """Device time per call of one kernel (or of the plain version or library
    call beside it), the queue filled ahead: phase 3b's timer."""
    return cuda_ms(fn, iters=iters, queue_ahead=True)


def attention_bound(B, S, H, Dh, dtype):
    """Least time for the work: inputs read once, output written once, the
    two products at the card's peak rate for the type."""
    item = torch.tensor([], dtype=dtype).element_size()
    D = H * Dh
    nbytes = B * S * 3 * D * item + B * S * 4 + B * S * D * item
    flops = 4 * B * H * S * S * Dh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention() -> dict:
    """Kernel vs plain version on the card at fixed shapes; raises on any
    disagreement."""
    from adaptive_classifier_tpu_torch.ops.attention_qkv import (
        attention_from_qkv, attention_from_qkv_ref)

    cases = [
        # name, dtype, B, S, H, Dh, fully masked rows
        ("bf16 B=256 S=64", torch.bfloat16, 256, 64, 8, 64, ()),
        ("bf16 B=8 S=512", torch.bfloat16, 8, 512, 8, 64, ()),
        ("f32 B=4 S=128", torch.float32, 4, 128, 8, 64, ()),
        ("f32 fully masked row", torch.float32, 3, 64, 8, 64, (1,)),
        ("bf16 fully masked row", torch.bfloat16, 3, 64, 8, 64, (2,)),
        ("f32 Dh=128 S=72", torch.float32, 3, 72, 4, 128, ()),
        ("bf16 Dh=32 S=40", torch.bfloat16, 5, 40, 6, 32, ()),
        ("f32 Dh=24 S=200", torch.float32, 2, 200, 3, 24, ()),
        # the bf16 forms' edges: one pass over two 64-key tiles (S 128, the
        # hallucination chunk), the 32-key tile with a partial second warp
        # (S 24) and the 64-key tile just past it (S 40; S 17 and 33 are
        # outside B1's S % 8 == 0 envelope), one pass just past one tile
        # (S 72), two passes just past the one-pass rows (S 136), bert-base
        ("bf16 B=64 S=128 one pass", torch.bfloat16, 64, 128, 8, 64, (1,)),
        ("bf16 B=64 S=24", torch.bfloat16, 64, 24, 8, 64, (1,)),
        ("bf16 B=64 S=40", torch.bfloat16, 64, 40, 8, 64, ()),
        ("bf16 B=16 S=72", torch.bfloat16, 16, 72, 8, 64, ()),
        ("bf16 B=8 S=136 two passes", torch.bfloat16, 8, 136, 8, 64, (1,)),
        ("bf16 B=4 S=512 H=12", torch.bfloat16, 4, 512, 12, 64, ()),
    ]
    results = {}
    for i, (name, dtype, B, S, H, Dh, masked) in enumerate(cases):
        qkv, mask = qkv_inputs(i, dtype, B, S, H, Dh, masked_rows=masked)
        got = attention_from_qkv(qkv, mask, H, Dh)
        want = attention_from_qkv_ref(qkv, mask, H, Dh)
        torch.cuda.synchronize()
        res = compare(got, want, dtype)
        res["bit_equal_share"] = (got == want).double().mean().item()
        if masked:
            # a fully masked row is the uniform average of V over all keys
            D = H * Dh
            uni = qkv[masked[0], :, 2 * D:].float().mean(dim=0)
            res["uniform_err"] = (got[masked[0]].float() - uni).abs().max().item()
            res["ok"] = res["ok"] and res["uniform_err"] <= (
                1e-4 if dtype == torch.float32 else 0.05)
        log(f"  check {name}: {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"attention kernel disagrees with plain: {name} {res}")
        results[name] = res
    return results


def time_attention(shapes) -> list:
    """Kernel, plain version and SDPA at the main path's shapes, on the real
    token masks of the run (random q, k, v)."""
    from adaptive_classifier_tpu_torch.ops.attention_qkv import (
        attention_from_qkv, attention_from_qkv_ref, kernel_info)

    rows = []
    for task, (mask_np, H, Dh, dtype) in shapes.items():
        B, S = mask_np.shape
        mask = torch.from_numpy(mask_np).to("cuda")
        qkv, _ = qkv_inputs(100, dtype, B, S, H, Dh,
                            lengths=mask.sum(dim=1))
        got = attention_from_qkv(qkv, mask, H, Dh)
        want = attention_from_qkv_ref(qkv, mask, H, Dh)
        res = compare(got, want, dtype)
        if not res["ok"]:
            raise AssertionError(f"attention kernel disagrees at {task}'s shape: {res}")
        D = H * Dh
        q, k, v = (qkv[..., j * D:(j + 1) * D].view(B, S, H, Dh).transpose(1, 2)
                   for j in range(3))
        bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = kernel_ms(lambda: attention_from_qkv(qkv, mask, H, Dh))
        plain_ms = kernel_ms(lambda: attention_from_qkv_ref(qkv, mask, H, Dh), iters=5)
        library_ms = kernel_ms(lambda: sdpa(q, k, v, attn_mask=bias))
        ms_again = kernel_ms(lambda: attention_from_qkv(qkv, mask, H, Dh))
        bound_ms, bound_by = attention_bound(B, S, H, Dh, dtype)
        row = {"task": task, "shape": [B, S, 3 * D], "dtype": str(dtype),
               "valid_keys": int(mask.sum().item()),
               "max_abs_err": res["max_abs_err"], "cosine": res["cosine"],
               "bit_equal_share": (got == want).double().mean().item(),
               "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "instantiation": kernel_info(qkv, H, Dh)}
        log(f"  time {json.dumps(row)}")
        rows.append(row)
    return rows


def head_views(qkv, H, Dh):
    """q, k, v as ``[B, S, H, Dh]`` views of a packed ``[B, S, 3D]`` tensor,
    as the encoder passes them to B6 and B7 (no copy)."""
    D = H * Dh
    return [qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3)]


FLASH_TOLERANCE = ("f32: max abs err <= 1e-4 (TF32 off); bf16: max abs err <= 0.05 "
                   "and cosine > 0.999; a fully masked row is the uniform average of V")


def check_flash() -> dict:
    """B6 at S in {32, 128, 512, 1024, 2048} and B7 at S in {32, 128, 512},
    H 8 and 12, Dh 64, f32 and bf16; then both in bf16 at S 17 (a row that
    is no multiple of the tensor-core tiles) and at Dh 128; ragged masks
    with batch row 1 fully masked, against their plain versions; raises on
    any disagreement."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    out = {"flash_attention": [], "oneshot_attention": []}
    batch = {32: 16, 128: 8, 512: 4, 1024: 2, 2048: 2}
    cases = [(name, batch[S], S, H, 64, dtype) for name in out for S in batch
             for H in (8, 12) for dtype in (torch.float32, torch.bfloat16)
             if name == "flash_attention" or S <= 512]
    cases += [(name, B, S, H, Dh, torch.bfloat16) for name in out
              for B, S, H, Dh in ((16, 17, 8, 64), (4, 200, 4, 128))]
    for i, (name, B, S, H, Dh, dtype) in enumerate(cases):
        qkv, mask = qkv_inputs(200 + i, dtype, B, S, H, Dh, masked_rows=(1,))
        q, k, v = head_views(qkv, H, Dh)
        got = getattr(fa, name)(q, k, v, mask)
        want = getattr(fa, name + "_ref")(q, k, v, mask)
        torch.cuda.synchronize()
        res = {"case": f"{str(dtype).split('.')[-1]} B={B} S={S} H={H} Dh={Dh}",
               **compare(got, want, dtype)}
        uni = v[1].float().mean(dim=0)
        res["uniform_err"] = (got[1].float() - uni).abs().max().item()
        res["ok"] = res["ok"] and res["uniform_err"] <= (
            1e-4 if dtype == torch.float32 else 0.05)
        log(f"  check {name} {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"{name} kernel disagrees with plain: {res}")
        out[name].append(res)
    return out


def bf16_step(w: torch.Tensor) -> torch.Tensor:
    """One bf16 step (unit in the last place) at the magnitude of ``w``,
    taken at 2^-7 for smaller values: there the two f32 results' absolute
    difference (~1e-6, from sums of O(1) values in another order) exceeds a
    step, so a near-zero output can round to neighbours many steps apart."""
    return 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -7))) - 7)


def ln_inputs(seed, M, D, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r = ((2.0 * torch.randn((M, D), generator=g, device="cuda") + 0.3).to(dtype)
            for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    return x, r, scale, bias


def ln_compare(got, want, dtype) -> dict:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    finite = bool(torch.isfinite(g).all().item())
    if dtype == torch.float32:
        ok = err <= 1e-5
    else:
        ok = bool(((g - w).abs() <= bf16_step(w)).all().item())
    return {"max_abs_err": err, "finite": finite, "ok": ok and finite}


LN_TOLERANCE = ("f32: max abs err <= 1e-5; bf16: every value within one bf16 step "
                "(the step at 2^-7 for smaller values)")


def check_layernorm() -> list:
    """B10 at M 8,192, 32,768 and a ragged 1,000 rows, D 512, f32 and bf16,
    against its plain version; raises on any disagreement."""
    from adaptive_classifier_tpu_torch.ops import layernorm as ln

    out = []
    for i, (dtype, M) in enumerate((d, m) for d in (torch.float32, torch.bfloat16)
                                   for m in (8192, 32768, 1000)):
        x, r, scale, bias = ln_inputs(300 + i, M, 512, dtype)
        got = ln.add_layer_norm(x, r, scale, bias, 1e-12)
        want = ln.add_layer_norm_ref(x, r, scale, bias, 1e-12)
        torch.cuda.synchronize()
        res = {"case": f"{str(dtype).split('.')[-1]} M={M}", **ln_compare(got, want, dtype)}
        log(f"  check add_layer_norm {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"add_layer_norm kernel disagrees with plain: {res}")
        out.append(res)
    return out


def sdpa_backend(q, k, v, bias) -> str:
    """The backend one default SDPA call takes on these inputs: the first of
    PyTorch's priority order that accepts them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    order = getattr(torch._C, "_get_sdp_priority_order", None)
    backends = ([SDPBackend(i) for i in order()] if order is not None else
                [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.MATH])
    for b in backends:
        if b.name in ("ERROR", "OVERRIDEABLE"):
            continue
        try:
            with sdpa_kernel([b]):
                sdpa(q, k, v, attn_mask=bias)
            return b.name
        except RuntimeError:
            continue
    return "none accepted the inputs"


def time_flash(shapes: dict) -> dict:
    """B6 and B7, their plain versions and SDPA with the additive mask, at
    the main path's shapes (random q, k, v on the run's token masks).  Each
    row adds the achieved rate (the function's 4·B·H·S²·Dh operations over
    the kernel's time), the bound's share of the time, and the launched
    instantiation's registers per thread, shared bytes per block and blocks
    per SM, as the CUDA runtime reports them (the registers are ptxas'
    figure in phase 2's report)."""
    from adaptive_classifier_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_attention": [], "oneshot_attention": []}
    for where, (mask_np, H, Dh, dtype) in shapes.items():
        B, S = mask_np.shape
        mask = torch.from_numpy(np.ascontiguousarray(mask_np)).to("cuda")
        qkv, _ = qkv_inputs(400, dtype, B, S, H, Dh, lengths=mask.sum(dim=1))
        q, k, v = head_views(qkv, H, Dh)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
        backend = sdpa_backend(qt, kt, vt, bias)
        library_ms = kernel_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias))
        bound_ms, bound_by = attention_bound(B, S, H, Dh, dtype)
        for name in rows:
            kernel = getattr(fa, name)
            plain = getattr(fa, name + "_ref")
            res = compare(kernel(q, k, v, mask), plain(q, k, v, mask), dtype)
            if not res["ok"]:
                raise AssertionError(f"{name} disagrees at {where}'s shape: {res}")
            row = {"where": where, "shape": [B, S, H, Dh], "dtype": str(dtype),
                   "valid_keys": int(mask.sum().item()),
                   "max_abs_err": res["max_abs_err"], "cosine": res["cosine"],
                   "ms": kernel_ms(lambda: kernel(q, k, v, mask)),
                   "plain_ms": kernel_ms(lambda: plain(q, k, v, mask), iters=5),
                   "library_ms": library_ms,
                   "library_call": f"F.scaled_dot_product_attention, additive mask "
                                   f"({backend})",
                   "bound_ms": bound_ms, "bound_by": bound_by}
            row["ms_repeat"] = kernel_ms(lambda: kernel(q, k, v, mask))
            row["tflops"] = 4 * B * H * S * S * Dh / (row["ms"] * 1e-3) / 1e12
            row["bound_share"] = bound_ms / row["ms"]
            row["instantiation"] = fa.kernel_info(q, k, v, name == "oneshot_attention")
            log(f"  time {name} {json.dumps(row)}")
            rows[name].append(row)
    return rows


def ln_bound(M, D, dtype):
    """Least time for B10: x and resid read and the output written once,
    the two f32 vectors read once, over the card's memory rate (its ~8·M·D
    f32 operations take a tenth of that at the f32 peak)."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (3 * M * D * item + 8 * D) / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * M * D / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_layernorm(chunks: dict) -> list:
    """B10, its plain version and F.layer_norm(x + r) at the zoo's chunk
    shapes (M rows of D 512, bf16)."""
    from adaptive_classifier_tpu_torch.ops import layernorm as ln

    rows = []
    for where, M in chunks.items():
        x, r, scale, bias = ln_inputs(500, M, 512, torch.bfloat16)
        res = ln_compare(ln.add_layer_norm(x, r, scale, bias, 1e-12),
                         ln.add_layer_norm_ref(x, r, scale, bias, 1e-12), torch.bfloat16)
        if not res["ok"]:
            raise AssertionError(f"add_layer_norm disagrees at {where}'s shape: {res}")
        row = {"where": where, "M": M, "D": 512, "dtype": "bfloat16",
               "max_abs_err": res["max_abs_err"],
               "ms": kernel_ms(lambda: ln.add_layer_norm(x, r, scale, bias, 1e-12)),
               "plain_ms": kernel_ms(lambda: ln.add_layer_norm_ref(x, r, scale, bias,
                                                                 1e-12)),
               "library_ms": kernel_ms(lambda: torch.nn.functional.layer_norm(
                   x + r, (512,), scale.to(x.dtype), bias.to(x.dtype), 1e-12)),
               "library_call": "F.layer_norm(x + r): two calls (the add, then the "
                               "norm; bf16 scale and bias)"}
        row["ms_repeat"] = kernel_ms(lambda: ln.add_layer_norm(x, r, scale, bias, 1e-12))
        row["bound_ms"], row["bound_by"] = ln_bound(M, 512, torch.bfloat16)
        log(f"  time add_layer_norm {json.dumps(row)}")
        rows.append(row)
    return rows


def unit_rows(r, shape):
    x = r.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def knn_inputs(seed, B, C, D, valid="all", near=False):
    """Unit-norm queries and prototypes (the real domain: d² in [0, 4]).
    ``near``: each query a near duplicate of a random prototype, ``p_c +
    1e-3·noise`` renormalised (d² ~ 1e-6, where an error in d² reaches the
    output one for one)."""
    r = np.random.default_rng(seed)
    v = {"all": np.ones(C, bool), "none": np.zeros(C, bool),
         "mixed": r.random(C) < 0.5}[valid]
    q, p = unit_rows(r, (B, D)), unit_rows(r, (C, D))
    if near:
        q = p[r.integers(0, C, B)] + 1e-3 * q
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (torch.from_numpy(q).cuda(), torch.from_numpy(p).cuda(),
            torch.from_numpy(v).cuda())


def knn_splits(B, C, D) -> int:
    """The splits of B4's contraction that its wrapper picks on this card."""
    from adaptive_classifier_tpu_torch.ops import knn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return knn.sims_splits(B, C, D, knn.sims_info(), sms)[0]


def planted_topk_inputs(seed, B, C, D, k, bias=False, valid_per_query=None,
                        none_valid=False, dup=False):
    """Top-k inputs with no near-ties among each query's winners: query b's
    k+1 nearest prototypes sit at distances growing with t (noise
    orthogonal to the query), every other prototype is random (similarity
    ~0.14).  ``bias``: random {0, -0.3} on the others, 0 on the nearer half
    of the planted ones and -0.3 on the farther half.  ``valid_per_query``:
    only that many planted prototypes per query are valid.  ``dup``: query
    0's nearest prototype is copied onto two free slots (exact ties).
    → (q, p, valid, bias or None, expected order of the tie or None)."""
    r = np.random.default_rng(seed)
    q = unit_rows(r, (B, D))
    p = unit_rows(r, (C, D))
    m = k + 1
    planted = r.permutation(C)[:B * m].reshape(B, m)
    t = np.linspace(0.2, 1.2, m)[:, None]
    for b in range(B):
        n = r.standard_normal((m, D))
        n -= (n @ q[b])[:, None] * q[b][None, :]
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        x = q[b] + t * n
        p[planted[b]] = x / np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(C, bool)
    if valid_per_query is not None:
        valid[:] = False
        valid[planted[:, :valid_per_query].reshape(-1)] = True
    if none_valid:
        valid[:] = False
    tie = None
    if dup:
        free = np.setdiff1d(np.arange(C), planted.reshape(-1))
        p[free[0]] = p[free[-1]] = p[planted[0, 0]]
        tie = sorted([int(planted[0, 0]), int(free[0]), int(free[-1])])
    b = None
    if bias:
        b = (-0.3 * r.integers(0, 2, C)).astype(np.float32)
        b[planted[:, :m // 2]] = 0.0
        b[planted[:, m // 2:]] = -0.3
    cuda = lambda a: None if a is None else torch.from_numpy(a).cuda()
    return cuda(q), cuda(p), cuda(valid), cuda(b), tie


def check_knn() -> dict:
    """Kernels B4 and B5 against their plain versions on the card; raises
    on any disagreement."""
    from adaptive_classifier_tpu_torch.ops import knn, knn_topk

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    out = {"knn_sims": [], "knn_topk": []}
    for name, (B, C, D, valid, near) in {
        "split [256,512]x[1024,512]": (256, 1024, 512, "all", False),
        "recalibration [2048,512]x[1024,512]": (2048, 1024, 512, "all", False),
        "[256,512]x[16384,512]": (256, 16384, 512, "all", False),
        "[3,33280]x[1000,33280]": (3, 1000, 33280, "all", False),
        "ragged [250,500]x[1021,500]": (250, 1021, 500, "mixed", False),
        "all invalid [64,512]x[600,512]": (64, 600, 512, "none", False),
        "mixed valid [100,512]x[2000,512]": (100, 2000, 512, "mixed", False),
        "near-duplicate [256,512]x[1024,512]": (256, 1024, 512, "all", True),
        "near-duplicate [256,33280]x[1024,33280]": (256, 1024, 33280, "all", True),
    }.items():
        q, p, v = knn_inputs(len(out["knn_sims"]), B, C, D, valid, near)
        got = knn.masked_sims_cuda(q, p, v)
        want = knn.masked_sims_ref(q, p, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        res = {"case": name, "splits": knn_splits(B, C, D), "max_abs_err": err,
               "finite": bool(torch.isfinite(got).all().item())}
        res["ok"] = res["finite"] and err <= 1e-5
        if near:    # the near duplicates are there: similarities ~1
            res["max_sim"] = want.max().item()
            res["ok"] = res["ok"] and res["max_sim"] > 0.999
        log(f"  check knn_sims {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"knn_sims kernel disagrees with plain: {res}")
        out["knn_sims"].append(res)
    for name, (B, C, k, kw) in {
        "k=5 C=16384": (256, 16384, 5, {}),
        "k=1 C=16385 bias": (256, 16385, 1, {"bias": True}),
        "k=128 C=16384 bias": (64, 16384, 128, {"bias": True}),
        "k=5 C=16385": (32, 16385, 5, {}),
        "k=20 fewer valid (12)": (4, 16385, 20, {"valid_per_query": 3}),
        "k=5 none valid": (8, 16384, 5, {"none_valid": True}),
        "k=6 exact ties": (16, 16384, 6, {"dup": True}),
        "B=100 (ragged query tile) k=5 bias": (100, 16384, 5, {"bias": True}),
        "k=128 C=20000 B=70 bias": (70, 20000, 128, {"bias": True}),
        "D=500 k=7": (33, 5000, 7, {"D": 500}),
        "D=510 (padded rows) k=7 bias": (33, 5000, 7, {"D": 510, "bias": True}),
    }.items():
        kw = dict(kw)
        q, p, v, b, tie = planted_topk_inputs(3, B, C, kw.pop("D", 512), k, **kw)
        vals, idx = knn_topk.topk_sims_cuda(q, p, v, k, bias=b)
        want_v, want_i = knn_topk.topk_sims_ref(q, p, v, k, bias=b)
        scores, sidx = knn_topk.topk_scores_fused(q, p, v, k, bias=b)
        torch.cuda.synchronize()
        err = (vals - want_v).abs().max().item()
        res = {"case": name, "max_abs_err": err,
               "same_idx": bool(torch.equal(idx, want_i)),
               "finite_scores": bool(torch.isfinite(scores).all().item())}
        res["ok"] = res["same_idx"] and err <= 1e-5 and res["finite_scores"]
        if tie is not None:
            res["tie_order"] = idx[0, :3].tolist()
            res["ok"] = res["ok"] and res["tie_order"] == tie
        if kw.get("none_valid"):
            res["ok"] = res["ok"] and bool((sidx == -1).all()) and bool((scores == 0).all())
        log(f"  check knn_topk {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"knn_topk kernel disagrees with plain: {res}")
        out["knn_topk"].append(res)
    return out


def knn_bound(B, C, D, k=None):
    """Least time for B4 (k None) or B5: inputs read once (queries,
    prototypes, the validity bytes and for B5 the bias), outputs written
    once ([B, C] f32, or [B, k] values and indices), against the
    operations both kernels do: each f32 product as three TF32 ones on the
    tensor cores, 3·2·B·C·D FLOP at the dense TF32 rate."""
    if k is None:
        nbytes = 4 * (B * D + C * D + B * C) + C
    else:
        nbytes = 4 * (B * D + C * D + C) + C + 8 * B * k
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * B * C * D / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_knn(shapes: dict) -> dict:
    """B4 and B5, their plain versions and the nearest single PyTorch call,
    on inputs the main path gave them."""
    from adaptive_classifier_tpu_torch.ops import knn, knn_topk

    rows = {"knn_sims": [], "knn_topk": []}
    for name, (q, p, v) in shapes["knn_sims"].items():
        B, D = q.shape
        C = p.shape[0]
        err = (knn.masked_sims_cuda(q, p, v) - knn.masked_sims_ref(q, p, v)).abs().max().item()
        info = knn.sims_info()
        row = {"shape": name, "B": B, "C": C, "D": D, "max_abs_err": err,
               "ms": kernel_ms(lambda: knn.masked_sims_cuda(q, p, v)),
               "plain_ms": kernel_ms(lambda: knn.masked_sims_ref(q, p, v)),
               # nearest single call: returns d, not exp(-d²)
               "library_ms": kernel_ms(lambda: torch.cdist(q, p)),
               "library_call": "torch.cdist",
               "bound_ops": "3xTF32", "splits": knn_splits(B, C, D),
               "blocks_per_sm": info["blocks_per_sm"], "instantiation": info}
        row["bound_ms"], row["bound_by"] = knn_bound(B, C, D)
        log(f"  time knn_sims {json.dumps(row)}")
        if err > 1e-5:
            raise AssertionError(f"knn_sims kernel disagrees with plain: {row}")
        rows["knn_sims"].append(row)
    for name, (q, p, v, b, k) in shapes["knn_topk"].items():
        B, D = q.shape
        C = p.shape[0]
        vals, idx = knn_topk.topk_sims_cuda(q, p, v, k, bias=b)
        want_v, want_i = knn_topk.topk_sims_ref(q, p, v, k, bias=b)
        row = {"shape": name, "B": B, "C": C, "D": D, "k": k,
               "max_abs_err": (vals - want_v).abs().max().item(),
               "same_idx_share": (idx == want_i).float().mean().item(),
               "ms": kernel_ms(lambda: knn_topk.topk_sims_cuda(q, p, v, k, bias=b)),
               "plain_ms": kernel_ms(lambda: knn_topk.topk_sims_ref(q, p, v, k, bias=b)),
               "library_ms": None, "bound_ops": "3xTF32",
               "instantiation": knn_topk.topk_info(k)}
        row["bound_ms"], row["bound_by"] = knn_bound(B, C, D, k)
        log(f"  time knn_topk {json.dumps(row)}")
        if row["max_abs_err"] > 1e-5:
            raise AssertionError(f"knn_topk kernel disagrees with plain: {row}")
        rows["knn_topk"].append(row)
    return rows


def int8_weights(seed, D=512, F=2048):
    """Random int8 weights at widths D, F (by default the zoo's), quantized
    as the port quantizes a checkpoint: O [D, D], QKV [D, 3D], W1 [D, F], W2 [F, D],
    each with its per-column scale and a bias; two LayerNorms."""
    from adaptive_classifier_tpu_torch.quantization import quantize_weight

    r = np.random.default_rng(seed)

    def vec(n, loc=0.0, scale=0.01):
        return torch.from_numpy((loc + scale * r.standard_normal(n)).astype(np.float32)).cuda()

    mats = {}
    for name, shape in (("o", (D, D)), ("qkv", (D, 3 * D)), ("w1", (D, F)), ("w2", (F, D))):
        q, sc = quantize_weight(torch.from_numpy(
            (r.standard_normal(shape) * 0.05).astype(np.float32)))
        mats[name] = (q.cuda(), sc.cuda(), vec(shape[1]))
    lns = [(vec(D, 1.0, 0.1), vec(D, 0.0, 0.1)) for _ in range(2)]
    return mats, lns


def int8_rows(seed, M, D, dtype, n=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(0.5 * torch.randn((M, D), generator=g, device="cuda")).to(dtype)
            for _ in range(n)]


def int8_calls(mats, lns, rows):
    """name → (kernel call, plain call, the products alone on the quantized
    operands with torch._int_mm), for B2, B3, B9 and B8 on ``rows``."""
    from adaptive_classifier_tpu_torch.ops import ffn_int8 as f8, matmul_int8 as m8

    x, y = rows
    qx = m8.quant_rows(x.float(), divide=False)[0]
    w1, w2 = mats["w1"][0], mats["w2"][0]
    qf = torch.randint(-127, 128, (x.shape[0], w1.shape[1]), dtype=torch.int8,
                       device="cuda")
    b2 = (x, *mats["qkv"])
    b3 = (x, *mats["w1"], *mats["w2"], *lns[0], 1e-12)
    b9 = (x, *mats["o"], y, *lns[0], 1e-12)
    b8 = (x, y, *mats["o"], *lns[0], *mats["w1"], *mats["w2"], *lns[1], 1e-12)
    mm = torch._int_mm
    return {
        "matmul_int8": (lambda: m8.quant_matmul_int8(*b2),
                        lambda: m8.quant_matmul_int8_ref(*b2),
                        lambda: mm(qx, mats["qkv"][0])),
        "ffn_int8": (lambda: f8.ffn_block_int8(*b3), lambda: f8.ffn_block_int8_ref(*b3),
                     lambda: (mm(qx, w1), mm(qf, w2))),
        "proj_residual_ln_int8": (lambda: m8.proj_residual_ln_int8(*b9),
                                  lambda: m8.proj_residual_ln_int8_ref(*b9),
                                  lambda: mm(qx, mats["o"][0])),
        "attn_ffn_int8": (lambda: f8.attn_ffn_block_int8(*b8),
                          lambda: f8.attn_ffn_block_int8_ref(*b8),
                          lambda: (mm(qx, mats["o"][0]), mm(qx, w1), mm(qf, w2))),
    }


def int8_compare(name, got, want, dtype) -> dict:
    """B2 f32: max abs error <= 1e-5; B9 f32: <= 1e-4; B3, B8 f32 (a
    requantized GELU): per-row cosine >= 0.9999 and max abs error <= 0.05;
    bf16: cosine > 0.999."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    cos = (torch.sum(g * w) / (g.norm() * w.norm())).item()
    row_cos = ((g * w).sum(1) / (g.norm(dim=1) * w.norm(dim=1))).min().item()
    finite = bool(torch.isfinite(g).all().item())
    if dtype == torch.bfloat16:
        ok = cos > 0.999
    elif name == "matmul_int8":
        ok = err <= 1e-5
    elif name == "proj_residual_ln_int8":
        ok = err <= 1e-4
    else:
        ok = row_cos >= 0.9999 and err <= 0.05
    return {"max_abs_err": err, "cosine": cos, "min_row_cosine": row_cos,
            "bit_equal_share": (got == want).double().mean().item(),
            "finite": finite, "ok": ok and finite}


INT8_TOLERANCE = {
    "matmul_int8": "f32 max abs err <= 1e-5; bf16 cosine > 0.999",
    "proj_residual_ln_int8": "f32 max abs err <= 1e-4; bf16 cosine > 0.999",
    "ffn_int8": "f32 per-row cosine >= 0.9999 and max abs err <= 0.05; bf16 cosine > 0.999",
    "attn_ffn_int8": "f32 per-row cosine >= 0.9999 and max abs err <= 0.05; "
                     "bf16 cosine > 0.999",
}


#: (D, F) of the int8 checks: the zoo's widths (64-row blocks of B3 and B8)
#: and bert-base's (32-row blocks)
INT8_WIDTHS = ((512, 2048), (768, 3072))


def check_int8() -> dict:
    """B2, B3, B9 and B8 against their plain versions at the zoo's widths
    (D 512, F 2048: M = 8,192, a banking chunk, and a ragged M) and at
    bert-base's (D 768, F 3,072: M = 16,384, a B = 32, S = 512 batch, and a
    ragged M), f32 and bf16; raises on any disagreement.  → results and the
    launches made."""
    import adaptive_classifier_tpu_torch as port

    out = {name: [] for name in INT8_TOLERANCE}
    port.reset_launch_counts()
    for D, F in INT8_WIDTHS:
        mats, lns = int8_weights(0, D, F)
        big = 8192 if D == 512 else 16384
        # big + 37: ragged for the 64-row (D 512) and 32-row (D 768) blocks
        for dtype, M in ((torch.float32, big), (torch.float32, 1000),
                         (torch.bfloat16, big), (torch.bfloat16, 200),
                         (torch.bfloat16, big + 37), (torch.float32, big + 37)):
            calls = int8_calls(mats, lns, int8_rows(M, M, D, dtype))
            for name, (kernel, plain, _) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                res = {"case": f"{str(dtype).split('.')[-1]} M={M} D={D} F={F}",
                       **int8_compare(name, got, want, dtype)}
                log(f"  check {name} {json.dumps(res)}")
                if not res["ok"]:
                    raise AssertionError(f"{name} kernel disagrees with plain: {res}")
                out[name].append(res)
        del mats, lns, calls
        torch.cuda.empty_cache()
    return {"results": out, "launches": dict(port.launch_counts)}


def int8_bound(name, M, dtype, D=512, F=2048):
    """Least time for an int8 kernel: rows in and out at the activation
    type, int8 weights and f32 vectors read once, against its products at
    the int8 tensor-core peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    if name == "matmul_int8":
        nbytes = M * D * item + D * 3 * D + 8 * 3 * D + M * 3 * D * item
        ops = 2 * M * D * 3 * D
    elif name == "proj_residual_ln_int8":
        nbytes = 3 * M * D * item + D * D + 16 * D
        ops = 2 * M * D * D
    elif name == "ffn_int8":
        nbytes = 2 * M * D * item + 2 * D * F + 8 * F + 16 * D
        ops = 4 * M * D * F
    else:   # attn_ffn_int8; its f32 scratch for LayerNorm 1's rows is the
            # kernel's choice, not the function's work: not counted
        nbytes = 3 * M * D * item + D * D + 2 * D * F + 8 * F + 32 * D
        ops = 2 * M * D * (D + 2 * F)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.int8] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_int8(chunks: dict) -> dict:
    """The four int8 kernels, their plain versions and the products alone
    (torch._int_mm on the quantized operands) at the main path's chunk
    shapes (name → (M, D, F)), bf16 rows; every kernel result is held to its
    plain version."""
    rows = {name: [] for name in INT8_TOLERANCE}
    weights = {}
    for task, (M, D, F) in chunks.items():
        if (D, F) not in weights:
            weights[(D, F)] = int8_weights(1, D, F)
        calls = int8_calls(*weights[(D, F)], int8_rows(7, M, D, torch.bfloat16))
        for name, (kernel, plain, library) in calls.items():
            res = int8_compare(name, kernel(), plain(), torch.bfloat16)
            if not res["ok"]:
                raise AssertionError(f"{name} disagrees at {task}'s shape: {res}")
            row = {"task": task, "M": M, "D": D, "F": F, "dtype": "bfloat16",
                   "max_abs_err": res["max_abs_err"], "cosine": res["cosine"],
                   "ms": kernel_ms(kernel), "plain_ms": kernel_ms(plain, iters=5),
                   "library_ms": kernel_ms(library),
                   "library_call": "torch._int_mm on the quantized operands "
                                   "(the int8 products alone)"}
            row["ms_repeat"] = kernel_ms(kernel)
            row["bound_ms"], row["bound_by"] = int8_bound(name, M, torch.bfloat16, D, F)
            if name in ("ffn_int8", "attn_ffn_int8"):
                from adaptive_classifier_tpu_torch.ops.ffn_int8 import ffn_block_info

                row["instantiation"] = ffn_block_info(D, F, o_proj=name == "attn_ffn_int8")
            elif name == "matmul_int8":
                from adaptive_classifier_tpu_torch.ops.matmul_int8 import quant_matmul_info

                row["instantiation"] = quant_matmul_info(M, D, 3 * D)
            else:
                from adaptive_classifier_tpu_torch.ops.matmul_int8 import (
                    proj_residual_ln_info)

                row["instantiation"] = proj_residual_ln_info(M, D)
            log(f"  time {name} {json.dumps(row)}")
            rows[name].append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def task_rows(task: str):
    """(texts, labels) of a zoo task's test split, built as
    scripts/build_classifier_zoo.py builds them."""
    data = REPO / "data"
    if task == "banking-intents":
        intents = json.loads((data / "intents.json").read_text())
        rows = [(t, lbl) for lbl in intents["train"] for t in intents["test"][lbl]]
    elif task == "hallucination-detector":
        halluc = json.loads((data / "hallucination.json").read_text())
        rows = [(f"Context: {d['context']}\nQuestion: {d.get('question', '')}\n"
                 f"Answer: {d['response']}",
                 "HALLUCINATED" if d["label"] == "HALLUCINATED" else "NOT_HALLUCINATED")
                for d in halluc["test"]]
    else:
        raise KeyError(task)
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def parent_linear(x, w, b):
    """The float forward's linear layer as the parent commit had it: the
    product rounded to the compute dtype, then the f32 bias (the caller
    rounds again).  Phase 4 times the forward with it, in turns with the
    current ``_linear``."""
    return torch.matmul(x, w.to(x.dtype)).float() + b.float()


def check_linear() -> dict:
    """The float forward's linear layers on the card (``_linear``, and
    ``_linear_gelu`` for the FFN's first) against the JAX package's order
    computed on the CPU: exact products of the bf16 operands, f32 sums, the
    f32 bias (and GELU), one rounding.  Raises unless at least 99% of the
    bf16 outputs of a [4096, 512] x [512, 1536] projection equal it bit for
    bit; reports the parent's share beside it."""
    import torch.nn.functional as F

    from adaptive_classifier_tpu_torch.models import encoder as enc

    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((4096, 512)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.05 * r.standard_normal((512, 1536))).astype(np.float32)).bfloat16()
    b = torch.from_numpy((0.1 * r.standard_normal(1536)).astype(np.float32))
    xc, wc, bc = x.cuda(), w.cuda(), b.cuda()
    out = {"torch": torch.__version__}
    gelu = lambda y: F.gelu(y, approximate="none")
    for name, layer, parent in (("linear", enc._linear, parent_linear),
                                ("linear_gelu", enc._linear_gelu,
                                 lambda *a: gelu(parent_linear(*a)))):
        want = layer(x, w, b).bfloat16()
        got = layer(xc, wc, bc).bfloat16().cpu()
        old = parent(xc, wc, bc).bfloat16().cpu()
        out[name] = {"equal_share": (got == want).double().mean().item(),
                     "parent_equal_share": (old == want).double().mean().item(),
                     "max_abs_err": (got.float() - want.float()).abs().max().item()}
    log(f"  check linear {json.dumps(out)}")
    for name in ("linear", "linear_gelu"):
        if not out[name]["equal_share"] >= 0.99:
            raise AssertionError(f"{name} rounds unlike the JAX order: {out[name]}")
    return out


def predict_batch_seconds(clf, texts, k: int, cold: bool = True, reps: int = 3) -> float:
    """The least of ``reps`` timed ``predict_batch`` calls.  Cold: the
    embedding caches cleared before each call (every call runs the
    encoder); warm: one untimed call first, then the device cache serves
    every row."""
    if not cold:
        clf.predict_batch(texts, k=k)
    times = []
    for _ in range(reps):
        if cold:
            clf._clear_embedding_caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.predict_batch(texts, k=k)
        times.append(time.perf_counter() - t0)
    return min(times)


def run_task(task: str, manifest: dict, gpu: str) -> dict:
    import adaptive_classifier_tpu_torch as port

    texts, labels = task_rows(task)
    t0 = time.perf_counter()
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints" / "zoo" / task, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = clf.encoder.config
    chunk = max(clf.config.embed_chunk_size, 64)
    n_chunks = math.ceil(len(texts) / chunk)
    layers = cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers

    # the main path, with the launch counts zeroed just before and read just after
    port.reset_launch_counts()
    t0 = time.perf_counter()
    preds = clf.predict_batch(texts, k=1)
    first_s = time.perf_counter() - t0
    launches = dict(port.launch_counts)

    if launches["attention_qkv"] != layers * n_chunks:
        raise AssertionError(f"{task}: attention kernel launched "
                             f"{launches['attention_qkv']} times, expected "
                             f"{layers} layers x {n_chunks} chunks")
    from adaptive_classifier_tpu_torch.models.encoder import _FUSED_LN_ON_CUDA

    want_ln = 2 * layers * n_chunks if _FUSED_LN_ON_CUDA else 0
    if launches["add_layer_norm"] != want_ln:
        raise AssertionError(f"{task}: add_layer_norm launched "
                             f"{launches['add_layer_norm']} times, expected {want_ln}")
    top1 = [p[0][0] if p else None for p in preds]
    acc = float(np.mean([p == y for p, y in zip(top1, labels)]))
    floor = manifest["classifiers"][task]["expected_accuracy"] - 0.03
    if not acc >= floor:
        raise AssertionError(f"{task}: top-1 accuracy {acc:.4f} < {floor:.4f}")

    # cold: the embedding caches cleared before each call, so every call
    # runs the encoder; warm: the same texts again, served from the device
    # cache
    batch_s = predict_batch_seconds(clf, texts, k=1)
    warm_s = predict_batch_seconds(clf, texts, k=1, cold=False)

    # host share: tokenization and lexical features of the same chunks
    t0 = time.perf_counter()
    for s in range(0, len(texts), chunk):
        clf._tokenize_chunk(texts[s:s + chunk], chunk)
    host_s = time.perf_counter() - t0
    ids, mask = clf.encoder.tokenizer(
        texts[:chunk] + [""] * max(0, chunk - len(texts)),
        max_length=clf.config.max_length, pad_to_buckets=clf.encoder.SEQ_BUCKETS)
    # device share: the encoder forward alone on the first chunk
    encoder_ms = cuda_ms(lambda: clf.encoder.embed_ids(ids, mask), iters=10)
    # the same forward with the parent's linear layers (two roundings), in turns
    from adaptive_classifier_tpu_torch.models import encoder as enc_mod

    linear_ab = []
    for which in ("parent", "current", "current", "parent"):
        with (mock.patch.object(enc_mod, "_linear", parent_linear) if which == "parent"
              else contextlib.nullcontext()):
            linear_ab.append([which, cuda_ms(lambda: clf.encoder.embed_ids(ids, mask),
                                             iters=10)])
    # and where its device time goes, on the longer chunk
    ops = (top_device_ops(lambda: clf.encoder.embed_ids(ids, mask))
           if task == TASKS[1] else None)

    # the same run through the plain attention (the encoder, not the cache)
    clf._clear_embedding_caches()
    clf.encoder.attn_impl = "einsum"
    plain_top1 = [p[0][0] if p else None
                  for p in clf.predict_batch(texts, k=1)]
    clf.encoder.attn_impl = None
    agree = float(np.mean([a == b for a, b in zip(top1, plain_top1)]))
    if not agree >= 0.99:
        raise AssertionError(f"{task}: kernel and plain attention agree on "
                             f"{agree:.4f} of top-1 labels (< 0.99)")

    out = {"task": task, "rows": len(texts), "chunks": n_chunks,
           "layers": layers, "seq_len": int(ids.shape[1]),
           "launches": launches, "top1_accuracy": acc, "accuracy_floor": floor,
           "agreement_with_plain_attention": agree,
           "load_s": load_s, "first_predict_batch_s": first_s,
           "predict_batch_ms": batch_s * 1e3,
           "requests_per_s": len(texts) / batch_s,
           "predict_batch_ms_warm_cache": warm_s * 1e3,
           "host_tokenize_lexical_ms": host_s * 1e3,
           "encoder_forward_ms": encoder_ms,
           "encoder_forward_ms_parent_vs_current_linear": linear_ab, "gpu": gpu}
    if ops is not None:
        out["encoder_forward_top_device_ops"] = ops
    log(f"  task {json.dumps(out)}")
    shape = (mask, cfg.num_heads, cfg.head_dim, clf.encoder.compute_dtype)
    del clf
    torch.cuda.empty_cache()
    return {"summary": out, "shape": shape, "top1": top1}


#: least top-1 agreement of an int8 zoo classifier with its bf16 forward.
#: Int8 noise flips near-tied rows: the JAX package's own int8 forward
#: agrees with its bf16 forward on 0.9663 of hallucination-detector's test
#: rows and 1.0 of banking-intents' (CPU; tests/test_torch_int8.py
#: test_int8_zoo_agreement_with_float_matches_jax prints both packages')
INT8_AGREEMENT_FLOOR = 0.95


def int8_checkpoint(task: str) -> Path:
    """A copy of a zoo classifier with ``quantization: "int8"`` and its
    encoder named by absolute path, under the git-ignored ``.smoke/``."""
    import shutil

    dst = REPO / ".smoke" / "zoo_int8" / task
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "checkpoints" / "zoo" / task, dst)
    cfg = json.loads((dst / "config.json").read_text())
    cfg["config"]["quantization"] = "int8"
    cfg["model_name"] = str(ENCODER)
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


def row_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def run_fuse_o_proj(enc, ids, mask, layers, launches: "Launches") -> dict:
    """Kernel B8 on a path: one chunk through ``encoder_forward_int8`` with
    ``fuse_o_proj=True`` against the default int8 forward, per embedding
    row (pooled and normalized, one per text).  In f32 the two compute the
    same function up to the LayerNorms' last bits, which move a few
    requantized values by one int8 step per layer: cosine >= 0.999.  In
    bf16 the default forward also rounds the O-projection and the first
    LayerNorm to bf16 (as the JAX package's does) where B8 keeps f32: there
    the int8 envelope, cosine > 0.99.  Token rows are reported, not gated.
    The fused and the default forward of the chunk are timed in turns
    (default, fused, fused, default)."""
    from adaptive_classifier_tpu_torch.models.encoder import pool_and_normalize
    from adaptive_classifier_tpu_torch.models.encoder_int8 import encoder_forward_int8

    ids_t, mask_t = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def fwd(fuse):
            with torch.inference_mode():
                return encoder_forward_int8(enc.params, ids_t, mask_t, enc.config,
                                            compute_dtype=dtype, attn_impl="fusedqkv",
                                            fuse_o_proj=fuse)
        base = fwd(False)
        fused, b8 = launches.run(lambda: fwd(True))
        if b8["attn_ffn_int8"] != layers or b8["ffn_int8"] != 0:
            raise AssertionError(f"fuse_o_proj: B8 launched {b8['attn_ffn_int8']} times, "
                                 f"B3 {b8['ffn_int8']} (expected {layers}, 0)")
        rows = row_cosines(fused, base)
        valid = mask_t.reshape(-1) > 0
        pooled = row_cosines(pool_and_normalize(fused, mask_t, enc.config.pooling),
                             pool_and_normalize(base, mask_t, enc.config.pooling))
        turns = [(fuse, cuda_ms(lambda: fwd(fuse), iters=10))
                 for fuse in (False, True, True, False)]
        res = {"launches": b8, "min_row_cosine": rows.min().item(),
               "min_valid_row_cosine": rows[valid].min().item(),
               "min_pooled_cosine": pooled.min().item(),
               "forward_ms": [ms for fuse, ms in turns if fuse],
               "default_forward_ms": [ms for fuse, ms in turns if not fuse]}
        name = str(dtype).split(".")[-1]
        ok = (res["min_pooled_cosine"] >= 0.999 if dtype == torch.float32
              else res["min_pooled_cosine"] > 0.99)
        if not ok:
            raise AssertionError(f"fuse_o_proj {name}: {res}")
        out[name] = res
    return out


def run_task_int8(task: str, manifest: dict, gpu: str, bf16_top1, float_encoder,
                  launches: "Launches") -> dict:
    """Phase 4i: a zoo classifier served with ``quantization: "int8"``: B2,
    B3 and B1 once per layer per chunk; every embedding within cosine 0.99
    of the bf16 forward's; top-1 accuracy >= manifest - 0.03, as in phase
    4; top-1 agreement with the bf16 path >= INT8_AGREEMENT_FLOOR."""
    import adaptive_classifier_tpu_torch as port
    texts, labels = task_rows(task)
    clf = port.AdaptiveClassifier.load(int8_checkpoint(task), device="cuda")
    enc = clf.encoder
    if enc.quantization != "int8":
        raise AssertionError(f"{task}: the int8 checkpoint resolved to {enc.quantization}")
    cfg = enc.config
    chunk = max(clf.config.embed_chunk_size, 64)
    n_chunks = math.ceil(len(texts) / chunk)
    layers = cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers

    preds, counts = launches.run(lambda: clf.predict_batch(texts, k=1))
    for name in ("matmul_int8", "ffn_int8", "attention_qkv"):
        if counts[name] != layers * n_chunks:
            raise AssertionError(f"{task} int8: {name} launched {counts[name]} times, "
                                 f"expected {layers} layers x {n_chunks} chunks")
    top1 = [p[0][0] if p else None for p in preds]
    acc = float(np.mean([p == y for p, y in zip(top1, labels)]))
    agree = float(np.mean([a == b for a, b in zip(top1, bf16_top1)]))
    if not agree >= INT8_AGREEMENT_FLOOR:
        raise AssertionError(f"{task} int8: top-1 agreement with bf16 {agree:.4f} "
                             f"< {INT8_AGREEMENT_FLOOR}")
    floor = manifest["classifiers"][task]["expected_accuracy"] - 0.03
    if not acc >= floor:
        raise AssertionError(f"{task} int8: top-1 accuracy {acc:.4f} < {floor:.4f}")
    with torch.inference_mode():
        cos = row_cosines(enc.embed(texts), float_encoder.embed(texts))
    if not cos.min().item() > 0.99:
        raise AssertionError(f"{task} int8: embedding cosine with bf16 "
                             f"{cos.min().item():.5f} <= 0.99")
    batch_s = predict_batch_seconds(clf, texts, k=1)

    # the encoder forward of one full chunk: int8 and bf16 in turns
    ids, mask = enc.tokenizer(texts[:chunk] + [""] * max(0, chunk - len(texts)),
                              max_length=clf.config.max_length,
                              pad_to_buckets=enc.SEQ_BUCKETS)
    order = []
    for label, e in (("bf16", float_encoder), ("int8", enc), ("int8", enc),
                     ("bf16", float_encoder)):
        order.append((label, cuda_ms(lambda: e.embed_ids(ids, mask), iters=10)))
    fwd = {lbl: [ms for l, ms in order if l == lbl] for lbl in ("int8", "bf16")}
    ops = top_device_ops(lambda: enc.embed_ids(ids, mask)) if task == TASKS[1] else None

    out = {"task": task, "rows": len(texts), "chunks": n_chunks, "layers": layers,
           "seq_len": int(ids.shape[1]), "chunk_rows": int(ids.shape[0] * ids.shape[1]),
           "launches": counts, "top1_accuracy": acc,
           "manifest_accuracy": manifest["classifiers"][task]["expected_accuracy"],
           "accuracy_floor": floor, "top1_agreement_with_bf16": agree,
           "min_embedding_cosine_with_bf16": cos.min().item(),
           "mean_embedding_cosine_with_bf16": cos.mean().item(),
           "predict_batch_ms": batch_s * 1e3,
           "encoder_forward_ms_int8": fwd["int8"], "encoder_forward_ms_bf16": fwd["bf16"],
           "int8_faster": max(fwd["int8"]) < min(fwd["bf16"]), "gpu": gpu}
    if ops is not None:
        out["encoder_forward_top_device_ops"] = ops

    if task == TASKS[0]:
        out["fuse_o_proj"] = run_fuse_o_proj(enc, ids, mask, layers, launches)
    log(f"  task int8 {json.dumps(out)}")
    out["top1"] = top1
    del clf
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4a: the flash and one-shot attention paths, the fused LayerNorm
# ---------------------------------------------------------------------------

ATTN_KERNELS = {"fusedqkv": "attention_qkv", "flash": "flash_attention",
                "oneshot": "oneshot_attention", "einsum": None}


def run_attn_path(task: str, impl: str, manifest: dict, base_top1, launches: Launches,
                  int8: bool = False) -> dict:
    """A zoo classifier (bf16, or int8 with ``int8``) served with
    ``AC_ATTN_IMPL=impl``: the chosen kernel once per layer per chunk and
    B1 never; top-1 >= manifest - 0.03; top-1 agreement >= 0.99 with the
    same classifier's phase 4 (4i) run; every embedding within cosine
    0.999 of the default path's in bf16.  In int8 the bound is the int8
    envelope, 0.99: each path rounds its bf16 probabilities at another
    place, and the per-row requantization of the attention output turns
    that into int8 steps (0.9986 flash against fusedqkv through the int8
    forward on banking-intents, CPU plain versions)."""
    import adaptive_classifier_tpu_torch as port

    texts, labels = task_rows(task)
    path = int8_checkpoint(task) if int8 else REPO / "checkpoints" / "zoo" / task
    clf = port.AdaptiveClassifier.load(path, device="cuda")
    enc = clf.encoder
    cfg = enc.config
    n_chunks = math.ceil(len(texts) / max(clf.config.embed_chunk_size, 64))
    layers = cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers
    with torch.inference_mode():
        base = enc.embed(texts)
    with mock.patch.dict(os.environ, {"AC_ATTN_IMPL": impl}):
        preds, counts = launches.run(lambda: clf.predict_batch(texts, k=1))
        with torch.inference_mode():
            emb = enc.embed(texts)
    kernel = ATTN_KERNELS[impl]
    if counts[kernel] != layers * n_chunks or counts["attention_qkv"] != 0:
        raise AssertionError(f"{task} {impl}: {kernel} launched {counts[kernel]} times "
                             f"(expected {layers} x {n_chunks}), attention_qkv "
                             f"{counts['attention_qkv']}")
    got = top1(preds)
    acc = float(np.mean([a == b for a, b in zip(got, labels)]))
    agree = float(np.mean([a == b for a, b in zip(got, base_top1)]))
    cos = row_cosines(emb, base)
    floor = manifest["classifiers"][task]["expected_accuracy"] - 0.03
    out = {"task": task, "impl": impl, "quantization": enc.quantization,
           "chunks": n_chunks, "launches": counts, "top1_accuracy": acc,
           "accuracy_floor": floor, "top1_agreement_with_phase_4": agree,
           "min_embedding_cosine": cos.min().item()}
    log(f"  attn path {json.dumps(out)}")
    min_cos = 0.99 if int8 else 0.999
    if not (acc >= floor and agree >= 0.99 and out["min_embedding_cosine"] >= min_cos):
        raise AssertionError(f"{task} {impl}: {out}")
    del clf
    torch.cuda.empty_cache()
    return out


def run_fused_ln(task: str) -> dict:
    """The bf16 encoder forward (``embed_texts_device``) of one full chunk
    of ``task`` with the fused LayerNorm off / on / on / off, the timing
    that sets ``_FUSED_LN_ON_CUDA``: with it on B10 twice per layer, with it
    off never, every embedding within cosine 0.999 of the plain
    LayerNorm's.  (Phase 4 serves the classifiers with B10 on and gates its
    launches per chunk.)"""
    import adaptive_classifier_tpu_torch as port
    from adaptive_classifier_tpu_torch.models.encoder import embed_texts_device

    texts, _ = task_rows(task)
    clf = port.AdaptiveClassifier.load(REPO / "checkpoints" / "zoo" / task, device="cuda")
    enc = clf.encoder
    cfg = enc.config
    chunk = max(clf.config.embed_chunk_size, 64)
    layers = cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers
    ids, mask = enc.tokenizer(texts[:chunk] + [""] * max(0, chunk - len(texts)),
                              max_length=clf.config.max_length,
                              pad_to_buckets=enc.SEQ_BUCKETS)
    impl = enc._attn_impl(ids.shape[1])
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()

    def forward(flag):
        with torch.inference_mode():
            return embed_texts_device(enc.params, ids, mask, cfg, enc.compute_dtype,
                                      attn_impl=impl, use_fused_ln=flag)

    embs = {}
    for flag in (False, True):
        port.reset_launch_counts()
        embs[flag] = forward(flag)
        torch.cuda.synchronize()
        want = 2 * layers if flag else 0
        if port.launch_counts["add_layer_norm"] != want:
            raise AssertionError(f"{task} use_fused_ln={flag}: add_layer_norm launched "
                                 f"{port.launch_counts['add_layer_norm']} times, "
                                 f"expected {want}")
    order = [(flag, cuda_ms(lambda: forward(flag), iters=10))
             for flag in (False, True, True, False)]
    on = [ms for f, ms in order if f]
    off = [ms for f, ms in order if not f]
    out = {"task": task, "chunk_rows": int(ids.shape[0] * ids.shape[1]),
           "attn_impl": impl,
           "min_embedding_cosine": row_cosines(embs[True], embs[False]).min().item(),
           "encoder_forward_ms_fused_ln": on, "encoder_forward_ms_plain_ln": off,
           "fused_faster": max(on) < min(off)}
    log(f"  fused LN {json.dumps(out)}")
    if not out["min_embedding_cosine"] >= 0.999:
        raise AssertionError(f"{task} fused LN: {out}")
    del clf
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the attention A/B at bert-base width, offline weights
# ---------------------------------------------------------------------------

BERT_BASE = "bert-base-uncased"


def run_bert_base(manifest: dict, launches: Launches, gpu: str) -> dict:
    """``Encoder("bert-base-uncased")``: the JAX package's offline numpy-RNG
    weights, 12 layers, hidden 768, 12 heads of 64.  B = 32 random token
    rows, all valid (as scripts/ab_attention.py), S in {64, 128, 512}, bf16
    and int8, through each attention path: the path's kernel 12 times per
    forward, and B2 and B3 (int8) or B10 twice (bf16) 12 times; ms per
    batch (CUDA events), embedding cosine >= 0.999 against ``fusedqkv``.  Then ``AdaptiveClassifier("bert-base-uncased")`` on the
    production config: add_examples on intents' train rows, predict_batch on
    its test rows (random weights: no accuracy gate)."""
    import adaptive_classifier_tpu_torch as port
    from adaptive_classifier_tpu_torch.models.encoder import Encoder

    t0 = time.perf_counter()
    encoders = {"bf16": Encoder(BERT_BASE, device="cuda"),
                "int8": Encoder(BERT_BASE, device="cuda", quantization="int8")}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = encoders["bf16"].config
    r = np.random.default_rng(0)
    rows = []
    for S in (64, 128, 512):
        ids = r.integers(0, cfg.vocab_size, (32, S)).astype(np.int32)
        mask = np.ones((32, S), np.int32)
        for path, enc in encoders.items():
            ref = None
            for impl, kernel in ATTN_KERNELS.items():
                enc.attn_impl = impl
                with torch.inference_mode():
                    emb, counts = launches.run(lambda: enc.embed_ids(ids, mask))
                L = cfg.num_layers
                want = {k: L if name == impl else 0
                        for name, k in ATTN_KERNELS.items() if k is not None}
                want.update({"matmul_int8": L, "ffn_int8": L, "add_layer_norm": 0}
                            if path == "int8" else
                            {"matmul_int8": 0, "ffn_int8": 0, "add_layer_norm": 2 * L})
                got = {k: counts[k] for k in want}
                if got != want:
                    raise AssertionError(f"bert-base {path} S={S} {impl}: launches {got}, "
                                         f"expected {want}")
                ref = emb if ref is None else ref
                row = {"S": S, "B": 32, "path": path, "impl": impl,
                       "ms_per_batch": cuda_ms(lambda: enc.embed_ids(ids, mask), iters=10,
                                               warmup=2),
                       "min_cosine_vs_fusedqkv": row_cosines(emb, ref).min().item(),
                       "launches": got}
                log(f"  bert-base {json.dumps(row)}")
                if not row["min_cosine_vs_fusedqkv"] >= 0.999:
                    raise AssertionError(f"bert-base {path} S={S} {impl}: {row}")
                rows.append(row)
            enc.attn_impl = None
    del encoders
    torch.cuda.empty_cache()

    clf = port.AdaptiveClassifier(BERT_BASE, config=dict(PRODUCTION), device="cuda")
    texts, labels = intents_rows("train")
    t0 = time.perf_counter()
    _, add_counts = launches.run(lambda: clf.add_examples(texts, labels))
    add_s = time.perf_counter() - t0
    test_t, test_l = intents_rows("test_base")
    n_chunks = math.ceil(len(test_t) / max(clf.config.embed_chunk_size, 64))
    preds, pred_counts = launches.run(lambda: clf.predict_batch(test_t, k=1))
    if add_counts["attention_qkv"] == 0 or \
            pred_counts["attention_qkv"] != cfg.num_layers * n_chunks:
        raise AssertionError(f"bert-base classifier: B1 launched {add_counts} / "
                             f"{pred_counts}")
    if len(preds) != len(test_t) or not all(preds):
        raise AssertionError("bert-base classifier: predict_batch left rows unanswered")
    out = {"encoder_build_s": build_s, "rows": rows,
           "classifier": {"pretrained": clf.encoder.pretrained,
                          "vocab_size": clf.encoder.config.vocab_size,
                          "train_rows": len(texts), "add_examples_s": add_s,
                          "test_rows": len(test_t),
                          "top1_accuracy_random_weights": accuracy(preds, test_l),
                          "launches": {"add_examples": add_counts,
                                       "predict_batch": pred_counts}},
           "gpu": gpu}
    log(f"  bert-base classifier {json.dumps(out['classifier'])}")
    del clf
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6-8: building and growing classifiers with add_examples
# ---------------------------------------------------------------------------

#: the zoo's build config (checkpoints/zoo/manifest.json top level)
PRODUCTION = {"lexical_dim": 32768, "head_type": "ridge", "fusion_weights": "auto",
              "ridge_lambda": "auto"}
#: the many-class phases: the production ridge head, lexical channel off
MANY = {"head_type": "ridge", "ridge_lambda": 1.0, "example_capacity_buckets": [4],
        "example_capacity_slack": 4, "max_examples_per_class": 4}
TOPICS = ["billing", "shipping", "returns", "privacy", "hardware",
          "software", "travel", "finance"]
ENCODER = REPO / "checkpoints" / "ac-base-v2"


class Launches:
    """Launch counts of the main path: each step runs with the counts zeroed
    just before and read just after; ``total`` sums the steps."""

    def __init__(self):
        self.total = {}

    def run(self, fn):
        import adaptive_classifier_tpu_torch as port

        port.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(port.launch_counts)
        for name, n in counts.items():
            self.total[name] = self.total.get(name, 0) + n
        return out, counts


def intents_rows(block: str):
    """(texts, labels) of data/intents.json, rows in the order of
    scripts/build_classifier_zoo.py."""
    intents = json.loads((REPO / "data" / "intents.json").read_text())
    if block in ("train", "new_classes"):
        rows = [(t, lbl) for lbl, ts in intents[block].items() for t in ts]
    else:   # test rows of the base ("train") or the new classes
        src = "train" if block == "test_base" else "new_classes"
        rows = [(t, lbl) for lbl in intents[src] for t in intents["test"][lbl]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def top1(preds):
    return [p[0][0] if p else None for p in preds]


def accuracy(preds, labels) -> float:
    return float(np.mean([a == b for a, b in zip(top1(preds), labels)]))


def run_build(manifest: dict, launches: Launches, config=None, phase="6") -> dict:
    """Phase 6 (6i with ``quantization: "int8"``): banking-intents built
    from data on the production config, then its three new classes added."""
    import adaptive_classifier_tpu_torch as port

    clf = port.AdaptiveClassifier(str(ENCODER), config=dict(config or PRODUCTION),
                                  device="cuda")
    texts, labels = intents_rows("train")
    t0 = time.perf_counter()
    _, first = launches.run(lambda: clf.add_examples(texts, labels))
    add_s = time.perf_counter() - t0
    test_t, test_l = intents_rows("test_base")
    preds, pred_counts = launches.run(lambda: clf.predict_batch(test_t, k=1))
    acc = accuracy(preds, test_l)
    floor = manifest["classifiers"]["banking-intents"]["expected_accuracy"] - 0.03
    if not acc >= floor:
        raise AssertionError(f"banking-intents built from data: top-1 {acc:.4f} < {floor:.4f}")
    zoo = port.AdaptiveClassifier.load(REPO / "checkpoints" / "zoo" / "banking-intents",
                                       device="cuda")
    zoo_cfg = json.loads((REPO / "checkpoints" / "zoo" / "banking-intents"
                          / "config.json").read_text())
    zoo_agree = float(np.mean([a == b for a, b in zip(
        top1(preds), top1(zoo.predict_batch(test_t, k=1)))]))
    knobs = {"lexical_grams": clf.lexical.grams, "lexical_weight": clf.lexical.weight,
             "ridge_lambda": clf.config.ridge_lambda, "fusion_alpha": clf._fusion_alpha}
    zoo_m = manifest["classifiers"]["banking-intents"]
    zoo_knobs = {"lexical_grams": zoo_m["lexical_grams"],
                 "lexical_weight": zoo_m["lexical_weight"],
                 "ridge_lambda": zoo_cfg["config"]["ridge_lambda"],
                 "fusion_alpha": zoo_m["fusion_alpha"]}
    del zoo

    new_t, new_l = intents_rows("new_classes")
    t0 = time.perf_counter()
    _, second = launches.run(lambda: clf.add_examples(new_t, new_l))
    add_new_s = time.perf_counter() - t0
    after = accuracy(clf.predict_batch(test_t, k=1), test_l)
    nt_t, nt_l = intents_rows("test_new")
    new_acc = accuracy(clf.predict_batch(nt_t, k=1), nt_l)
    kernels = ["attention_qkv"]
    if clf.encoder.quantization == "int8":
        kernels += ["matmul_int8", "ffn_int8"]
    for name, counts in (("first add", first), ("predict_batch", pred_counts),
                         ("new-class add", second)):
        for k in kernels:
            if counts[k] == 0:
                raise AssertionError(f"phase {phase} {name}: kernel {k} never launched")
    out = {"phase": phase, "quantization": clf.encoder.quantization,
           "train_rows": len(texts), "test_rows": len(test_t),
           "top1_accuracy": acc, "accuracy_floor": floor,
           "top1_agreement_with_zoo_checkpoint": zoo_agree,
           "resolved": knobs, "zoo": zoo_knobs,
           "add_examples_s": add_s, "add_new_classes_s": add_new_s,
           "new_class_rows": len(new_t), "base_accuracy_before": acc,
           "base_accuracy_after": after,
           "base_relative_drop": (acc - after) / acc if acc else None,
           "new_class_test_rows": len(nt_t), "new_class_accuracy": new_acc,
           "proto_bias_min": float(np.min(clf._proto_bias)) if clf._proto_bias is not None else None,
           "launches": {"first_add": first, "predict_batch": pred_counts,
                        "new_class_add": second}}
    log(f"  build {json.dumps(out)}")
    del clf
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6m, 6s, 6l: the default configuration's continual learning, saving
# ---------------------------------------------------------------------------

#: the JAX package's figures for the flows of phases 6m and 6l on the CPU
#: (same rows, same configs), from
#:   JAX_PLATFORMS=cpu python scripts/jax_reference_continual.py
JAX_DEFAULT_FIRST_TOP1 = 0.75
JAX_LOSSY_DROP = 0.0
#: the new-class bounds of the JAX package's
#: tests/test_new_class_accuracy_preservation.py:38-42
MAX_RELATIVE_DROP = 0.10
MIN_NEW_CLASS_TOP1 = 2 / 3
#: the round trip's bound on score drift (the JAX package's
#: tests/test_persistence.py:89)
MAX_SCORE_DRIFT = 0.01
ADD_KERNELS = ("attention_qkv", "add_layer_norm")


def check_launched(phase: str, steps: dict, kernels=ADD_KERNELS):
    for step, counts in steps.items():
        for k in kernels:
            if counts[k] == 0:
                raise AssertionError(f"phase {phase} {step}: kernel {k} never launched")


def run_default_config(launches: Launches) -> tuple:
    """Phase 6m: ``config={}`` (MLP head, ``fusion_weights: history``, no
    lexical channel) on ac-base-v2 in bf16: the intents train rows, then
    ``predict_batch`` on the ten classes' test rows, then the three new
    classes (EWC + distillation).  → (report, classifier)."""
    import adaptive_classifier_tpu_torch as port

    clf = port.AdaptiveClassifier(str(ENCODER), config={}, device="cuda")
    if clf.config.head_type != "mlp" or clf.lexical is not None:
        raise AssertionError("phase 6m: the default config is not the MLP head without "
                             "the lexical channel")
    texts, labels = intents_rows("train")
    t0 = time.perf_counter()
    _, first = launches.run(lambda: clf.add_examples(texts, labels))
    first_s = time.perf_counter() - t0
    first_fit = clf.last_fit
    test_t, test_l = intents_rows("test_base")
    preds, pred_counts = launches.run(lambda: clf.predict_batch(test_t, k=1))
    before = accuracy(preds, test_l)
    new_t, new_l = intents_rows("new_classes")
    t0 = time.perf_counter()
    _, second = launches.run(lambda: clf.add_examples(new_t, new_l))
    second_s = time.perf_counter() - t0
    after = accuracy(clf.predict_batch(test_t, k=1), test_l)
    nt_t, nt_l = intents_rows("test_new")
    new_acc = accuracy(clf.predict_batch(nt_t, k=1), nt_l)
    drop = (before - after) / before if before else 1.0
    out = {"phase": "6m", "head_hidden": [list(h["w"].shape) for h in clf.head_params["hidden"]],
           "train_rows": len(texts), "new_class_rows": len(new_t),
           "top1_before": before, "top1_after": after, "relative_drop": drop,
           "new_class_top1": new_acc, "jax_cpu_first_top1": JAX_DEFAULT_FIRST_TOP1,
           "add_examples_s": first_s, "add_new_classes_s": second_s,
           "epochs_run": {"first_add": first_fit.epochs_run,
                          "new_class_add": clf.last_fit.epochs_run},
           "final_loss": {"first_add": first_fit.final_loss,
                          "new_class_add": clf.last_fit.final_loss},
           "launches": {"first_add": first, "predict_batch": pred_counts,
                        "new_class_add": second}}
    log(f"  default config {json.dumps(out)}")
    check_launched("6m", out["launches"])
    if not drop <= MAX_RELATIVE_DROP:
        raise AssertionError(f"phase 6m: old-class top-1 dropped {drop:.4f} > {MAX_RELATIVE_DROP}")
    if not new_acc >= MIN_NEW_CLASS_TOP1:
        raise AssertionError(f"phase 6m: new-class top-1 {new_acc:.4f} < 2/3")
    if not before >= JAX_DEFAULT_FIRST_TOP1 - 0.05:
        raise AssertionError(f"phase 6m: first-batch top-1 {before:.4f} < the JAX package's "
                             f"{JAX_DEFAULT_FIRST_TOP1:.4f} - 0.05")
    return out, clf


def run_save_load(clf, launches: Launches) -> dict:
    """Phase 6s: the 6m classifier saved and loaded back on the card; the
    same answers on all test rows."""
    import adaptive_classifier_tpu_torch as port

    texts = intents_rows("test_base")[0] + intents_rows("test_new")[0]
    want = clf.predict_batch(texts, k=3)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        clf.save(d)
        save_s = time.perf_counter() - t0
        files = sorted(p.name for p in Path(d).iterdir())
        examples = json.loads((Path(d) / "examples.json").read_text())
        t0 = time.perf_counter()
        back, load_counts = launches.run(lambda: port.AdaptiveClassifier.load(d, device="cuda"))
        load_s = time.perf_counter() - t0
    got, pred_counts = launches.run(lambda: back.predict_batch(texts, k=3))
    agree = float(np.mean([a[0][0] == b[0][0] for a, b in zip(got, want)]))
    drift = max(abs(s - dict(b)[l]) for a, b in zip(got, want) for l, s in a if l in dict(b))
    per_class = {l: len(v) for l, v in examples.items()}
    out = {"phase": "6s", "files": files, "examples_per_class": per_class,
           "test_rows": len(texts), "top1_agreement": agree, "max_score_drift": drift,
           "save_s": save_s, "load_s": load_s, "launches": {"predict_batch": pred_counts}}
    log(f"  save/load {json.dumps(out)}")
    check_launched("6s", out["launches"])
    if set(files) != {"config.json", "examples.json", "model.safetensors", "README.md",
                      "quantized"}:
        raise AssertionError(f"phase 6s: saved files {files}")
    if any(n != min(5, len(clf.memory.texts[l])) for l, n in per_class.items()) \
            or len(per_class) != len(clf.label_to_id):
        raise AssertionError(f"phase 6s: examples.json holds {per_class}")
    if not agree >= 0.99 or not drift < MAX_SCORE_DRIFT:
        raise AssertionError(f"phase 6s: top-1 agreement {agree}, score drift {drift}")
    del back
    return out


def run_lossy_add(launches: Launches) -> dict:
    """Phase 6l: the three new classes added to the loaded zoo checkpoint
    banking-intents (ridge, lexical 32,768; ~5 stored rows a class): the
    frozen-probe branch, the old classes' head logits bit for bit."""
    import adaptive_classifier_tpu_torch as port

    zoo = port.AdaptiveClassifier.load(REPO / "checkpoints" / "zoo" / "banking-intents",
                                       device="cuda")
    test_t, test_l = intents_rows("test_base")
    n_old = len(zoo.label_to_id)
    emb = torch.from_numpy(zoo._get_embeddings(test_t)).to("cuda")
    logits_before = zoo._head_logits(emb)[:, :n_old].clone()
    before = accuracy(zoo.predict_batch(test_t, k=1), test_l)
    new_t, new_l = intents_rows("new_classes")
    t0 = time.perf_counter()
    _, counts = launches.run(lambda: zoo.add_examples(new_t, new_l))
    add_s = time.perf_counter() - t0
    identical = bool(torch.equal(zoo._head_logits(emb)[:, :n_old], logits_before))
    after = accuracy(zoo.predict_batch(test_t, k=1), test_l)
    nt_t, nt_l = intents_rows("test_new")
    new_acc = accuracy(zoo.predict_batch(nt_t, k=1), nt_l)
    out = {"phase": "6l", "skip_probe": "skip" in zoo.head_params,
           "old_logits_bit_identical": identical, "top1_before": before,
           "top1_after": after, "drop": before - after, "jax_cpu_drop": JAX_LOSSY_DROP,
           "new_class_top1": new_acc, "add_new_classes_s": add_s,
           "epochs_run": zoo.last_fit.epochs_run, "launches": {"new_class_add": counts}}
    log(f"  lossy add {json.dumps(out)}")
    check_launched("6l", out["launches"])
    if not out["skip_probe"]:
        raise AssertionError("phase 6l: the frozen-probe branch did not run")
    if not identical:
        raise AssertionError("phase 6l: the old classes' head logits changed")
    if not before - after <= JAX_LOSSY_DROP + 0.03:
        raise AssertionError(f"phase 6l: old-class top-1 dropped {before - after:.4f} > the "
                             f"JAX package's {JAX_LOSSY_DROP:.4f} + 0.03")
    del zoo
    torch.cuda.empty_cache()
    return out


def many_class_rows(first: int, n: int, per_class: int, r):
    """Templated texts: bench.py's phrasing and, with ``per_class`` 2, a
    second one whose topic is drawn from ``r``."""
    texts, labels = [], []
    for i in range(first, first + n):
        texts.append(f"route this {TOPICS[i % len(TOPICS)]} case number {i} to "
                     f"the owning specialist team")
        if per_class == 2:
            texts.append(f"a {TOPICS[int(r.integers(len(TOPICS)))]} question about "
                         f"ticket {i} needs the right team")
        labels += [f"class_{i:05d}"] * per_class
    return texts, labels


def many_class_queries(n: int, n_classes: int):
    ids = [(i * 7919) % n_classes for i in range(n)]
    return ([f"please send case number {c} about {TOPICS[c % len(TOPICS)]} to its team"
             for c in ids], [f"class_{c:05d}" for c in ids])


def plain_top1(clf, emb: torch.Tensor, k: int):
    """predict_batch(k)'s top-1 on the same embeddings through the plain
    versions: masked_sims_ref, the materialized top-k and fusion."""
    from adaptive_classifier_tpu_torch.models.head import head_forward
    from adaptive_classifier_tpu_torch.ops import fusion, knn

    st = clf.memory.state
    active = clf._active_mask()
    bias = clf._proto_bias_arr()
    pw = 0.7 if clf._fusion_alpha is None else float(clf._fusion_alpha)
    ids = []
    with torch.inference_mode():
        for s in range(0, emb.shape[0], 256):
            e = emb[s:s + 256]
            sims = knn.masked_sims_ref(e, st.proto, st.valid)
            _, idx = fusion.fuse_topk(sims, head_forward(clf.head_params, e),
                                      st.valid, active, pw, 1.0 - pw, k, True,
                                      proto_bias=bias)
            ids += idx[:, 0].tolist()
    return [clf.id_to_label.get(i) for i in ids]


def run_many(phase: int, launches: Launches, seed: int = 0) -> dict:
    """Phase 7 (1,024 classes: 960 + 64 added, two texts each, kernel B4)
    or phase 8 (16,384 classes, one text each, kernel B5)."""
    import adaptive_classifier_tpu_torch as port
    from adaptive_classifier_tpu_torch.ops import fusion

    r = np.random.default_rng(seed)
    C = 1024 if phase == 7 else 16384
    cfg = dict(MANY, class_capacity_buckets=[C],
               train_size_buckets=[2048 if phase == 7 else 16384])
    clf = port.AdaptiveClassifier(str(ENCODER), config=cfg, device="cuda")
    per = 2 if phase == 7 else 1
    first_n = 960 if phase == 7 else C
    texts, labels = many_class_rows(0, first_n, per, r)
    t0 = time.perf_counter()
    _, build_counts = launches.run(lambda: clf.add_examples(texts, labels))
    build_s = time.perf_counter() - t0
    out = {"phase": phase, "classes": first_n, "texts_per_class": per,
           "build_s": build_s, "launches": {"build": build_counts}}
    if phase == 7:
        texts, labels = many_class_rows(first_n, 64, per, r)
        t0 = time.perf_counter()
        _, add_counts = launches.run(lambda: clf.add_examples(texts, labels))
        out["add_64_classes_s"] = time.perf_counter() - t0
        out["launches"]["new_class_add"] = add_counts
        out["classes"] = first_n + 64
        if add_counts["knn_sims"] < 1:
            raise AssertionError("phase 7: kernel B4 did not carry the recalibration")
    if clf._class_capacity != C:
        raise AssertionError(f"phase {phase}: class capacity {clf._class_capacity} != {C}")

    k = 1 if phase == 7 else 5
    kernel = "knn_sims" if phase == 7 else "knn_topk"
    queries, qlabels = many_class_queries(2048, out["classes"])
    n_chunks = math.ceil(len(queries) / max(clf.config.embed_chunk_size, 64))
    preds, pb_counts = launches.run(lambda: clf.predict_batch(queries, k=k))
    out["launches"]["predict_batch"] = pb_counts
    if pb_counts[kernel] != n_chunks:
        raise AssertionError(f"phase {phase}: {kernel} launched {pb_counts[kernel]} "
                             f"times over {n_chunks} predict_batch chunks")
    emb = torch.from_numpy(clf._get_embeddings(queries)).cuda()
    agree = float(np.mean([a == b for a, b in zip(top1(preds), plain_top1(clf, emb, k))]))
    if not agree >= 0.99:
        raise AssertionError(f"phase {phase}: kernel and plain paths agree on "
                             f"{agree:.4f} of top-1 labels (< 0.99)")
    (probs, _), proba_counts = launches.run(lambda: clf.predict_proba(queries[:256]))
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if not row_err <= 1e-5:
        raise AssertionError(f"phase {phase}: predict_proba rows sum to 1 +- {row_err}")
    out["launches"]["predict_proba"] = proba_counts
    if phase == 8:
        _, predict_counts = launches.run(lambda: clf.predict(queries[0], k=5))
        out["launches"]["predict"] = predict_counts
        if predict_counts["knn_sims"] < 1 or proba_counts["knn_sims"] < 1:
            raise AssertionError("phase 8: predict / predict_proba did not launch B4")
        out["predict_batch_2048_ms"] = predict_batch_seconds(clf, queries, k=k) * 1e3
        out["predict_batch_2048_ms_warm_cache"] = predict_batch_seconds(
            clf, queries, k=k, cold=False) * 1e3
        # where a chunk's time goes: host tokenization of all chunks, then
        # the device work of one full chunk (encoder forward; fusion with B5)
        CH = max(clf.config.embed_chunk_size, 64)
        t0 = time.perf_counter()
        for s in range(0, len(queries), CH):
            ids, mask, _ = clf._tokenize_chunk(queries[s:s + CH], CH)
        out["host_tokenize_ms"] = (time.perf_counter() - t0) * 1e3
        out["encoder_forward_ms_per_chunk"] = cuda_ms(
            lambda: clf.encoder.embed_ids(ids, mask), iters=10)
        st = clf.memory.state
        active, bias = clf._active_mask(), clf._proto_bias_arr()
        with torch.inference_mode():
            out["fuse_ms_per_chunk"] = cuda_ms(lambda: fusion.fuse_topk_from_emb(
                emb[:CH], st.proto, st.valid, clf.head_params, active, 0.7, 0.3, k,
                True, proto_bias=bias, fused_min_classes=clf.config.fused_topk_min_classes),
                iters=10)
    out.update({"queries": len(queries), "k": k,
                "top1_accuracy": accuracy(preds, qlabels),
                "top1_agreement_with_plain": agree,
                "predict_proba_row_sum_err": row_err})
    log(f"  many {json.dumps(out)}")
    st = clf.memory.state
    bias = clf._proto_bias_arr()
    shapes = {"emb": emb, "proto": st.proto, "valid": st.valid,
              "bias": bias, "k": k}
    kept = {"clf": clf, "queries": queries, "top1": top1(preds)} if phase == 7 else {}
    del clf
    return {"summary": out, "shapes": shapes, **kept}


# ---------------------------------------------------------------------------
# phases 10-13: serving to many callers, calibration, long documents,
# multi-label
# ---------------------------------------------------------------------------

#: the JAX package's figures for the flows of phases 12 and 13 on the CPU
#: (same rows, same checkpoints), from
#:   JAX_PLATFORMS=cpu python scripts/jax_reference_document.py
#:   JAX_PLATFORMS=cpu python scripts/jax_reference_multilabel.py
JAX_DOCUMENT_TOP1 = {"mean": 1.0, "max": 1.0, "vote": 1.0}
JAX_MULTILABEL_MICRO_F1 = 0.5630252100840336
#: served answers against direct ones (the JAX package's
#: tests/test_serving.py:258-275 bound): top-1 agreement and score gap
MIN_SERVED_AGREEMENT = 0.99
MAX_SERVED_SCORE_GAP = 1e-3
#: phase 11: one step of the fine temperature grid
FINE_GRID_STEP = 10 ** (0.24 / 32)
POOLS = ("mean", "max", "vote")


def serve(server, texts, k: int = 3, clients: int = 8, seed: int = 0, model=None,
          mid_stream=None, timeout: float = 300.0) -> dict:
    """``texts`` submitted in a seeded shuffled order from ``clients``
    threads; ``mid_stream()`` (a submission of its own) is called once half
    the requests are in.  Every future is waited on with a timeout, so an
    exception or a hang fails the phase.  → answers in ``texts`` order,
    per-request latencies, wall seconds, the server's batch figures for
    this pass, and ``mid_stream``'s future."""
    import threading

    order = list(np.random.default_rng(seed).permutation(len(texts)))
    answers, latency = [None] * len(texts), [None] * len(texts)
    submitted, extra, errors = [0], [], []
    lock = threading.Lock()
    before = server.stats()

    def client(idx):
        try:
            pending = []
            for i in idx:
                t0 = time.perf_counter()
                kw = {"model": model} if model else {}
                fut = server.submit_predict(texts[i], k=k, **kw)
                fut.add_done_callback(
                    lambda f, i=i, t0=t0: latency.__setitem__(i, time.perf_counter() - t0))
                pending.append((i, fut))
                with lock:
                    submitted[0] += 1
                    if mid_stream is not None and not extra and \
                            submitted[0] >= len(texts) // 2:
                        extra.append(mid_stream())
            for i, fut in pending:
                answers[i] = fut.result(timeout=timeout)
        except Exception as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(order[c::clients],))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(a is None for a in answers):
        raise AssertionError("serving: a client did not get all its answers in time")
    after = server.stats()
    batches = after["batches_run"] - before["batches_run"]
    served = after["requests_served"] - before["requests_served"]
    lat = np.asarray(latency, np.float64) * 1e3
    return {"answers": answers, "extra": extra[0] if extra else None,
            "figures": {"requests": len(texts), "clients": clients, "wall_s": wall,
                        "requests_per_s": len(texts) / wall,
                        "latency_ms_p50": float(np.percentile(lat, 50)),
                        "latency_ms_p99": float(np.percentile(lat, 99)),
                        "batches": batches, "mean_batch_size": served / max(batches, 1)}}


def agreement(got, want) -> tuple:
    """(top-1 agreement, the largest score gap over the labels both lists
    hold) of two lists of answers."""
    agree = float(np.mean([bool(a) and bool(b) and a[0][0] == b[0][0]
                           for a, b in zip(got, want)]))
    gap = max((abs(s - dict(b)[l]) for a, b in zip(got, want) for l, s in a
               if l in dict(b)), default=0.0)
    return agree, gap


def check_served(name: str, got, want):
    agree, gap = agreement(got, want)
    if not (agree >= MIN_SERVED_AGREEMENT and gap <= MAX_SERVED_SCORE_GAP):
        raise AssertionError(f"phase {name}: served answers agree with direct ones on "
                             f"{agree:.4f} of top-1 labels, score gap {gap:.2e}")
    return agree, gap


def run_serving(launches: Launches, gpu: str) -> dict:
    """Phase 10a-10c: banking-intents (production config) behind
    ``BatchingClassifierServer(max_batch_size=64, max_wait_ms=2,
    num_workers=2)``, 8 client threads; then a two-tenant server."""
    import adaptive_classifier_tpu_torch as port

    zoo = REPO / "checkpoints" / "zoo" / "banking-intents"
    texts, _ = intents_rows("test_base")
    new_t, new_l = intents_rows("new_classes")
    all_test = texts + intents_rows("test_new")[0]
    clf = port.AdaptiveClassifier.load(zoo, device="cuda")
    layers = clf.encoder.config.num_layers
    direct = clf.predict_batch(texts, k=3)
    clf._clear_embedding_caches()
    out = {"gpu": gpu}
    server = port.BatchingClassifierServer(clf, max_batch_size=64, max_wait_ms=2,
                                           num_workers=2)
    server.start()
    try:
        # a: cold, every row through the encoder
        res, counts = launches.run(lambda: serve(server, texts))
        agree, gap = check_served("10a", res["answers"], direct)
        if counts["attention_qkv"] == 0 or \
                counts["add_layer_norm"] != 2 * counts["attention_qkv"]:
            raise AssertionError(f"phase 10a: B1 {counts['attention_qkv']}, B10 "
                                 f"{counts['add_layer_norm']} (B10 = 2 x B1 > 0 expected)")
        out["a_cold"] = {**res["figures"], "top1_agreement": agree, "max_score_gap": gap,
                         "launches": counts,
                         "encoder_batches": counts["attention_qkv"] // layers}
        # a2: again, with the new classes added mid-stream
        copy = port.AdaptiveClassifier.load(zoo, device="cuda")
        res, counts = launches.run(lambda: serve(
            server, texts, seed=1,
            mid_stream=lambda: server.submit_add_examples(new_t, new_l)))
        if res["extra"] is None or res["extra"].result(timeout=300) is not True:
            raise AssertionError("phase 10a2: the mid-stream add_examples did not return True")
        copy.add_examples(new_t, new_l)
        served_after = clf.predict_batch(all_test, k=1)
        copy_after = copy.predict_batch(all_test, k=1)
        agree_copy = float(np.mean([a == b for a, b in zip(top1(served_after),
                                                          top1(copy_after))]))
        if not agree_copy >= 0.99:
            raise AssertionError(f"phase 10a2: the served classifier and the directly "
                                 f"grown copy agree on {agree_copy:.4f} of top-1 labels")
        out["a2_add_mid_stream"] = {**res["figures"], "labels_after": len(clf.label_to_id),
                                    "top1_agreement_with_direct_copy": agree_copy,
                                    "rows_compared": len(all_test), "launches": counts}
        del copy
        # b: warm, every row from the device cache
        hits0 = clf._dev_cache.stats()["hits"]
        res, counts = launches.run(lambda: serve(server, texts, seed=2))
        hits = clf._dev_cache.stats()["hits"] - hits0
        if hits != len(texts) or counts["attention_qkv"] != 0:
            raise AssertionError(f"phase 10b: {hits} device-cache hits (want {len(texts)}), "
                                 f"B1 launched {counts['attention_qkv']} times (want 0)")
        clf._clear_embedding_caches()
        agree_b, gap_b = agreement(res["answers"], clf.predict_batch(texts, k=3))
        if not agree_b >= MIN_SERVED_AGREEMENT:
            raise AssertionError(f"phase 10b: warm answers agree with a cold direct "
                                 f"predict_batch on {agree_b:.4f} of top-1 labels")
        out["b_warm"] = {**res["figures"], "device_cache_hits": hits,
                         "top1_agreement": agree_b, "max_score_gap": gap_b,
                         "launches": counts}
    finally:
        server.stop()
    del clf
    torch.cuda.empty_cache()
    out["c_multi_tenant"] = run_multi_tenant(launches)
    log(f"  serving {json.dumps(out)}")
    return out


def run_multi_tenant(launches: Launches) -> dict:
    """Phase 10c: ``"intents"`` (bf16) and ``"intents-int8"`` (int8)
    behind one ``MultiTenantServer``, interleaved traffic, 200 rows each.
    One worker, so each batch's launches are its tenant's."""
    import adaptive_classifier_tpu_torch as port

    texts, _ = intents_rows("test_base")
    tenants = {"intents": port.AdaptiveClassifier.load(
                   REPO / "checkpoints" / "zoo" / "banking-intents", device="cuda"),
               "intents-int8": port.AdaptiveClassifier.load(
                   int8_checkpoint("banking-intents"), device="cuda")}
    direct = {}
    per_tenant = {name: {} for name in tenants}
    for name, clf in tenants.items():
        direct[name] = clf.predict_batch(texts, k=3)
        clf._clear_embedding_caches()
        inner = clf.predict_batch

        def counted(batch, k=5, batch_size=None, inner=inner, name=name):
            before = dict(port.launch_counts)
            res = inner(batch, k=k, batch_size=batch_size)
            for key, n in port.launch_counts.items():
                per_tenant[name][key] = per_tenant[name].get(key, 0) + n - before[key]
            return res

        clf.predict_batch = counted
    server = port.MultiTenantServer(tenants, max_batch_size=64, max_wait_ms=2,
                                    num_workers=1)
    server.start()
    try:
        import threading

        answers = {name: [None] * len(texts) for name in tenants}

        def client(name, idx):
            futs = [(i, server.submit_predict(texts[i], k=3, model=name)) for i in idx]
            for i, f in futs:
                answers[name][i] = f.result(timeout=300)

        def run():
            threads = [threading.Thread(target=client, args=(name, list(range(c, len(texts), 4))))
                       for c in range(4) for name in tenants]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)

        t0 = time.perf_counter()
        _, counts = launches.run(run)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    out = {"requests": 2 * len(texts), "wall_s": wall,
           "requests_per_s": 2 * len(texts) / wall, "batches": server.stats()["batches_run"],
           "launches": counts, "launches_by_tenant": per_tenant}
    for name in tenants:
        if any(a is None for a in answers[name]):
            raise AssertionError(f"phase 10c: {name} left requests unanswered")
        agree, gap = agreement(answers[name], direct[name])
        out[name] = {"top1_agreement": agree, "max_score_gap": gap}
        if not agree >= MIN_SERVED_AGREEMENT:
            raise AssertionError(f"phase 10c: {name} agrees with its direct predict_batch "
                                 f"on {agree:.4f}")
    bf16, int8 = per_tenant["intents"], per_tenant["intents-int8"]
    if bf16.get("matmul_int8") or bf16.get("ffn_int8") or not int8.get("matmul_int8") \
            or not int8.get("ffn_int8") or not bf16.get("attention_qkv"):
        raise AssertionError(f"phase 10c: B2/B3 launches by tenant {per_tenant}")
    for clf in tenants.values():
        del clf.predict_batch
    del tenants
    torch.cuda.empty_cache()
    return out


def run_serving_many(p7: dict, launches: Launches, gpu: str) -> dict:
    """Phase 10d: phase 7's 2,048 queries to its 1,024-class classifier
    through a 2-worker server, the caches cleared first: every served batch
    fuses through kernel B4."""
    import adaptive_classifier_tpu_torch as port

    clf, queries = p7["clf"], p7["queries"]
    clf._clear_embedding_caches()
    calls = [0]
    inner = clf.predict_batch

    def counted(batch, k=5, batch_size=None):
        calls[0] += 1
        return inner(batch, k=k, batch_size=batch_size)

    clf.predict_batch = counted
    server = port.BatchingClassifierServer(clf, max_batch_size=64, max_wait_ms=2,
                                           num_workers=2)
    server.start()
    try:
        res, counts = launches.run(lambda: serve(server, queries, k=1, seed=3))
    finally:
        server.stop()
        del clf.predict_batch
    agree = float(np.mean([a == b for a, b in zip(top1(res["answers"]), p7["top1"])]))
    out = {**res["figures"], "classes": len(clf.label_to_id), "top1_agreement": agree,
           "served_batches": calls[0], "launches": counts, "gpu": gpu}
    log(f"  serving 1,024 classes {json.dumps(out)}")
    if not agree >= MIN_SERVED_AGREEMENT:
        raise AssertionError(f"phase 10d: top-1 agreement with phase 7 {agree:.4f}")
    if counts["knn_sims"] < calls[0]:
        raise AssertionError(f"phase 10d: B4 launched {counts['knn_sims']} times over "
                             f"{calls[0]} served batches")
    return out


def run_calibration(launches: Launches, gpu: str) -> dict:
    """Phase 11: hallucination-detector calibrated on its even test rows,
    calibrated probabilities on the odd ones; the card's temperature
    against the CPU port's fit on the same probabilities."""
    import adaptive_classifier_tpu_torch as port
    from adaptive_classifier_tpu_torch.calibration import TemperatureScaler

    texts, labels = task_rows("hallucination-detector")
    clf = port.AdaptiveClassifier.load(
        REPO / "checkpoints" / "zoo" / "hallucination-detector", device="cuda")
    t0 = time.perf_counter()
    report, counts = launches.run(lambda: clf.calibrate(texts[0::2], labels[0::2]))
    calibrate_s = time.perf_counter() - t0
    probs, _ = clf.predict_proba(texts[1::2], calibrated=True)
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    raw, ordered = clf.predict_proba(texts[0::2])
    idx = np.asarray([ordered.index(l) for l in labels[0::2]])
    cpu = TemperatureScaler(device="cpu").fit(raw, idx)
    ratio = max(report["temperature"] / cpu.temperature, cpu.temperature / report["temperature"])
    out = {"report": report, "calibrated_rows": len(probs), "row_sum_err": row_err,
           "cpu_temperature": cpu.temperature, "temperature_ratio": ratio,
           "fine_grid_step": FINE_GRID_STEP, "calibrate_s": calibrate_s,
           "launches": counts, "gpu": gpu}
    log(f"  calibration {json.dumps(out)}")
    check_launched("11", {"calibrate": counts})
    if not row_err <= 1e-5:
        raise AssertionError(f"phase 11: calibrated rows sum to 1 +- {row_err}")
    if not ratio <= FINE_GRID_STEP:
        raise AssertionError(f"phase 11: card T {report['temperature']} vs CPU T "
                             f"{cpu.temperature}: more than one fine-grid step apart")
    del clf
    torch.cuda.empty_cache()
    return out


def topic_documents():
    """The documents of scripts/jax_reference_document.py: 20 of 10 test
    rows of one class at 64-token windows, then one of 60 rows of the first
    class (its 50 test rows and 10 train rows) at the default window."""
    data = json.loads((REPO / "data" / "topic.json").read_text())
    docs = []
    for label, rows in data["test"].items():
        for s in range(0, len(rows), 10):
            docs.append((". ".join(rows[s:s + 10]), label, 64))
    first = next(iter(data["test"]))
    docs.append((". ".join(data["test"][first] + data["train"][first][:10]), first, None))
    return docs


def run_documents(launches: Launches, gpu: str) -> dict:
    """Phase 12: ``predict_document`` on the topic zoo classifier in the
    three pools: one encoder call per document (B1 once per layer), top-1
    within 0.05 of the JAX package's; a one-window document against
    ``predict`` and ``_predict_from_embedding``."""
    import adaptive_classifier_tpu_torch as port
    from adaptive_classifier_tpu_torch.document import window_batch

    clf = port.AdaptiveClassifier.load(REPO / "checkpoints" / "zoo" / "topic", device="cuda")
    cfg = clf.encoder.config
    layers = cfg.pool_layer if 0 < cfg.pool_layer < cfg.num_layers else cfg.num_layers
    docs = topic_documents()
    long_ids, _, long_counts = window_batch(clf, docs[-1][0])
    out = {"documents": len(docs), "long_document_windows": len(long_counts),
           "long_document_S": int(long_ids.shape[1]), "gpu": gpu}
    for pool in POOLS:
        hits, secs, bad = [], [], []
        for text, label, ct in docs:
            t0 = time.perf_counter()
            pred, counts = launches.run(lambda: clf.predict_document(
                text, k=1, chunk_tokens=ct, pool=pool))
            secs.append(time.perf_counter() - t0)
            hits.append(bool(pred) and pred[0][0] == label)
            if counts["attention_qkv"] != layers:
                bad.append(counts["attention_qkv"])
        out[pool] = {"top1": float(np.mean(hits)), "jax_cpu_top1": JAX_DOCUMENT_TOP1[pool],
                     "ms_per_document": 1e3 * float(np.mean(secs)),
                     "long_document_ms": 1e3 * secs[-1]}
        if bad:
            raise AssertionError(f"phase 12 {pool}: B1 launched {bad} times in a window "
                                 f"batch (want {layers})")
        if not out[pool]["top1"] >= JAX_DOCUMENT_TOP1[pool] - 0.05:
            raise AssertionError(f"phase 12 {pool}: top-1 {out[pool]['top1']:.4f} < the JAX "
                                 f"package's {JAX_DOCUMENT_TOP1[pool]} - 0.05")
    short = json.loads((REPO / "data" / "topic.json").read_text())["test"]["sports"][0]
    doc = clf.predict_document(short, k=2, pool="mean")
    direct = clf.predict(short, k=2)
    same = clf._predict_from_embedding(clf._get_embeddings([short])[0], k=2)
    out["one_window"] = {"document": doc, "predict": direct, "from_embedding": same}
    log(f"  documents {json.dumps(out)}")
    if not (doc[0][0] == direct[0][0] == same[0][0]
            and abs(doc[0][1] - same[0][1]) < 5e-3):
        raise AssertionError(f"phase 12: one-window document {out['one_window']}")
    del clf
    torch.cuda.empty_cache()
    return out


def paired_rows(split: str):
    """The topic x emotion pairs of scripts/jax_reference_multilabel.py."""
    topic = json.loads((REPO / "data" / "topic.json").read_text())[split]
    emotions = json.loads((REPO / "data" / "emotions.json").read_text())[split]
    t_rows = [(t, lbl) for lbl, ts in topic.items() for t in ts]
    e_rows = [(t, lbl) for lbl, ts in emotions.items() for t in ts]
    pairs = list(zip(t_rows, e_rows))
    return ([f"{a} {b}" for (a, _), (b, _) in pairs],
            [[la, lb] for (_, la), (_, lb) in pairs])


def label_set_scores(predicted, truth) -> tuple:
    """(micro-F1, exact-set accuracy)."""
    tp = fp = fn = exact = 0
    for p, t in zip(predicted, truth):
        p, t = set(p), set(t)
        tp += len(p & t)
        fp += len(p - t)
        fn += len(t - p)
        exact += p == t
    return 2 * tp / max(2 * tp + fp + fn, 1), exact / len(truth)


def run_multilabel(launches: Launches, gpu: str) -> dict:
    """Phase 13: ``MultiLabelAdaptiveClassifier`` on ac-base-v2 with the
    default config, the even then the odd train pairs, ``predict_multilabel``
    on the test pairs; saved and loaded back on the card."""
    import adaptive_classifier_tpu_torch as port

    clf = port.MultiLabelAdaptiveClassifier(str(ENCODER), config={}, device="cuda")
    texts, labels = paired_rows("train")
    adds, add_s = {}, []
    for name, part in (("even", slice(0, None, 2)), ("odd", slice(1, None, 2))):
        t0 = time.perf_counter()
        _, adds[name] = launches.run(lambda: clf.add_examples(texts[part], labels[part]))
        add_s.append(time.perf_counter() - t0)
    test_t, test_l = paired_rows("test")
    t0 = time.perf_counter()
    predicted = [[l for l, _ in clf.predict_multilabel(t)] for t in test_t]
    predict_s = time.perf_counter() - t0
    f1, exact = label_set_scores(predicted, test_l)
    with tempfile.TemporaryDirectory() as d:
        clf.save(d)
        back = port.MultiLabelAdaptiveClassifier.load(d, device="cuda")
    # neither package keeps the per-label thresholds in the checkpoint
    back.label_thresholds = dict(clf.label_thresholds)
    again = [[l for l, _ in back.predict_multilabel(t)] for t in test_t]
    same = float(np.mean([set(a) == set(b) for a, b in zip(again, predicted)]))
    out = {"train_pairs": len(texts), "test_pairs": len(test_t),
           "labels": len(clf.label_to_id), "micro_f1": f1,
           "jax_cpu_micro_f1": JAX_MULTILABEL_MICRO_F1, "exact_set_accuracy": exact,
           "add_examples_s": add_s, "predict_multilabel_ms": 1e3 * predict_s / len(test_t),
           "label_sets_equal_after_load": same, "launches": adds, "gpu": gpu}
    log(f"  multi-label {json.dumps(out)}")
    check_launched("13", adds)
    if not f1 >= JAX_MULTILABEL_MICRO_F1 - 0.05:
        raise AssertionError(f"phase 13: micro-F1 {f1:.4f} < the JAX package's "
                             f"{JAX_MULTILABEL_MICRO_F1:.4f} - 0.05")
    if not same >= 0.99:
        raise AssertionError(f"phase 13: the loaded classifier agrees on {same:.4f} of the "
                             f"label sets")
    del clf, back
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr, flush=True)
        return 1
    try:
        from adaptive_classifier_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here: {e}",
              file=sys.stderr, flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def phase_done(name, t0):
        seconds[name] = time.perf_counter() - t0
        log(f"  phase {name}: {seconds[name]:.1f}s")

    gpu = gpu_name_and_power()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(gpu)

    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f}s "
        f"(parallel nvcc {_build.BuildInfo.seconds:.1f}s, "
        f"compiled={_build.BuildInfo.compiled}) -> {_build.BuildInfo.path}")
    for line in _build.BuildInfo.log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or line.startswith("==")):
            log(f"  ptxas {line.strip()}")
    phase_done("2", t0)

    log("phase 3: kernels vs plain versions on the card")
    t0 = time.perf_counter()
    checks = check_attention()
    knn_checks = check_knn()
    int8_checks = check_int8()
    flash_checks = check_flash()
    ln_checks = check_layernorm()
    phase_done("3", t0)

    launches = Launches()
    log("phase 4: serve saved zoo classifiers (predict_batch)")
    t0 = time.perf_counter()
    manifest = json.loads((REPO / "checkpoints" / "zoo" / "manifest.json").read_text())
    linear = check_linear()
    runs = {task: run_task(task, manifest, gpu) for task in TASKS}
    for r in runs.values():
        for name, n in r["summary"]["launches"].items():
            launches.total[name] = launches.total.get(name, 0) + n
    phase_done("4", t0)

    log("phase 4i: serve the zoo classifiers with quantization int8")
    t0 = time.perf_counter()
    from adaptive_classifier_tpu_torch.models.encoder import Encoder

    float_encoder = Encoder(str(ENCODER), device="cuda")
    runs_int8 = {task: run_task_int8(task, manifest, gpu, runs[task]["top1"],
                                     float_encoder, launches) for task in TASKS}
    del float_encoder
    torch.cuda.empty_cache()
    phase_done("4i", t0)

    log("phase 4a: AC_ATTN_IMPL=flash|oneshot (B6, B7) and the fused LayerNorm (B10)")
    t0 = time.perf_counter()
    attn_runs = [run_attn_path(task, impl, manifest, runs[task]["top1"], launches)
                 for impl in ("flash", "oneshot") for task in TASKS]
    attn_runs += [run_attn_path(TASKS[0], impl, manifest, runs_int8[TASKS[0]]["top1"],
                                launches, int8=True) for impl in ("flash", "oneshot")]
    fused_ln = {task: run_fused_ln(task) for task in TASKS}
    log(f"  attention paths " + json.dumps([
        {k: r[k] for k in ("task", "impl", "quantization", "top1_accuracy",
                           "top1_agreement_with_phase_4", "min_embedding_cosine")}
        for r in attn_runs]))
    phase_done("4a", t0)

    log("phase 6: build banking-intents from data on the production config")
    t0 = time.perf_counter()
    build = run_build(manifest, launches)
    phase_done("6", t0)

    log("phase 6i: build banking-intents from data, quantization int8")
    t0 = time.perf_counter()
    build_int8 = run_build(manifest, launches, {**PRODUCTION, "quantization": "int8"},
                           phase="6i")
    phase_done("6i", t0)

    log("phase 6m: the default config (MLP head), then its new classes")
    t0 = time.perf_counter()
    default_run, default_clf = run_default_config(launches)
    phase_done("6m", t0)

    log("phase 6s: save the 6m classifier and load it back")
    t0 = time.perf_counter()
    save_run = run_save_load(default_clf, launches)
    del default_clf
    torch.cuda.empty_cache()
    phase_done("6s", t0)

    log("phase 6l: new classes on the loaded zoo checkpoint (lossy replay)")
    t0 = time.perf_counter()
    lossy_run = run_lossy_add(launches)
    phase_done("6l", t0)

    log("phase 7: 1,024 classes (960 + 64 added), kernel B4")
    t0 = time.perf_counter()
    p7 = run_many(7, launches)
    phase_done("7", t0)

    log("phase 8: 16,384 classes, kernel B5")
    t0 = time.perf_counter()
    p8 = run_many(8, launches)
    phase_done("8", t0)

    log("phase 9: attention A/B at bert-base width (offline weights), and its classifier")
    t0 = time.perf_counter()
    bert = run_bert_base(manifest, launches, gpu)
    phase_done("9", t0)

    log("phase 10: the batching server (8 clients, 2 workers), the device cache, "
        "two tenants, 1,024 classes")
    t0 = time.perf_counter()
    serving = run_serving(launches, gpu)
    serving["d_1024_classes"] = run_serving_many(p7, launches, gpu)
    del p7["clf"]
    torch.cuda.empty_cache()
    phase_done("10", t0)

    log("phase 11: calibration (hallucination-detector)")
    t0 = time.perf_counter()
    calibration = run_calibration(launches, gpu)
    phase_done("11", t0)

    log("phase 12: long documents (topic), mean / max / vote")
    t0 = time.perf_counter()
    documents = run_documents(launches, gpu)
    phase_done("12", t0)

    log("phase 13: multi-label (topic x emotions pairs)")
    t0 = time.perf_counter()
    multilabel = run_multilabel(launches, gpu)
    phase_done("13", t0)

    log("phase 3b: kernel timing at the main path's shapes")
    t0 = time.perf_counter()
    timings = time_attention({
        **{t: r["shape"] for t, r in runs.items()},
        "bert-base B=32 S=512": (np.ones((32, 512), np.int32), 12, 64, torch.bfloat16)})
    s7, s8 = p7["shapes"], p8["shapes"]
    knn_times = time_knn({
        "knn_sims": {
            "phase 7 predict_batch chunk": (s7["emb"][:256], s7["proto"], s7["valid"]),
            "phase 7 recalibration": (s7["emb"], s7["proto"], s7["valid"]),
            "phase 8 predict_proba chunk": (s8["emb"][:256], s8["proto"], s8["valid"]),
            # the production classifier's [dense 512 | lexical 32,768] rows
            # at 1,024 classes (classifier._compose_channels)
            "production width [256,33280]x[1024,33280]": knn_inputs(11, 256, 1024, 33280),
        },
        "knn_topk": {
            "phase 8 predict_batch chunk": (s8["emb"][:256], s8["proto"], s8["valid"],
                                            s8["bias"], s8["k"]),
        },
    })
    int8_times = time_int8({**{t: (r["chunk_rows"], 512, 2048)
                                for t, r in runs_int8.items()},
                            "bert-base B=32 S=128": (4096, 768, 3072)})
    flash_times = time_flash({
        **{f"{t} chunk": r["shape"] for t, r in runs.items()},
        "bert-base B=32 S=512": (np.ones((32, 512), np.int32), 12, 64, torch.bfloat16)})
    ln_times = time_layernorm({f"{t} chunk": r["chunk_rows"] for t, r in fused_ln.items()})
    phase_done("3b", t0)
    del p7, p8
    torch.cuda.empty_cache()

    main_row = timings[0]
    kernels = [{
        "name": "attention_qkv",
        "route": "cuda",
        "source": "adaptive_classifier_tpu_torch/csrc/attention_qkv.cu",
        "replaces": "adaptive_classifier_tpu/ops/attention_qkv.py:216",
        "launches": launches.total["attention_qkv"],
        "max_abs_err": max(r["max_abs_err"] for r in timings),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "instantiation": main_row["instantiation"],
        "tolerance": "f32: max abs err <= 1e-4 (TF32 off); "
                     "bf16: max abs err <= 0.05 and cosine > 0.999",
        "checks_max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "per_shape": timings,
    }]
    for name, replaces, tol in (
            ("knn_sims", "adaptive_classifier_tpu/ops/knn.py:78",
             "f32 max abs err <= 1e-5 (TF32 off)"),
            ("knn_topk", "adaptive_classifier_tpu/ops/knn_topk.py:120",
             "identical idx on inputs without near-ties, lower index on exact "
             "ties, values max abs err <= 1e-5")):
        row = knn_times[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptive_classifier_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches.total[name],
            "max_abs_err": max(c["max_abs_err"] for c in knn_checks[name] + knn_times[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": [row["B"], row["C"], row["D"]] + ([row["k"]] if "k" in row else []),
            **{key: row[key] for key in ("bound_ops", "splits", "instantiation")
               if key in row},
            "tolerance": tol, "per_shape": knn_times[name],
        })
    for name, replaces in (("matmul_int8", "adaptive_classifier_tpu/ops/matmul_int8.py:80"),
                           ("ffn_int8", "adaptive_classifier_tpu/ops/ffn_int8.py:95"),
                           ("attn_ffn_int8", "adaptive_classifier_tpu/ops/ffn_int8.py:202"),
                           ("proj_residual_ln_int8",
                            "adaptive_classifier_tpu/ops/matmul_int8.py:115")):
        row = int8_times[name][0]
        source = {"ffn_int8": "ffn_block_int8.cu",
                  "attn_ffn_int8": "ffn_block_int8.cu"}.get(name, "matmul_int8.cu")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptive_classifier_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches.total[name],
            "max_abs_err": max(c["max_abs_err"] for c in
                               int8_checks["results"][name] + int8_times[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": row["library_call"],
            "shape": [row["M"], row["D"]], "tolerance": INT8_TOLERANCE[name],
            **({"instantiation": row["instantiation"]} if "instantiation" in row else {}),
            "checked_launches": int8_checks["launches"][name],
            "per_shape": int8_times[name],
        })
    for name, replaces in (("flash_attention",
                            "adaptive_classifier_tpu/ops/flash_attention.py:69"),
                           ("oneshot_attention",
                            "adaptive_classifier_tpu/ops/flash_attention.py:136")):
        row = flash_times[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "adaptive_classifier_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": launches.total[name],
            "max_abs_err": max(c["max_abs_err"] for c in flash_checks[name]
                               + flash_times[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": row["library_call"], "shape": row["shape"],
            "tflops": row["tflops"], "bound_share": row["bound_share"],
            "instantiation": row["instantiation"],
            "tolerance": FLASH_TOLERANCE, "per_shape": flash_times[name],
        })
    row = ln_times[0]
    kernels.append({
        "name": "add_layer_norm", "route": "cuda",
        "source": "adaptive_classifier_tpu_torch/csrc/add_layernorm.cu",
        "replaces": "adaptive_classifier_tpu/ops/layernorm.py:52",
        "launches": launches.total["add_layer_norm"],
        "max_abs_err": max(c["max_abs_err"] for c in ln_checks + ln_times),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "library_call": row["library_call"], "shape": [row["M"], row["D"]],
        "tolerance": LN_TOLERANCE, "per_shape": ln_times,
    })
    # B9 has no caller on any path (in the JAX package only its test calls
    # it): its main-path count is 0 by design, and phase 3 held it to its
    # plain version ("checked_launches")
    no_path = {"proj_residual_ln_int8"}
    for name, n in launches.total.items():
        if n == 0 and name not in no_path:
            raise AssertionError(f"kernel {name} never launched on the main path")
    log("phase 5: summary")
    log(f"  seconds per phase {json.dumps(seconds)}")
    log(f"  main path launches {json.dumps(launches.total)}")
    log(f"  int8 vs bf16 encoder forward per chunk (ms) " + json.dumps(
        {t: {"int8": r["encoder_forward_ms_int8"], "bf16": r["encoder_forward_ms_bf16"],
             "int8_faster": r["int8_faster"]} for t, r in runs_int8.items()}))
    log(f"  fused LayerNorm vs plain, bf16 encoder forward per chunk (ms) " + json.dumps(
        {t: {"fused": r["encoder_forward_ms_fused_ln"],
             "plain": r["encoder_forward_ms_plain_ln"],
             "fused_faster": r["fused_faster"]} for t, r in fused_ln.items()}))
    log(f"  linear layers (torch {linear['torch']}): bf16 outputs equal to the JAX order "
        + json.dumps(
            {n: [linear[n]["equal_share"], linear[n]["parent_equal_share"]]
             for n in ("linear", "linear_gelu")}) + " (current, parent)")
    log(f"  bf16 encoder forward per chunk, parent vs current linear layers (ms) "
        + json.dumps({t: r["summary"]["encoder_forward_ms_parent_vs_current_linear"]
                      for t, r in runs.items()}))
    log(f"  B1 ms by shape " + json.dumps({r["task"]: r["ms"] for r in timings}))
    for label, name in (("B4", "knn_sims"), ("B5", "knn_topk")):
        log(f"  {label} ms, bound (3xTF32 ops or bytes) " + json.dumps(
            {r["shape"]: [r["ms"], r["bound_ms"]]
             for r in knn_times[name]}))
    for label, name in (("B2", "matmul_int8"), ("B3", "ffn_int8"), ("B8", "attn_ffn_int8"),
                        ("B9", "proj_residual_ln_int8")):
        log(f"  {label} ms by shape " + json.dumps(
            {r["task"]: r["ms"] for r in int8_times[name]}))
    log(f"  fuse_o_proj (B8) vs default int8 forward, one banking chunk (ms) " + json.dumps(
        {k: {"fuse_o_proj": r["forward_ms"], "default": r["default_forward_ms"]}
         for k, r in runs_int8[TASKS[0]]["fuse_o_proj"].items()}))
    for label, r in (("bf16", runs[TASKS[1]]["summary"]), ("int8", runs_int8[TASKS[1]])):
        log(f"  {TASKS[1]} {label} forward, top device kernels "
            + json.dumps(r.get("encoder_forward_top_device_ops")))
    log(f"  B6/B7 ms, TFLOP/s, bound share, registers, blocks/SM " + json.dumps(
        {f"{name} {r['where']}": [r["ms"], r["tflops"], r["bound_share"],
                                  r["instantiation"]["registers"],
                                  r["instantiation"]["blocks_per_sm"]]
         for name, rows in flash_times.items() for r in rows}))
    log(f"  bert-base A/B ms per batch " + json.dumps(
        {f"{r['path']} S={r['S']} {r['impl']}": r["ms_per_batch"] for r in bert["rows"]}))
    log("  continual learning and saving " + json.dumps({
        "6m": {k: default_run[k] for k in ("top1_before", "top1_after", "relative_drop",
                                           "new_class_top1", "add_examples_s",
                                           "add_new_classes_s", "epochs_run")},
        "6s": {k: save_run[k] for k in ("top1_agreement", "max_score_drift", "save_s",
                                        "load_s")},
        "6l": {k: lossy_run[k] for k in ("top1_before", "top1_after", "new_class_top1",
                                         "add_new_classes_s", "epochs_run",
                                         "old_logits_bit_identical")}}))
    log("  serving (requests/s, p50 / p99 ms, mean batch) " + json.dumps({
        name: [serving[key]["requests_per_s"], serving[key]["latency_ms_p50"],
               serving[key]["latency_ms_p99"], serving[key]["mean_batch_size"]]
        for name, key in (("cold", "a_cold"), ("add mid-stream", "a2_add_mid_stream"),
                          ("warm", "b_warm"), ("1,024 classes", "d_1024_classes"))}))
    log("  predict_batch cold / warm cache (ms) " + json.dumps({
        t: [r["summary"]["predict_batch_ms"], r["summary"]["predict_batch_ms_warm_cache"]]
        for t, r in runs.items()}))
    log("  calibration, documents, multi-label " + json.dumps({
        "11": {k: calibration["report"][k] for k in ("temperature", "nll_before", "nll_after",
                                                     "ece_before", "ece_after")},
        "12": {pool: documents[pool]["top1"] for pool in POOLS},
        "13": {k: multilabel[k] for k in ("micro_f1", "exact_set_accuracy",
                                          "add_examples_s")}}))
    log(f"  phase 6i resolved {json.dumps(build_int8['resolved'])} zoo "
        f"{json.dumps(build_int8['zoo'])} top-1 {build_int8['top1_accuracy']}")
    log(gpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
