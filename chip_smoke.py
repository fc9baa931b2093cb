"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. a CUDA device is present; prints its name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``adaptive_classifier_tpu_torch/csrc`` with
   nvcc (timed, with ptxas' register and shared-memory report);
3. holds every kernel against its plain torch version on the card (f32:
   max abs error <= 1e-4 with TF32 off; bf16: cosine > 0.999 and max abs
   error <= 0.05), then times kernel, plain version and the nearest single
   PyTorch call at the shapes the main path gives the kernel;
4. drives the main path: loads zoo classifiers on the full-width encoder
   (checkpoints/ac-base-v2: BERT, 8 layers, hidden 512, 8 heads) and answers
   ``predict_batch`` on each task's test rows; checks that the kernels ran
   (launch counts), the accuracy against the zoo manifest, and top-1
   agreement with the same run through the plain attention;
5. prints the ``kernels`` JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, if there is no CUDA device, if the
package is not beside this file, or if any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense): device memory rate, bf16 tensor-core
#: rate, and the f32 rate outside the tensor cores (TF32 is off here)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    ]
    results = {}
    for i, (name, dtype, B, S, H, Dh, masked) in enumerate(cases):
        qkv, mask = qkv_inputs(i, dtype, B, S, H, Dh, masked_rows=masked)
        got = attention_from_qkv(qkv, mask, H, Dh)
        want = attention_from_qkv_ref(qkv, mask, H, Dh)
        torch.cuda.synchronize()
        res = compare(got, want, dtype)
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
        attention_from_qkv, attention_from_qkv_ref)

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
        ms = cuda_ms(lambda: attention_from_qkv(qkv, mask, H, Dh))
        plain_ms = cuda_ms(lambda: attention_from_qkv_ref(qkv, mask, H, Dh), iters=5)
        library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=bias))
        ms_again = cuda_ms(lambda: attention_from_qkv(qkv, mask, H, Dh))
        bound_ms, bound_by = attention_bound(B, S, H, Dh, dtype)
        row = {"task": task, "shape": [B, S, 3 * D], "dtype": str(dtype),
               "valid_keys": int(mask.sum().item()),
               "max_abs_err": res["max_abs_err"], "cosine": res["cosine"],
               "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        log(f"  time {json.dumps(row)}")
        rows.append(row)
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
    top1 = [p[0][0] if p else None for p in preds]
    acc = float(np.mean([p == y for p, y in zip(top1, labels)]))
    floor = manifest["classifiers"][task]["expected_accuracy"] - 0.03
    if not acc >= floor:
        raise AssertionError(f"{task}: top-1 accuracy {acc:.4f} < {floor:.4f}")

    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        clf.predict_batch(texts, k=1)
        steady.append(time.perf_counter() - t0)
    batch_s = min(steady)

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

    # the same run through the plain attention
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
           "host_tokenize_lexical_ms": host_s * 1e3,
           "encoder_forward_ms": encoder_ms, "gpu": gpu}
    log(f"  task {json.dumps(out)}")
    shape = (mask, cfg.num_heads, cfg.head_dim, clf.encoder.compute_dtype)
    del clf
    torch.cuda.empty_cache()
    return {"summary": out, "shape": shape}


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

    gpu = gpu_name_and_power()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(gpu)

    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.BuildInfo.seconds:.1f}s, compiled={_build.BuildInfo.compiled}) "
        f"-> {_build.BuildInfo.path}")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas {line.strip()}")

    log("phase 3: kernel vs plain version on the card")
    checks = check_attention()

    log("phase 4: main path (predict_batch on zoo classifiers)")
    manifest = json.loads((REPO / "checkpoints" / "zoo" / "manifest.json").read_text())
    runs = {task: run_task(task, manifest, gpu) for task in TASKS}

    log("phase 3b: kernel timing at the main path's shapes")
    timings = time_attention({t: r["shape"] for t, r in runs.items()})

    main_row = timings[0]
    kernels = [{
        "name": "attention_qkv",
        "route": "cuda",
        "source": "adaptive_classifier_tpu_torch/csrc/attention_qkv.cu",
        "replaces": "adaptive_classifier_tpu/ops/attention_qkv.py:216",
        "launches": sum(r["summary"]["launches"]["attention_qkv"] for r in runs.values()),
        "max_abs_err": max(r["max_abs_err"] for r in timings),
        "max_err": max(r["max_abs_err"] for r in timings),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "tolerance": "f32: max abs err <= 1e-4 (TF32 off); "
                     "bf16: max abs err <= 0.05 and cosine > 0.999",
        "checks_max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "per_shape": timings,
    }]
    log("phase 5: summary")
    log(gpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
