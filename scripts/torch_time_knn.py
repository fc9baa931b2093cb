"""Time the port's kNN kernels B5 (streaming top-k) and B4 (masked
similarities) on one NVIDIA GPU, for an A/B of two versions of the package
in one call.

    python3 scripts/torch_time_knn.py [--root DIR] [--kernels knn_sims,knn_topk]
                                      [--only NAMES]

``--root`` is a directory holding an ``adaptive_classifier_tpu_torch``
package (default: this checkout), so a copy of another commit's package,
unpacked with ``git archive`` into a git-ignored directory, is timed by the
same code; run the two roots in turns (parent, change, change, parent), one
process each.  B5 runs at the 16,384-class ``predict_batch`` chunk (256
queries of D 512, k 5, a per-class bias), at k 128 and at 1,024 queries; B4
at the shapes the main path gives it (phase 7's 1,024-class chunk and
recalibration, phase 8's 16,384-class chunk) and at the production
classifier's width (D 512 + 32,768 lexical columns, 1,024 classes).
Seeded random unit rows, every prototype valid, the bias drawn from
{0, -0.3}.  ``--kernels`` picks B4 (``knn_sims``), B5 (``knn_topk``) or
both; ``--only`` takes a comma-separated subset of the shapes' names.
A time is the device's, in ms per call: the best of
three runs of 20 calls, the stream held by a GPU sleep
until the host has queued them.  Each line also gives the largest error
against the plain version, the share of equal indices and, where the
package reports it, the launched instantiation.  Prints one JSON line;
exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

#: B5: name -> (queries, prototypes, D, k)
SHAPES = {"phase 8 chunk": (256, 16384, 512, 5), "k=128": (256, 16384, 512, 128),
          "1024 queries": (1024, 16384, 512, 5)}
#: B4: name -> (queries, prototypes, D)
SIMS_SHAPES = {"phase 7 chunk": (256, 1024, 512), "recalibration": (2048, 1024, 512),
               "phase 8 chunk": (256, 16384, 512), "production width": (256, 1024, 33280)}


def device_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_rows(r, shape):
    x = r.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--only", default="", help="comma-separated shape names")
    ap.add_argument("--kernels", default="knn_sims,knn_topk",
                    help="comma-separated: knn_sims (B4), knn_topk (B5)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    kernels = set(filter(None, args.kernels.split(",")))
    if not torch.cuda.is_available():
        print("torch_time_knn: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from adaptive_classifier_tpu_torch.ops import knn, knn_topk

    if not knn_topk.__file__.startswith(root):
        raise RuntimeError(f"imported {knn_topk.__file__}, not the package under {root}")
    out = {}
    for name, (B, C, D, k) in SHAPES.items():
        if "knn_topk" not in kernels or (only and name not in only):
            continue
        r = np.random.default_rng(0)
        q, p = unit_rows(r, (B, D)), unit_rows(r, (C, D))
        valid = torch.ones(C, dtype=torch.bool, device="cuda")
        bias = torch.from_numpy((-0.3 * r.integers(0, 2, C)).astype(np.float32)).cuda()
        vals, idx = knn_topk.topk_sims_cuda(q, p, valid, k, bias=bias)
        want_v, want_i = knn_topk.topk_sims_ref(q, p, valid, k, bias=bias)
        row = {"ms": min(device_ms(lambda: knn_topk.topk_sims_cuda(q, p, valid, k, bias=bias))
                         for _ in range(3)),
               "max_abs_err": (vals - want_v).abs().max().item(),
               "same_idx_share": (idx == want_i).double().mean().item()}
        try:        # what each version of the package reports
            row["instantiation"] = knn_topk.topk_info(k)
        except AttributeError:
            pass
        out[f"knn_topk {name}"] = row
        del q, p, valid, bias
        torch.cuda.empty_cache()
    for name, (B, C, D) in SIMS_SHAPES.items():
        if "knn_sims" not in kernels or (only and name not in only):
            continue
        r = np.random.default_rng(0)
        q, p = unit_rows(r, (B, D)), unit_rows(r, (C, D))
        valid = torch.ones(C, dtype=torch.bool, device="cuda")
        sims = knn.masked_sims_cuda(q, p, valid)
        row = {"ms": min(device_ms(lambda: knn.masked_sims_cuda(q, p, valid))
                         for _ in range(3)),
               "max_abs_err": (sims - knn.masked_sims_ref(q, p, valid)).abs().max().item()}
        try:        # what each version of the package reports
            info = knn.sims_info()
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            row["splits"] = knn.sims_splits(B, C, D, info, sms)[0]
            row["instantiation"] = info
        except AttributeError:
            pass
        out[f"knn_sims {name}"] = row
        del q, p, valid, sims
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "gpu": torch.cuda.get_device_name(0), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
