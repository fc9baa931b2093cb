"""Time the port's int8 kernels B2 (QKV projection), B3 (FFN block), B8
(post-attention body) and B9 (projection + residual + LayerNorm) on one
NVIDIA GPU, for an A/B of two versions of the package in one call.
Where a package has ``ffn_block_int8_wgmma`` (B3's function on B8's body,
which earlier versions of the package carried) it is timed beside B3.

    python3 scripts/torch_time_ffn_int8.py [--root DIR]

``--root`` is a directory holding an ``adaptive_classifier_tpu_torch``
package (default: this checkout), so a copy of another commit's package,
unpacked with ``git archive`` into a git-ignored directory, is timed by the
same code; run the two roots in turns (parent, change, change, parent), one
process each.  Each kernel runs at the banking-intents chunk (M = 8,192
rows of D 512, F 2,048; B2's N = 3D = 1,536), the hallucination-detector
chunk (M = 32,768) and a bert-base batch of 32 x 128 (M = 4,096, D 768,
F 3,072, N 2,304); B9 projects through the [D, D] O weight.  ``--only``
takes a comma-separated subset of the wrappers' names.  Seeded random bf16
rows and int8 weights quantized as the port quantizes a checkpoint.  A
time is the device's, in ms per call: the best
of three runs of 20 calls, the stream held by a GPU sleep until the host
has queued them; ``host_ms`` is the host's time per wrapper call (its
Python, checks and launch), the stream held so that no call waits.  Each line also gives the per-row cosine against the
plain version, the share of outputs equal to it bit for bit and, where the
package reports it, the launched instantiation.  Prints one JSON line; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SHAPES = {"banking": (8192, 512, 2048), "hallucination": (32768, 512, 2048),
          "bert-base": (4096, 768, 3072)}


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


def host_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e3


def layer(M, D, F, quantize_weight, seed=0):
    """Rows h and x [M, D] bf16; int8 O, QKV, W1, W2 with scales and
    biases; two LayerNorms."""
    r = np.random.default_rng(seed)

    def vec(n, loc=0.0, scale=0.01):
        return torch.from_numpy((loc + scale * r.standard_normal(n)).astype(np.float32)).cuda()

    mats = {}
    for name, shape in (("o", (D, D)), ("qkv", (D, 3 * D)), ("w1", (D, F)), ("w2", (F, D))):
        q, s = quantize_weight(torch.from_numpy(
            (0.05 * r.standard_normal(shape)).astype(np.float32)))
        mats[name] = (q.cuda(), s.cuda(), vec(shape[1]))
    lns = [(vec(D, 1.0, 0.1), vec(D, 0.0, 0.1)) for _ in range(2)]
    h, x = (torch.from_numpy((0.5 * r.standard_normal((M, D))).astype(np.float32))
            .cuda().to(torch.bfloat16) for _ in range(2))
    return h, x, mats, lns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--only", default="", help="comma-separated wrapper names")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("torch_time_ffn_int8: no CUDA device", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from adaptive_classifier_tpu_torch.ops import ffn_int8 as f8, matmul_int8 as m8
    from adaptive_classifier_tpu_torch.quantization import quantize_weight

    if not f8.__file__.startswith(root):
        raise RuntimeError(f"imported {f8.__file__}, not the package under {root}")
    out = {}
    for name, (M, D, F) in SHAPES.items():
        h, x, m, lns = layer(M, D, F, quantize_weight)
        calls = {"quant_matmul_int8": (m8, (h, *m["qkv"])),
                 "ffn_block_int8": (f8, (h, *m["w1"], *m["w2"], *lns[0], 1e-12)),
                 "ffn_block_int8_wgmma": (f8, (h, *m["w1"], *m["w2"], *lns[0], 1e-12)),
                 "attn_ffn_block_int8": (f8, (h, x, *m["o"], *lns[0], *m["w1"], *m["w2"],
                                              *lns[1], 1e-12)),
                 "proj_residual_ln_int8": (m8, (h, *m["o"], x, *lns[0], 1e-12))}
        for kern, (mod, a) in calls.items():
            if (only and kern not in only) or not hasattr(mod, kern):
                continue
            f = getattr(mod, kern)
            ref = getattr(mod, kern.removesuffix("_wgmma") + "_ref")
            got, want = f(*a), ref(*a)
            g, w = got.float(), want.float()
            row = {"ms": min(device_ms(lambda: f(*a)) for _ in range(3)),
                   "host_ms": host_ms(lambda: f(*a)),
                   "min_row_cosine": ((g * w).sum(1) / (g.norm(dim=1) * w.norm(dim=1)))
                   .min().item(),
                   "bit_equal_share": (got == want).double().mean().item()}
            try:        # what each version of the package reports
                if kern == "quant_matmul_int8":
                    row["instantiation"] = m8.quant_matmul_info(M, D, 3 * D)
                elif kern == "attn_ffn_block_int8":
                    row["instantiation"] = f8.ffn_block_info(D, F, o_proj=True)
                elif kern == "proj_residual_ln_int8":
                    row["instantiation"] = m8.proj_residual_ln_info(M, D)
                elif kern == "ffn_block_int8":
                    row["instantiation"] = f8.ffn_block_info(D, F)
            except (AttributeError, TypeError):
                pass
            out[f"{kern} {name}"] = row
        del h, x, m, lns, calls
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "gpu": torch.cuda.get_device_name(0), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
