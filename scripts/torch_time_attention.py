"""Time the port's bf16 attention kernels B1 (packed QKV), B6 (flash) and
B7 (one-shot) on one NVIDIA GPU, for an A/B of two versions of the package
in one call.

    python3 scripts/torch_time_attention.py [--root DIR]

``--root`` is a directory holding an ``adaptive_classifier_tpu_torch``
package (default: this checkout), so a copy of another commit's package,
unpacked with ``git archive`` into a git-ignored directory, is timed by the
same code; run the two roots in turns (parent, change, change, parent), one
process each.  Each kernel runs at the banking-intents chunk ``[256, 32]`` x
8 heads, the hallucination-detector chunk ``[256, 128]`` x 8 and bert-base
``[32, 512]`` x 12, Dh 64, on seeded random q, k, v (views of one packed
``[B, S, 3D]`` tensor) and ragged masks.  A time is the device's, in ms per
call: the best of three runs of 50 calls, the stream held by a GPU sleep
until the host has queued all 50.  Each line also gives the max abs error
against the plain version, the share of outputs equal to the plain
version's bit for bit and, where the package reports it, the launched
instantiation's registers, blocks per SM, spill bytes and shared bytes.
Prints one JSON line; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SHAPES = {"banking": (256, 32, 8, 64), "hallucination": (256, 128, 8, 64),
          "bert-base": (32, 512, 12, 64)}


def device_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(60e6))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(B, S, H, Dh, seed=0):
    """A packed ``[B, S, 3D]`` bf16 tensor, its q, k, v views and a ragged
    mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * Dh), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(max(1, S // 4), S + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    D = H * Dh
    return qkv, [qkv[..., j * D:(j + 1) * D].unflatten(-1, (H, Dh)) for j in range(3)], mask


def row(fn, ref, info=None) -> dict:
    got, want = fn(), ref()
    out = {"ms": min(device_ms(fn) for _ in range(3)),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bit_equal_share": (got.reshape(want.shape) == want).float().mean().item()}
    if info is not None:
        out.update(info())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_attention: no CUDA device", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from adaptive_classifier_tpu_torch.ops import attention_qkv as aq, flash_attention as fa

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (B, S, H, Dh) in SHAPES.items():
        qkv, (q, k, v), mask = inputs(B, S, H, Dh)
        out[f"attention_qkv {name}"] = row(
            lambda: aq.attention_from_qkv(qkv, mask, H, Dh),
            lambda: aq.attention_from_qkv_ref(qkv, mask, H, Dh),
            (lambda: aq.kernel_info(qkv, H, Dh)) if hasattr(aq, "kernel_info") else None)
        for kern in ("flash_attention", "oneshot_attention"):
            f, ref = getattr(fa, kern), getattr(fa, kern + "_ref")
            out[f"{kern} {name}"] = row(
                lambda: f(q, k, v, mask), lambda: ref(q, k, v, mask),
                (lambda: fa.kernel_info(q, k, v, kern == "oneshot_attention"))
                if hasattr(fa, "kernel_info") else None)
    print(json.dumps({"root": root, "gpu": torch.cuda.get_device_name(0), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
