"""Where a CUDA source's kernels spill, by source line.

    python3 scripts/cuda_spill_sites.py adaptive_classifier_tpu_torch/csrc/ffn_block_int8.cu

Compiles one source of ``adaptive_classifier_tpu_torch/csrc`` for sm_90a
with the package's flags plus ``-lineinfo`` into a cubin, disassembles it
with ``nvdisasm -g`` and counts, for each kernel, the local-memory stores
and loads (``STL``, ``LDL``) under each ``## File ..., line N`` marker.
Prints ptxas's stack and spill report, then the most frequent sites of each
kernel that has any (``--top`` of them).  Needs the CUDA toolkit (nvcc,
nvdisasm); runs no kernel.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="a .cu file under adaptive_classifier_tpu_torch/csrc")
    ap.add_argument("--top", type=int, default=8, help="sites shown a kernel")
    args = ap.parse_args()
    from adaptive_classifier_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    nvdisasm = str(Path(nvcc).with_name("nvdisasm"))
    src = Path(args.source).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        # the package's flags, less those of a shared library
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        ptxas = subprocess.run([nvcc, *flags, "-lineinfo", "-cubin",
                                "-o", str(cubin), str(src)], cwd=src.parent,
                               capture_output=True, text=True)
        if ptxas.returncode:
            print(ptxas.stderr, file=sys.stderr)
            return ptxas.returncode
        sass = subprocess.run([nvdisasm, "-g", "-c", str(cubin)], capture_output=True,
                              text=True, check=True).stdout
    for line in ptxas.stderr.splitlines():
        if "Compiling entry" in line or "stack frame" in line:
            print(line.strip()[:200])
    sites = collections.defaultdict(collections.Counter)
    kernel, where = None, None
    for line in sass.splitlines():
        m = re.search(r"\.text\.(\S+):", line)
        if m:
            kernel = m.group(1)
        m = re.search(r'## File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{Path(m.group(1)).name}:{m.group(2)}"
        m = re.search(r"\b(STL|LDL)\b", line)
        if m:
            sites[kernel][(m.group(1), where)] += 1
    for kernel, counts in sites.items():
        print(f"== {kernel}: {sum(counts.values())} local stores and loads")
        for (op, where), n in counts.most_common(args.top):
            print(f"  {op} {where} x{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
