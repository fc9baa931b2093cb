"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds); the processes are started together and run in parallel.  The
output goes to ``_build/<hash of the sources and flags>/lib<source>.so``
inside the package, each written under a temporary name and moved into
place, so a build that is cut off leaves nothing that a later call would
reuse.  Libraries that exist for the current hash are loaded as they are.

Nothing here runs at import: the first kernel launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 300

#: C signature of every entry point: (argument types, return type)
_VP, _CI, _CF, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "ac_attention_qkv": ([_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP], _CI),
    "ac_attention_qkv_info": ([_VP] + [_CI] * 5 + [_VP], _CI),
    "ac_flash_attention": ([_VP] * 5 + [_CI] * 4 + [_CL] * 3 + [_CI, _VP], _CI),
    "ac_oneshot_attention": ([_VP] * 5 + [_CI] * 4 + [_CL] * 3 + [_CI, _VP], _CI),
    "ac_flash_attention_info": ([_VP] * 3 + [_CI] * 4 + [_CL] * 3 + [_CI, _CI, _VP], _CI),
    "ac_add_layer_norm": ([_VP] * 4 + [_CF, _VP, _CI, _CI, _CI, _VP], _CI),
    "ac_masked_sims": ([_VP] * 5 + [_CI] * 5 + [_VP], _CI),
    "ac_masked_sims_info": ([_VP], _CI),
    "ac_topk_sims": ([_VP] * 8 + [_CI] * 6 + [_VP], _CI),
    "ac_topk_sims_info": ([_CI, _VP], _CI),
    "ac_quant_matmul_int8": ([_VP] * 5 + [_CI] * 4 + [_VP], _CI),
    "ac_quant_matmul_int8_info": ([_CI] * 4 + [_VP], _CI),
    "ac_proj_residual_ln_int8": ([_VP] * 7 + [_CF, _VP] + [_CI] * 3 + [_VP], _CI),
    "ac_proj_residual_ln_int8_info": ([_CI] * 3 + [_VP], _CI),
    "ac_int8_weight_map": ([_VP, _CL, _CI, _VP], _CI),
    "ac_ffn_block_int8": ([_VP] * 9 + [_CF, _VP, _VP] + [_CI] * 4 + [_VP], _CI),
    "ac_attn_ffn_block_int8": ([_VP] * 15 + [_CF, _VP, _VP] + [_CI] * 4 + [_VP], _CI),
    "ac_ffn_block_int8_smem_bytes": ([_CI] * 2, _CL),
    "ac_ffn_block_int8_scratch_bytes": ([_CI] * 3, _CL),
    "ac_attn_ffn_block_int8_scratch_bytes": ([_CI] * 3, _CL),
    "ac_ffn_block_int8_info": ([_CI] * 4 + [_VP], _CI),
    "ac_cuda_error_string": ([_CI], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


class BuildInfo:
    """What the last :func:`library` call did (read by chip_smoke.py)."""

    path: Optional[Path] = None
    seconds: float = 0.0
    compiled: bool = False
    log: str = ""


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``/``$CUDA_PATH``, ``$PATH``, or the default
    toolkit location."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(sources: List[Path], nvcc: str) -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + sources:
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join([nvcc] + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source whose library does not exist yet for the current
    hash, one nvcc process per source, all started together; → library path
    by source name.  Raises with nvcc's output if any build fails."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _digest(sources, nvcc)
    paths = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources}
    todo = [src for src in sources if not paths[src.stem].exists()]
    BuildInfo.compiled = bool(todo)
    if not todo:
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f".lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, tmp, cmd, proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(
                1.0, BUILD_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {BUILD_TIMEOUT_S}s"
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, paths[src.stem])
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library() -> SimpleNamespace:
    """Every entry point of :data:`SIGNATURES`, by name, with its C
    signature declared; the shared libraries are built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            paths = build()
            libs = [ctypes.CDLL(str(path)) for path in paths.values()]
            fns = {}
            for name, (argtypes, restype) in SIGNATURES.items():
                lib = next((l for l in libs if hasattr(l, name)), None)
                if lib is None:
                    raise RuntimeError(f"no kernel library exports {name}")
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
                fns[name] = fn
            BuildInfo.path = next(iter(paths.values())).parent
            _lib = SimpleNamespace(**fns)
        return _lib


def check(err: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().ac_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
