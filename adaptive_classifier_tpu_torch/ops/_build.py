"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

One ``nvcc`` call compiles every ``csrc/*.cu`` into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds).  The
output goes to ``_build/<hash of the sources and flags>/`` inside the
package, written under a temporary name and moved into place, so a build
that is cut off leaves nothing that a later call would reuse.  A library
that exists for the current hash is loaded as it is.

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
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libac_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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


def build() -> Path:
    """Compile the sources if the library for their hash does not exist yet;
    → the library's path.  Raises with nvcc's output if the build fails."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _digest(sources, nvcc)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BuildInfo.compiled = False
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S}s: "
                           f"{' '.join(cmd)}") from e
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{BuildInfo.log}")
    os.replace(tmp, lib_path)
    BuildInfo.compiled = True
    return lib_path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with the C
    signatures of every entry point declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ac_attention_qkv.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
            lib.ac_attention_qkv.restype = ci
            lib.ac_cuda_error_string.argtypes = [ci]
            lib.ac_cuda_error_string.restype = ctypes.c_char_p
            BuildInfo.path = path
            _lib = lib
        return _lib


def check(err: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().ac_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
