"""ctypes bindings for the C++ WordPiece tokenizer and flat L2 index under
``native/``.

Counterpart of ``adaptive_classifier_tpu/native.py``.  The shared library
is compiled from the repository's own ``native/wordpiece.cpp`` and
``native/flat_index.cpp`` with ``g++`` at first use, into
``_build/native-<hash of the sources, compiler and flags>/libacnative.so``
inside this package (written under a temporary name and moved into place,
so concurrent first uses and a cut-off build leave nothing half-written).
Nothing is written under ``native/``.  Without a compiler, or if the build
fails, :func:`load_native` returns None and the tokenizer keeps its Python
path, whose ids are identical.

``NativeWordPiece`` encodes rows on the library's thread pool;
``encode_counts`` counts the rows and batches it encoded
(``reset_encode_counts`` zeroes them).  ``FlatIndexL2`` is an exact L2
index on the host (the ``IndexFlatL2`` interface), a test oracle for the
prototype search.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent
NATIVE_SRC = _PKG.parent / "native"
SOURCES = ("wordpiece.cpp", "flat_index.cpp")
HEADERS = ("unicode_tables.h",)
BUILD_ROOT = _PKG / "_build"
#: no ``-march=native``: the library must run on any x86-64 host the
#: checkout (and its ``_build/``) is copied to; the flat index, the only
#: loop that vectorizes much further with it, is a test oracle
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

#: rows and batches encoded by the library (NativeWordPiece.encode_batch)
encode_counts: Dict[str, int] = {"rows": 0, "batches": 0}
_counts_lock = threading.Lock()


class BuildInfo:
    """What the first :func:`load_native` did (read by chip_smoke.py)."""

    path: Optional[Path] = None
    seconds: float = 0.0
    compiled: bool = False
    error: str = ""


def reset_encode_counts():
    with _counts_lock:
        for k in encode_counts:
            encode_counts[k] = 0


def find_compiler() -> Optional[str]:
    """``$CXX`` if set, else ``g++`` on ``$PATH``; None without one."""
    return os.environ.get("CXX") or shutil.which("g++")


def _digest(cxx: str) -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode() + (NATIVE_SRC / name).read_bytes())
    h.update(" ".join([cxx] + CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless it exists for the current hash → its path.
    Raises if there is no compiler or the compiler fails."""
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    out_dir = BUILD_ROOT / f"native-{_digest(cxx)}"
    path = out_dir / "libacnative.so"
    BuildInfo.compiled = not path.exists()
    if not BuildInfo.compiled:
        return path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".libacnative.so.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_SRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} timed out after {BUILD_TIMEOUT_S}s") from e
    BuildInfo.seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int32_p = ctypes.POINTER(ctypes.c_int32)
    # tokenizer
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = ctypes.c_int32
    lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                              c_int32_p, ctypes.c_int32]
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, c_int32_p, c_int32_p, ctypes.c_int32]
    # flat index
    lib.fi_create.restype = ctypes.c_void_p
    lib.fi_create.argtypes = [ctypes.c_int64]
    lib.fi_free.argtypes = [ctypes.c_void_p]
    lib.fi_ntotal.restype = ctypes.c_int64
    lib.fi_ntotal.argtypes = [ctypes.c_void_p]
    lib.fi_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.fi_reset.argtypes = [ctypes.c_void_p]
    lib.fi_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fi_search.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None if it cannot be built or
    loaded (the reason is in ``BuildInfo.error``)."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                path = build()
                _lib = _declare(ctypes.CDLL(str(path)))
                BuildInfo.path = path
            except (RuntimeError, OSError) as e:
                BuildInfo.error = str(e)
                logger.debug(f"native library unavailable: {e}")
        return _lib


def native_available() -> bool:
    return load_native() is not None


class NativeWordPiece:
    """BERT basic + WordPiece tokenization in C++, ids equal to the Python
    ``WordPieceTokenizer``'s."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {BuildInfo.error}")
        self._lib = lib
        tokens = [""] * (max(vocab.values()) + 1)
        for tok, idx in vocab.items():
            tokens[idx] = tok
        blob = "\n".join(tokens).encode("utf-8")
        self._handle = lib.wp_create(blob, len(blob), int(do_lower_case))

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None) is not None:
            self._lib.wp_free(self._handle)
            self._handle = None

    def encode(self, text: str, max_length: int) -> np.ndarray:
        """``[CLS] ids [SEP]`` of one text, at most ``max_length`` ids."""
        if max_length < 2:
            raise ValueError(f"max_length must be >= 2 ([CLS]+[SEP]), got {max_length}")
        b = text.encode("utf-8", errors="ignore")
        out = np.zeros(max_length, np.int32)
        n = self._lib.wp_encode(self._handle, b, len(b),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                max_length)
        return out[:n]

    def encode_batch(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(ids [N, max_length], lengths [N])``: row i's ids are
        ``ids[i, :lengths[i]]``."""
        if max_length < 2:
            raise ValueError(f"max_length must be >= 2 ([CLS]+[SEP]), got {max_length}")
        n = len(texts)
        bufs = [t.encode("utf-8", errors="ignore") for t in texts]
        arr = (ctypes.c_char_p * n)(*bufs)
        lens = np.asarray([len(b) for b in bufs], np.int64)
        out = np.zeros((n, max_length), np.int32)
        out_lens = np.zeros(n, np.int32)
        self._lib.wp_encode_batch(
            self._handle, arr, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_length)
        with _counts_lock:
            encode_counts["rows"] += n
            encode_counts["batches"] += 1
        return out, out_lens


class FlatIndexL2:
    """Exact L2 index on the host: ``add``, ``search(queries, k)`` →
    ``(squared distances [nq, k], ids [nq, k])`` (-1 past ``ntotal``),
    ``remove``, ``reset``."""

    def __init__(self, dim: int):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {BuildInfo.error}")
        self._lib = lib
        self.dim = dim
        self._handle = lib.fi_create(dim)

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None) is not None:
            self._lib.fi_free(self._handle)
            self._handle = None

    @property
    def ntotal(self) -> int:
        return int(self._lib.fi_ntotal(self._handle))

    def add(self, vecs: np.ndarray):
        vecs = np.ascontiguousarray(vecs, np.float32).reshape(-1, self.dim)
        self._lib.fi_add(self._handle, vecs.shape[0],
                         vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def reset(self):
        self._lib.fi_reset(self._handle)

    def remove(self, row: int):
        self._lib.fi_remove(self._handle, row)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.ascontiguousarray(queries, np.float32).reshape(-1, self.dim)
        nq = queries.shape[0]
        d = np.zeros((nq, k), np.float32)
        i = np.zeros((nq, k), np.int64)
        self._lib.fi_search(
            self._handle, nq, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), k,
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return d, i
