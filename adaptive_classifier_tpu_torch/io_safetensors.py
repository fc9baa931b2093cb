"""Minimal numpy reader and writer for ``.safetensors`` files.

The format: an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets"}``
(offsets relative to the end of the header), then the raw little-endian
tensor bytes.  An optional ``__metadata__`` entry is skipped.

Stands in for ``safetensors.numpy.load_file`` and ``save_file`` so the port
needs no package beyond torch and numpy.  ``save_file`` writes the tensors
in name order, back to back, the header padded with spaces to 8 bytes.  BF16 has no numpy dtype: it is read as uint16 and
widened to float32 exactly (a bf16 value is the top half of an f32).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Union

import numpy as np

_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "I64": np.dtype("<i8"),
           "I32": np.dtype("<i4"), "I8": np.dtype("i1")}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def load_file(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Read every tensor of a ``.safetensors`` file into a numpy array."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds file size")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= len(body):
            raise ValueError(f"{path}: tensor {name!r} lies outside the file")
        if dtype == "BF16":
            arr = _bf16_to_f32(np.frombuffer(body[start:end], dtype="<u2"))
        elif dtype in _DTYPES:
            arr = np.frombuffer(body[start:end], dtype=_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        count = int(np.prod(shape, dtype=np.int64))
        if arr.size != count:
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} "
                             f"values for shape {shape}")
        # copy: frombuffer views are read-only and pin the whole file
        out[name] = arr.reshape(shape).copy()
    return out


def save_file(tensors: Dict[str, np.ndarray], path: Union[str, Path]) -> None:
    """Write numpy arrays of a dtype in ``_DTYPES`` to a ``.safetensors`` file."""
    names = {dt: name for name, dt in _DTYPES.items()}
    header: Dict[str, dict] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        dt = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
        if dt not in names:
            raise ValueError(f"tensor {name!r} has unsupported dtype {arr.dtype}")
        raw = np.ascontiguousarray(arr, dtype=dt).tobytes()
        header[name] = {"dtype": names[dt], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
