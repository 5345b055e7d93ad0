"""Input coercion and little-endian byte helpers.

Analog of the reference's `ensureBuffer` (src/shared/lz4Util.js:13-33):
accepts bytes / str (UTF-8) / numpy or JAX arrays / memoryview / bytearray /
lists of ints / JSON-serializable objects and yields a contiguous uint8 numpy
array.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np


def ensure_buffer(data: Any) -> np.ndarray:
    """Coerce *data* to a 1-D uint8 numpy array (zero-copy where possible)."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.ndim == 1:
            return np.ascontiguousarray(data)
        if data.dtype == np.uint8:
            return np.ascontiguousarray(data).reshape(-1)
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data) if isinstance(data, memoryview) else data,
                             dtype=np.uint8)
    if isinstance(data, str):
        return np.frombuffer(data.encode("utf-8"), dtype=np.uint8)
    # JAX arrays and other array-likes with __array__.
    if hasattr(data, "__array__"):
        arr = np.asarray(data)
        if arr.dtype == np.uint8:
            return np.ascontiguousarray(arr).reshape(-1)
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    if isinstance(data, (list, tuple)):
        return np.asarray(data, dtype=np.uint8)
    if isinstance(data, dict):
        try:
            return np.frombuffer(json.dumps(data).encode("utf-8"), dtype=np.uint8)
        except (TypeError, ValueError):
            pass
    raise TypeError(
        "LZ4: Input must be bytes, str, array, memoryview, list, or a "
        "JSON-serializable object"
    )


def concat_bytes(chunks) -> bytes:
    """Join a list of byte-like chunks into one bytes object."""
    return b"".join(bytes(c) if not isinstance(c, (bytes, bytearray)) else c
                    for c in chunks)


def read_u32le(buf, pos: int) -> int:
    return int(buf[pos]) | (int(buf[pos + 1]) << 8) | (int(buf[pos + 2]) << 16) | (
        int(buf[pos + 3]) << 24)


def write_u32le(buf, pos: int, value: int) -> None:
    buf[pos] = value & 0xFF
    buf[pos + 1] = (value >> 8) & 0xFF
    buf[pos + 2] = (value >> 16) & 0xFF
    buf[pos + 3] = (value >> 24) & 0xFF
