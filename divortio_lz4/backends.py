"""Host block-kernel backend registry.

The frame layer is backend-agnostic: any object exposing the single block ABI
(SURVEY §7 Phase 0) can drive it. Two host backends ship:

- "python": the scalar oracle in ops/block_ref.py (always available)
- "native": C++ kernels via ctypes (divortio_lz4/native), registered at
  import time when the shared library builds; byte-identical output.

The device path (ops/encode_xla.py, ops/decode_xla.py) is batch-oriented and is
orchestrated separately by parallel/ — it is not a per-block host backend.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .ops.block_ref import (
    compress_block_ref,
    decompress_block_ref,
    new_hash_table,
    warm_hash_table,
)


class Backend:
    """A host block-kernel implementation bundle.

    compress_frame_body / decompress_frame_body are optional whole-frame
    block-loop kernels (one native call per frame instead of per block);
    the frame layer falls back to its per-block Python loop when absent.
    """

    def __init__(self, name: str,
                 compress_block: Callable,
                 decompress_block: Callable,
                 warm_table: Callable,
                 compress_frame_body: Optional[Callable] = None,
                 decompress_frame_body: Optional[Callable] = None):
        self.name = name
        self.compress_block = compress_block
        self.decompress_block = decompress_block
        self.warm_table = warm_table
        self.compress_frame_body = compress_frame_body
        self.decompress_frame_body = decompress_frame_body


_REGISTRY: Dict[str, Backend] = {}
_DEFAULT: Optional[str] = None


def register_backend(backend: Backend, make_default: bool = False) -> None:
    global _DEFAULT
    _REGISTRY[backend.name] = backend
    if make_default or _DEFAULT is None:
        _DEFAULT = backend.name


def get_backend(name: Optional[str] = None) -> Backend:
    if name is None:
        name = _DEFAULT
    if name not in _REGISTRY:
        raise KeyError(f"LZ4: unknown backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends():
    return sorted(_REGISTRY)


register_backend(Backend(
    "python",
    compress_block=compress_block_ref,
    decompress_block=decompress_block_ref,
    warm_table=warm_hash_table,
))
