"""FrameConfig — the single typed configuration object.

The reference threads positional defaulted parameters through every layer
(`(dictionary, maxBlockSize, blockIndependence, contentChecksum,
addContentSize, outputBuffer)`, bufferCompress.js:100 / streamCompress.js:21 /
lz4Encode.js:104), which drifted between call sites (SURVEY §2.9.3). This
framework uses one dataclass everywhere instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from .constants import BLOCK_MAX_SIZES, DEFAULT_BLOCK_SIZE, get_block_id


@dataclass(frozen=True)
class FrameConfig:
    """Configuration for LZ4 frame encoding.

    Attributes:
      block_size: requested max block size; quantized to 64K/256K/1M/4M.
      block_independence: if True, each block is self-contained (parallel
        decode; slightly lower ratio). Default False (linked blocks), matching
        the reference default.
      content_checksum: append xxHash32 of the whole plaintext.
      content_size: store the 64-bit plaintext size in the header (enables
        single-allocation direct-write decode).
      block_checksums: write a 4-byte xxHash32 after each block. The reference
        parses this flag but never writes or verifies block checksums
        (bufferDecompress.js:190-191); this framework fully supports them
        (BASELINE config 2 requires them).
      favor_ratio: when True the XLA encoder spends extra passes for exact
        long-match extension; host encoders ignore it.
    """

    block_size: int = DEFAULT_BLOCK_SIZE
    block_independence: bool = False
    content_checksum: bool = False
    content_size: bool = True
    block_checksums: bool = False
    favor_ratio: bool = True

    @property
    def block_id(self) -> int:
        return get_block_id(self.block_size)

    @property
    def resolved_block_size(self) -> int:
        return BLOCK_MAX_SIZES[self.block_id]

    def with_(self, **kw) -> "FrameConfig":
        return replace(self, **kw)


DEFAULT_CONFIG = FrameConfig()
