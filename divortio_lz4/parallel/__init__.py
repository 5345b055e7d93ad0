"""Multi-device / multi-host parallel codec (SURVEY §2.6, §5.8, Phase 3).

The reference's only parallel axis is one Web Worker; its real parallel
structure — a frame is a sequence of independently-storable blocks
(bufferCompress.js:209-239) — maps directly onto a device mesh: blocks
shard across devices (data parallel), compressed sizes are combined
with psum/all_gather, and the frame is assembled in order on the host.
"""

from .device import (
    device_compress_frame,
    device_decompress_frame,
    parse_block_index,
)
from .sharding import (
    ShardedCodec,
    make_mesh,
)

__all__ = [
    "device_compress_frame",
    "device_decompress_frame",
    "parse_block_index",
    "ShardedCodec",
    "make_mesh",
]
