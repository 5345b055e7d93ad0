"""Raw (headerless) block API — maximum control, zero framing overhead.

Reference counterpart: examples/buffer/lz4.buffer.raw.js and the
LZ4.compressRaw/decompressRaw facade entries (src/lz4.js:32-33).
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4
from divortio_lz4.constants import block_bound
from divortio_lz4.ops.block_ref import new_hash_table

data = np.frombuffer(b"raw block payload " * 500, np.uint8)

# Managed: allocate-and-return.
comp = lz4.compress_raw(data)
out = np.empty(len(data), np.uint8)  # raw decode needs the exact size
n = lz4.decompress_raw(comp, out)
assert n == len(data) and bytes(out) == bytes(data)
print(f"managed raw: {len(data)} -> {len(comp)}")

# Kernel ABI: caller owns every buffer (zero allocation in the loop).
dst = np.empty(block_bound(len(data)), np.uint8)
table = new_hash_table()
written = lz4.compress_raw(data, dst, 0, len(data), table, 0)
print(f"kernel ABI: wrote {written} bytes at offset 0")

# The same storage can be reused across blocks; clear the table between
# unrelated payloads (it carries match history).
table[:] = 0
written2 = lz4.compress_raw(data[::-1].copy(), dst, 0, len(data), table, 0)
print(f"second block: {written2} bytes")
