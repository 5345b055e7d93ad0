"""One-shot buffer compression recipes.

Reference counterparts: examples/buffer/lz4.buffer.{bytes,string,object}.js.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

# --- bytes ---
data = b"The quick brown fox jumps over the lazy dog. " * 1000
frame = lz4.compress(data)
restored = bytes(lz4.decompress(frame))
assert restored == data
print(f"bytes: {len(data)} -> {len(frame)} ({len(data) / len(frame):.1f}x)")

# --- strings (UTF-8 handled automatically) ---
text = "compress me 🚀 " * 500
frame = lz4.compress_string(text)
assert lz4.decompress_string(frame) == text
print(f"string: {len(text)} chars -> {len(frame)} bytes")

# --- JSON objects ---
obj = {"users": [{"id": i, "name": f"user{i}"} for i in range(100)]}
frame = lz4.compress_object(obj)
assert lz4.decompress_object(frame) == obj
print(f"object -> {len(frame)} bytes")

# --- tuned config (the reference's positional args, as one dataclass) ---
cfg = lz4.FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True, block_checksums=True)
frame = lz4.compress(data, config=cfg)
assert bytes(lz4.decompress(frame)) == data
print(f"checksummed 64KB-block frame: {len(frame)} bytes")

# --- zero-allocation output buffer (bufferCompress.js outputBuffer param) ---
scratch = np.empty(2 * len(data), dtype=np.uint8)
view = lz4.compress(data, output_buffer=scratch)
print(f"zero-alloc: wrote {len(view)} bytes into caller buffer")
