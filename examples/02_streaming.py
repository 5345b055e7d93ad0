"""Streaming compression: chunked pipelines and file-to-file.

Reference counterparts: examples/stream/lz4.stream.{fs-pipeline,blob}.js.
"""

import os
import tempfile

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

cfg = lz4.FrameConfig(block_size=65536)

# --- transform-stream pipe over an iterable of chunks ---
chunks = [os.urandom(10_000) for _ in range(3)] + [b"tail " * 2000]
stream = lz4.CompressStream(cfg)
frame = b"".join(stream.pipe(chunks))
out = b"".join(lz4.DecompressStream().pipe([frame]))
assert out == b"".join(chunks)
print(f"pipe: {len(out)} -> {len(frame)}")

# --- manual encoder/decoder state machines ---
enc = lz4.LZ4Encoder(cfg)
parts = []
for c in chunks:
    parts += enc.add(c)
parts += enc.finish()
frame2 = b"".join(bytes(p) for p in parts)

dec = lz4.LZ4Decoder()
restored = b""
for i in range(0, len(frame2), 1000):  # feed in arbitrary fragments
    restored += b"".join(bytes(x) for x in dec.update(frame2[i: i + 1000]))
assert restored == b"".join(chunks)
print("FSM round-trip ok; at frame boundary:", dec.finished_frame)

# --- file-to-file pipeline ---
with tempfile.TemporaryDirectory() as d:
    src = os.path.join(d, "input.bin")
    with open(src, "wb") as f:
        f.write(b"".join(chunks) * 4)
    lz4.compress_file(src, src + ".lz4", cfg)
    lz4.decompress_file(src + ".lz4", src + ".out")
    assert open(src, "rb").read() == open(src + ".out", "rb").read()
    print("file pipeline ok:", os.path.getsize(src), "->",
          os.path.getsize(src + ".lz4"))
