"""Async and worker execution modes.

Reference counterparts: examples/stream/lz4.stream.async.js and the
examples/web worker+SharedArrayBuffer demo.
"""

import asyncio

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

data = b"payload for background compression " * 10_000
cfg = lz4.FrameConfig(block_size=65536)


async def async_demo():
    # One-shot promise helpers; chunk work yields the event loop and runs on
    # an executor thread (the native kernels release the GIL).
    frame = await lz4.compress_async(data, config=cfg, chunk_size=100_000)
    out = await lz4.decompress_async(frame)
    assert out == data
    print(f"async: {len(data)} -> {len(frame)}")

    # Async transform streams with a shared FIFO scheduler.
    sched = lz4.Scheduler(concurrency=2)
    cs = lz4.create_async_compress_stream(cfg, scheduler=sched)
    parts = [await cs.write(data[i: i + 50_000])
             for i in range(0, len(data), 50_000)]
    parts.append(await cs.flush())
    frame2 = b"".join(parts)
    ds = lz4.create_async_decompress_stream(scheduler=sched)
    out2 = await ds.write(frame2)
    assert out2 == data
    print("async streams ok")


asyncio.run(async_demo())

# --- worker offload: futures + parallel batch fan-out ---
fut = lz4.LZ4Worker.compress(data, config=cfg)
frame = bytes(fut.result())
assert bytes(lz4.LZ4Worker.decompress(frame).result()) == data
print(f"worker: {len(frame)} bytes via background thread")

payloads = [data[i:] for i in range(0, 40_000, 10_000)]
frames = list(lz4.LZ4Worker.map_compress(payloads, config=cfg))
print(f"worker map: {len(frames)} frames compressed in parallel")
