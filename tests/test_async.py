"""Async + worker execution modes (tests/async/async.test.mjs parity and the
worker offload surface the reference leaves untested)."""

import asyncio

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame
from divortio_lz4.aio import (
    compress_async,
    create_async_compress_stream,
    create_async_decompress_stream,
    decompress_async,
)
from divortio_lz4.scheduler import Scheduler
from divortio_lz4.worker import LZ4Worker


def test_async_oneshot_roundtrip(compressible):
    data = bytes(compressible(300_000))

    async def run():
        frame = await compress_async(data,
                                     config=FrameConfig(block_size=65536),
                                     chunk_size=50_000)
        out = await decompress_async(frame, chunk_size=8192)
        return out

    assert asyncio.run(run()) == data


def test_async_cross_validates_with_sync(compressible):
    data = bytes(compressible(100_000))

    async def run():
        return await compress_async(data, config=FrameConfig(block_size=65536))

    frame = asyncio.run(run())
    out = decompress_frame(np.frombuffer(frame, dtype=np.uint8))
    assert bytes(out) == data


def test_async_stream_pipe(compressible):
    data = bytes(compressible(150_000))
    chunks = [data[i: i + 20_000] for i in range(0, len(data), 20_000)]

    async def run():
        cs = create_async_compress_stream(FrameConfig(block_size=65536))
        comp = b""
        async for part in cs.pipe(chunks):
            comp += part
        ds = create_async_decompress_stream()
        out = b""
        async for part in ds.pipe([comp[i: i + 10_000]
                                   for i in range(0, len(comp), 10_000)]):
            out += part
        return out

    assert asyncio.run(run()) == data


def test_scheduler_fifo_limits_concurrency():
    order = []

    async def run():
        sched = Scheduler(1)
        running = 0
        peak = 0

        async def task(i):
            nonlocal running, peak
            running += 1
            peak = max(peak, running)
            await asyncio.sleep(0.001)
            order.append(i)
            running -= 1
            return i

        results = await asyncio.gather(
            *[sched.schedule(lambda i=i: task(i)) for i in range(5)])
        return results, peak

    results, peak = asyncio.run(run())
    assert results == [0, 1, 2, 3, 4]
    assert peak == 1  # concurrency cap respected
    assert order == [0, 1, 2, 3, 4]  # FIFO


def test_scheduler_rejects_bad_concurrency():
    with pytest.raises(ValueError):
        Scheduler(0)


def test_worker_buffer_roundtrip(compressible):
    data = compressible(100_000)
    frame = LZ4Worker.compress(data,
                               config=FrameConfig(block_size=65536)).result()
    out = LZ4Worker.decompress(np.array(frame)).result()
    np.testing.assert_array_equal(out, data)


def test_worker_stream_roundtrip(compressible):
    data = bytes(compressible(150_000))
    chunks = [data[i: i + 30_000] for i in range(0, len(data), 30_000)]
    frame = LZ4Worker.compress_stream(
        chunks, config=FrameConfig(block_size=65536)).result()
    out = LZ4Worker.decompress_stream(
        [frame[i: i + 9000] for i in range(0, len(frame), 9000)]).result()
    assert out == data


def test_worker_error_propagates():
    fut = LZ4Worker.decompress(b"\x00\x00\x00\x00not-a-frame")
    with pytest.raises(ValueError, match="Magic"):
        fut.result()


def test_worker_map_compress_parallel(compressible):
    payloads = [compressible(50_000) for _ in range(8)]
    frames = list(LZ4Worker.map_compress(payloads,
                                         config=FrameConfig(block_size=65536)))
    for frame, payload in zip(frames, payloads):
        np.testing.assert_array_equal(decompress_frame(np.array(frame)),
                                      payload)


def test_worker_process_pool_roundtrip():
    """Process-pool offload: real parallelism on any backend (the
    structured-clone postMessage analog)."""
    from divortio_lz4.worker import LZ4Worker

    data = np.frombuffer(b"process pool payload " * 3000, np.uint8)
    try:
        LZ4Worker.configure(max_workers=2, use_processes=True)
        futs = [LZ4Worker.compress(data) for _ in range(3)]
        frames = [f.result(timeout=60) for f in futs]
        for fr in frames:
            np.testing.assert_array_equal(
                LZ4Worker.decompress(np.array(fr)).result(timeout=60), data)
        # stream tasks still work (routed to the thread side)
        chunks = [data[i:i + 10000] for i in range(0, len(data), 10000)]
        fr = LZ4Worker.compress_stream(chunks).result(timeout=60)
        out = LZ4Worker.decompress_stream([fr]).result(timeout=60)
        assert bytes(out) == bytes(data)
    finally:
        LZ4Worker.configure(use_processes=False)
