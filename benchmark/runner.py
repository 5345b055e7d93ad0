"""Benchmark suite runner — per-size × per-path tables, median-of-N.

Reference counterparts: benchRunner.js (5 samples, median by throughput,
per-size tables, :20-21,66-69,80-87) and benchUtils.js (50 ms warm-up,
adaptive batch calibration to >=50 ms, ratio, :25-92). Subprocess isolation
per sample is replaced by jit/JIT warm-up in-process.

Usage:
    python -m benchmark.runner [--sizes 1,5,25] [--paths host,stream,worker]
    python -m benchmark.runner --silesia          # per-file table (real or
                                                  # local-mix fallback)
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

import numpy as np

from .corpus import silesia_files, silesia_like, synthetic_json
from .sysinfo import banner

WARMUP_S = 0.05
TARGET_S = 0.05
SAMPLES = 5


def measure(fn: Callable[[], object], nbytes: int) -> dict:
    """Warm up, calibrate batch to >=TARGET_S, take SAMPLES medians."""
    fn()  # cold call (jit/allocations)
    # Warm-up loop (benchUtils.js:29-36).
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        fn()
    # Batch calibration (benchUtils.js:39-53).
    batch = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        dt = time.perf_counter() - t0
        if dt >= TARGET_S or batch >= 1024:
            break
        batch = max(batch * 2, int(batch * TARGET_S / max(dt, 1e-9)) + 1)
    samples = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        samples.append((time.perf_counter() - t0) / batch)
    t = float(np.median(samples))
    return {"time_ms": t * 1e3, "mbps": nbytes / t / 1e6}


def _paths(block_size: int):
    """Named (compress_fn, decompress_fn) builders over a corpus."""
    import divortio_lz4 as lz4

    cfg = lz4.FrameConfig(block_size=block_size, block_independence=True)

    def host(data):
        out_buf = np.empty(len(data) * 2 + 65536, np.uint8)
        frame = np.array(lz4.compress(data, config=cfg, output_buffer=out_buf))
        return (lambda: lz4.compress(data, config=cfg, output_buffer=out_buf),
                lambda: lz4.decompress(frame), len(frame))

    def stream(data):
        db = bytes(data)
        step = max(len(db) // 8, 1)
        chunks = [db[i: i + step] for i in range(0, len(db), step)]
        from divortio_lz4.stream import CompressStream, DecompressStream
        frame = b"".join(CompressStream(cfg).pipe(chunks))
        fch = [frame[i: i + step] for i in range(0, len(frame), step)]
        return (lambda: b"".join(CompressStream(cfg).pipe(chunks)),
                lambda: b"".join(DecompressStream().pipe(fch)), len(frame))

    def worker(data):
        from divortio_lz4.worker import LZ4Worker
        frame = np.array(LZ4Worker.compress(data, config=cfg).result())
        return (lambda: LZ4Worker.compress(data, config=cfg).result(),
                lambda: LZ4Worker.decompress(frame).result(), len(frame))

    def device(data):
        # The split engines: chain-direct encode, region decode kernel.
        from divortio_lz4.parallel import (device_compress_frame,
                                               device_decompress_frame)
        frame = np.array(device_compress_frame(data, cfg, engine="split"))
        return (lambda: device_compress_frame(data, cfg, engine="split"),
                lambda: device_decompress_frame(frame, engine="split"),
                len(frame))

    def device_xla(data):
        from divortio_lz4.parallel import (device_compress_frame,
                                               device_decompress_frame)
        frame = np.array(device_compress_frame(data, cfg))
        return (lambda: device_compress_frame(data, cfg),
                lambda: device_decompress_frame(frame), len(frame))

    paths = {"host": host, "stream": stream, "worker": worker,
             "device": device, "device-xla": device_xla}

    # Comparator adapters (the reference's libs tower, benchmark/src/libs/**):
    # every codec the environment provides becomes a path — gzip/zstd/bz2/xz
    # always here; python-lz4/snappy where installed.
    from .libs import registry

    def make_lib_path(adapter):
        def lib_path(data):
            db = bytes(data)
            frame = adapter.compress(db)
            return (lambda: adapter.compress(db),
                    lambda: adapter.decompress(frame), len(frame))
        return lib_path

    for name, adapter in registry().items():
        if name != "divortio-lz4":  # our own paths are the host/device rows
            paths[name] = make_lib_path(adapter)
    return paths


def run_suite(sizes_mb, path_names, block_size=4 * 1024 * 1024):
    print(banner(), file=sys.stderr)
    builders = _paths(block_size)
    rows = []
    for mb in sizes_mb:
        data = synthetic_json(int(mb * 1e6))
        for name in path_names:
            comp_fn, dec_fn, frame_len = builders[name](data)
            c = measure(comp_fn, len(data))
            d = measure(dec_fn, len(data))
            rows.append({
                "size_mb": mb, "path": name,
                "compress_mbps": round(c["mbps"], 1),
                "decompress_mbps": round(d["mbps"], 1),
                "ratio": round(len(data) / frame_len, 2),
            })
            print(f"  {mb:>6.1f}MB {name:>7}: "
                  f"C {c['mbps']:>8.1f} MB/s  D {d['mbps']:>8.1f} MB/s  "
                  f"ratio {len(data) / frame_len:.2f}x", file=sys.stderr)
    return rows


def run_silesia(block_size=65536, paths=("host",)):
    """Per-file corpus table (real Silesia if present, local mix fallback)."""
    print(banner(), file=sys.stderr)
    files = silesia_files()
    if files is None:
        files = {"local-mix-16mb": silesia_like(16_000_000)}
        print("  (no $SILESIA_DIR; using deterministic local mix)",
              file=sys.stderr)
    builders = _paths(block_size)
    rows = []
    totals = {p: [0.0, 0.0, 0] for p in paths}
    for fname, data in files.items():
        for p in paths:
            comp_fn, dec_fn, frame_len = builders[p](data)
            c = measure(comp_fn, len(data))
            d = measure(dec_fn, len(data))
            rows.append({"file": fname, "path": p, "bytes": len(data),
                         "compress_mbps": round(c["mbps"], 1),
                         "decompress_mbps": round(d["mbps"], 1),
                         "ratio": round(len(data) / frame_len, 3)})
            totals[p][0] += len(data) / 1e6 / (c["time_ms"] / 1e3)
            totals[p][1] += len(data) / 1e6 / (d["time_ms"] / 1e3)
            totals[p][2] += 1
            print(f"  {fname:>16} {p:>6}: C {c['mbps']:>8.1f} "
                  f"D {d['mbps']:>8.1f} MB/s ratio "
                  f"{len(data) / frame_len:.3f}x", file=sys.stderr)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,5,25")
    ap.add_argument("--paths", default="host,stream,worker")
    ap.add_argument("--block", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--silesia", action="store_true")
    args = ap.parse_args()
    if args.silesia:
        rows = run_silesia(block_size=args.block,
                           paths=tuple(args.paths.split(",")))
    else:
        rows = run_suite([float(s) for s in args.sizes.split(",")],
                         args.paths.split(","), args.block)
    import json
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
