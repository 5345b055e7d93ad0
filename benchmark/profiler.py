"""Profiler hooks — device traces for the codec kernels.

Reference counterpart: benchmark/src/profile/profile.compression.js:8-49,
which wraps a fixed-duration workload in V8's inspector profiler and writes a
Chrome-loadable .cpuprofile. The device equivalent wraps the kernels in
jax.profiler and writes a TensorBoard/Perfetto-loadable trace directory
(SURVEY §5.1).

Usage:
    python -m benchmark.profiler [--mode compress|decompress|roundtrip]
                                 [--out .trace] [--seconds 3]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def profile(mode: str = "roundtrip", out_dir: str = ".trace",
            seconds: float = 3.0, size: int = 1_000_000,
            block_size: int = 65536) -> str:
    import jax
    import jax.numpy as jnp

    from divortio_lz4.constants import WINDOW_SIZE, block_bound
    from divortio_lz4.ops.decode_xla import decode_blocks_batch
    from divortio_lz4.ops.encode_xla import encode_blocks_batch
    from .corpus import synthetic_json

    data = synthetic_json(size)
    nb = -(-len(data) // block_size)
    work = np.zeros((nb, block_size), np.int32)
    lens = np.zeros(nb, np.int32)
    for i in range(nb):
        c = data[i * block_size: (i + 1) * block_size]
        work[i, : len(c)] = c
        lens[i] = len(c)
    d_work, d_lens = jnp.asarray(work), jnp.asarray(lens)
    d_h0 = jnp.zeros(nb, jnp.int32)
    d_hist = jnp.zeros((nb, WINDOW_SIZE), jnp.int32)

    def enc():
        return encode_blocks_batch(d_work, d_lens, 0, True, d_h0)

    outs, out_lens = jax.block_until_ready(enc())
    comp = outs[:, : block_bound(block_size)]

    def dec():
        return decode_blocks_batch(comp, out_lens, d_hist, block_size)

    jax.block_until_ready(dec())

    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if mode in ("compress", "roundtrip"):
                jax.block_until_ready(enc())
            if mode in ("decompress", "roundtrip"):
                jax.block_until_ready(dec())
    print(f"trace written to {out_dir} "
          f"(load in TensorBoard or ui.perfetto.dev)", file=sys.stderr)
    return out_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="roundtrip",
                    choices=["compress", "decompress", "roundtrip"])
    ap.add_argument("--out", default=".trace")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    profile(args.mode, args.out, args.seconds)


if __name__ == "__main__":
    main()
