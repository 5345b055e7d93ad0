#!/usr/bin/env python
"""Smoke test of the codec's device path on one NVIDIA GPU.

    python chip_smoke.py           # one card: phases (a)-(e), the gpu-marked
                                   # tests, and the kernel comparison
    python chip_smoke.py --four    # four cards: the sharded codec only

Phases, each through the entry points a user calls, on data generated
from fixed seeds:

  (a) lz4.compress_frames / lz4.decompress_frames: a 256 MB silesia-like
      mix as 8 frames of 32 MB, 64 KB independent blocks;
  (b) the same calls on the reference's own benchmark config: 25 MB of
      repeated JSON, 4 MB independent blocks, no checksum;
  (c) one 32 MB linked frame, 64 KB blocks, 64 KB dictionary, through
      device_compress_frame / device_decompress_frame(engine="split");
  (d) ShardedCodec(make_mesh(1), engine="best"), 32 MB;
  (e) LZ4Decoder(backend="device") fed a 64 KB-block frame in chunks.

Every output is compared byte for byte with the input, every device-made
frame is also decoded by the native host tier, and the compressed size is
held to the native encoder's (ratio <= 1.0) in (a), (c) and (d). The
kernel phase runs the region decode kernel (ops/gpu_decode) and the plain
XLA decode on the same blocks, compares both with the input, and times
them, device time and end to end by route. Any failure exits non-zero
before the last line is printed; the last line is one JSON object naming
the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(out.returncode == 0 and lines, "nvidia-smi found no card")
    return lines


def run_gpu_tests():
    """The gpu-marked tests, in a child process that owns the card while
    this process has not touched JAX yet (one JAX process per card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    tail = res.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"gpu-marked tests: rc={res.returncode} {tail[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], sep="\n")
        fail("gpu-marked tests failed")


def rle_heavy(n: int, seed: int = 5):
    """Short-period runs (offsets 1-8) between short literal gaps: every
    match overlaps its own source, the case the kernel's barrier covers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < n:
        p = int(rng.integers(1, 9))
        run = np.tile(rng.integers(0, 256, p, dtype=np.uint8),
                      int(rng.integers(20, 400)))
        gap = rng.integers(0, 256, int(rng.integers(1, 30)), dtype=np.uint8)
        parts += [run, gap]
        total += len(run) + len(gap)
    return np.concatenate(parts)[:n]


class Phase:
    """Times a phase: set-up (first call, compiles included) and steady."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"--- phase {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"    phase {self.name} done in "
                  f"{time.perf_counter() - self.t0:.2f} s", flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def median_time(fn, runs: int) -> float:
    import numpy as np

    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_a(lz4, np):
    from benchmark.corpus import silesia_like

    data = silesia_like(256 * MB)
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    datas = [data[i * 32 * MB:(i + 1) * 32 * MB] for i in range(8)]
    _, t_setup = timed(lambda: lz4.decompress_frames(
        lz4.compress_frames(datas[:1], cfg)))
    frames, t_enc = timed(lambda: lz4.compress_frames(datas, cfg))
    outs, t_dec = timed(lambda: lz4.decompress_frames(frames))
    comp = ref = 0
    for d, f, o in zip(datas, frames, outs):
        check(np.array_equal(np.asarray(o), d), "(a) decode differs")
        check(np.array_equal(np.asarray(lz4.decompress(f)), d),
              "(a) host decode of a device frame differs")
        r = len(lz4.compress(d, config=cfg))
        check(len(f) <= r, f"(a) frame larger than native: {len(f)} > {r}")
        comp += len(f)
        ref += r
    print(f"    (a) {len(data)} B in 8 frames -> {comp} B, ratio vs native "
          f"{comp / ref:.6f}, bit-exact; set-up (compile) {t_setup:.2f} s, "
          f"encode {t_enc:.2f} s, decode {t_dec:.2f} s", flush=True)
    return datas, frames


def phase_b(lz4, np):
    from benchmark.corpus import synthetic_json

    data = synthetic_json(25_000_000)
    cfg = lz4.FrameConfig(block_size=4 * MB, block_independence=True,
                          content_checksum=False)
    _, t_setup = timed(lambda: lz4.decompress_frames(
        lz4.compress_frames([data[:5 * MB]], cfg)))
    (frame,), t_enc = timed(lambda: lz4.compress_frames([data], cfg))
    (out,), t_dec = timed(lambda: lz4.decompress_frames([frame]))
    check(np.array_equal(np.asarray(out), data), "(b) decode differs")
    check(np.array_equal(np.asarray(lz4.decompress(frame)), data),
          "(b) host decode of a device frame differs")
    ref = len(lz4.compress(data, config=cfg))
    print(f"    (b) {len(data)} B -> {len(frame)} B, ratio vs native "
          f"{len(frame) / ref:.6f}, bit-exact; set-up (compile) "
          f"{t_setup:.2f} s, encode {t_enc:.2f} s, decode {t_dec:.2f} s",
          flush=True)
    return data, frame


def phase_c(lz4, np):
    from benchmark.corpus import silesia_like
    from divortio_lz4.parallel.device import (
        device_compress_frame, device_decompress_frame)

    corpus = silesia_like(32 * MB + 65536, seed=0xC0FFEE)
    dictionary, data = corpus[:65536], corpus[65536:]
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame, t_enc = timed(lambda: device_compress_frame(
        data, cfg, dictionary=dictionary, engine="split"))
    out, t_dec = timed(lambda: device_decompress_frame(
        frame, engine="split", dictionary=dictionary))
    check(np.array_equal(np.asarray(out), data), "(c) decode differs")
    check(np.array_equal(np.asarray(
        lz4.decompress(frame, dictionary=dictionary)), data),
        "(c) host decode of a device frame differs")
    ref = len(lz4.compress(data, config=cfg, dictionary=dictionary))
    check(len(frame) <= ref, f"(c) frame larger than native: "
          f"{len(frame)} > {ref}")
    print(f"    (c) linked {len(data)} B + 64 KB dictionary -> {len(frame)} "
          f"B, ratio vs native {len(frame) / ref:.6f}, bit-exact; encode "
          f"(compile included) {t_enc:.2f} s, decode {t_dec:.2f} s",
          flush=True)
    return data, frame, dictionary


def phase_d(lz4, np, ndev: int = 1, size: int = 32 * MB):
    from benchmark.corpus import silesia_like
    from divortio_lz4.parallel.device import parse_block_index
    from divortio_lz4.parallel.sharding import ShardedCodec, make_mesh

    data = silesia_like(size, seed=0xD)
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    codec = ShardedCodec(make_mesh(ndev), cfg, engine="best")
    frame, t_enc = timed(lambda: codec.compress(data))
    out, t_dec = timed(lambda: codec.decompress(frame))
    check(np.array_equal(np.asarray(out), data), "(d) decode differs")
    check(np.array_equal(np.asarray(lz4.decompress(frame)), data),
          "(d) host decode of a sharded frame differs")
    ref = len(lz4.compress(data, config=cfg))
    check(len(frame) <= ref, f"(d) frame larger than native: "
          f"{len(frame)} > {ref}")
    header, blocks, _ = parse_block_index(np.asarray(frame))
    (_, _, wire, _), totals, _ = codec.stage_decode(np.asarray(frame),
                                                    blocks, header)
    devs = sorted(str(s.device) for s in wire.addressable_shards)
    check(len(set(devs)) == ndev, f"(d) staged shards on {devs}")
    print(f"    (d) ShardedCodec x{ndev}: {len(data)} B -> {len(frame)} B, "
          f"ratio vs native {len(frame) / ref:.6f}, bit-exact; staged "
          f"shards on {len(set(devs))} distinct devices {devs}; encode "
          f"(compile included) {t_enc:.2f} s, decode {t_dec:.2f} s",
          flush=True)


def phase_e(lz4, np):
    from benchmark.corpus import silesia_like
    from divortio_lz4.stream import LZ4Decoder

    data = silesia_like(8 * MB, seed=0xE)
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True,
                          content_checksum=True)
    frame = np.asarray(lz4.compress(data, config=cfg)).tobytes()
    dec = LZ4Decoder(backend="device")
    parts, step = [], 1 << 20
    for i in range(0, len(frame), step):
        parts += [bytes(c) for c in dec.update(frame[i: i + step])]
    check(b"".join(parts) == data.tobytes(), "(e) stream decode differs")
    check(dec.stats["device_blocks"] > 0, "(e) no block decoded on device")
    print(f"    (e) stream decode {len(data)} B in {step} B chunks, "
          f"bit-exact; stats {dec.stats}", flush=True)


def e2e_routes(np, name, frames, datas, dictionary):
    """End-to-end decode of *frames* by each route, outputs compared with
    the input, median wall time of 3: the region kernel (host parse +
    kernel), the XLA decode after the same host parse (the split route's
    validation), the bare XLA decode (engine="xla": no malformed-input
    errors), and the split route as decompress_frames routes it."""
    from divortio_lz4.ops.gpu_decode import decode_frame_body
    from divortio_lz4.parallel.device import (
        _validate_blocks, _dict_window, device_decompress_frame,
        device_decompress_frames, parse_block_index)

    window = _dict_window(dictionary)[0]
    parsed = [parse_block_index(np.asarray(f)) for f in frames]

    def kernel():
        pend = [decode_frame_body(np.asarray(f), blocks, hdr["block_max"],
                                  hdr["independent"], window)
                for f, (hdr, blocks, _) in zip(frames, parsed)]
        return [np.asarray(o)[:t] for o, t in pend]

    def xla_validated():
        outs = []
        for f, (hdr, blocks, _) in zip(frames, parsed):
            _validate_blocks(np.asarray(f), blocks, hdr, window)
            outs.append(device_decompress_frame(f, engine="xla",
                                                dictionary=dictionary))
        return outs

    routes = {
        "region_kernel": kernel,
        "xla_validated": xla_validated,
        "xla": lambda: device_decompress_frames(frames, engine="xla",
                                                dictionary=dictionary),
        "split_routed": lambda: device_decompress_frames(
            frames, dictionary=dictionary),
    }
    total = sum(len(d) for d in datas)
    for route, fn in routes.items():
        outs = fn()
        check(all(np.array_equal(np.asarray(o), d)
                  for o, d in zip(outs, datas)),
              f"e2e {name} {route}: bytes differ")
        t = median_time(fn, 3)
        print(f"    e2e {name} {route}: {t * 1e3:.1f} ms = "
              f"{total / t / 1e6:.1f} MB/s", flush=True)


def kernel_comparison(lz4, np, jax, a_frames, a_datas, b_frame, b_data,
                      c_frame, c_data, c_dict):
    """Region kernel vs plain XLA decode on the same blocks: bit-exactness,
    device time (block_until_ready, inputs already on the card) and end to
    end decompress MB/s."""
    import jax.numpy as jnp

    from divortio_lz4.ops.decode_xla import decode_blocks_batch
    from divortio_lz4.ops.gpu_decode import (
        padded_inputs, plan_regions, region_kernel)
    from divortio_lz4.ops.route import kernel_interpret
    from divortio_lz4.ops.hybrid_encode import build_dist_chains
    from divortio_lz4.parallel.device import parse_block_index

    rows = []

    def kernel_case(name, frame, data, independent=True, window=None):
        frame = np.asarray(frame)
        header, blocks, _ = parse_block_index(frame)
        bs = header["block_max"]
        plan = plan_regions(frame, blocks, bs, independent,
                            0 if window is None else len(window))
        meta, recs, wire, hist, out_len = padded_inputs(plan, window)
        args = [jax.device_put(x) for x in (meta, recs, wire, hist)]
        compiled = region_kernel.lower(
            *args, out_len=out_len, interpret=kernel_interpret()).compile()
        out = np.asarray(compiled(*args))[: plan.total]
        check(np.array_equal(out, data), f"kernel {name}: bytes differ")
        t_k = median_time(lambda: compiled(*args).block_until_ready(), 5)
        row = dict(case=name, bytes=len(data), block=bs,
                   regions=len(plan.meta), records=len(plan.recs),
                   triton_ms=t_k * 1e3,
                   triton_memory=str(compiled.memory_analysis()))
        if independent:
            m = 1
            while m < max(s for _, s, _ in blocks):
                m <<= 1
            comp = np.zeros((len(blocks), m), np.uint8)
            lens = np.zeros(len(blocks), np.int32)
            for i, (o, s, st) in enumerate(blocks):
                if not st:
                    comp[i, :s] = frame[o: o + s]
                    lens[i] = s
            xargs = [jax.device_put(comp), jax.device_put(lens),
                     jnp.zeros((len(blocks), 65536), jnp.uint8)]
            xo, xl = decode_blocks_batch(*xargs, bs)
            xo, xl = np.asarray(xo).astype(np.uint8), np.asarray(xl)
            pos = 0
            for i, (o, s, st) in enumerate(blocks):
                n = s if st else int(xl[i])
                if not st:
                    check(np.array_equal(xo[i, :n], data[pos: pos + n]),
                          f"xla {name}: bytes differ in block {i}")
                pos += n
            t_x = median_time(lambda: jax.block_until_ready(
                decode_blocks_batch(*xargs, bs)), 3)
            row["xla_ms"] = t_x * 1e3
        rows.append(row)
        print(f"    kernel {json.dumps(row)}", flush=True)

    with Phase("kernels: region kernel vs XLA decode"):
        kernel_case("mix_64KB", a_frames[0], a_datas[0])
        mb_cfg = lz4.FrameConfig(block_size=MB, block_independence=True)
        kernel_case("mix_1MB", lz4.compress(a_datas[1], config=mb_cfg),
                    a_datas[1])
        kernel_case("json_4MB", b_frame, b_data)
        rle = rle_heavy(8 * MB)
        rle_frame = lz4.compress(rle, config=lz4.FrameConfig(
            block_size=65536, block_independence=True))
        kernel_case("rle_64KB", rle_frame, rle)
        kernel_case("linked_dict_64KB", c_frame, c_data, independent=False,
                    window=np.asarray(c_dict)[-65536:])

    with Phase("end to end: decompress MB/s by route"):
        cases = (("mix_64KB_8x32MB", a_frames, a_datas, None),
                 ("json_4MB_25MB", [b_frame], [b_data], None),
                 ("linked_dict_32MB", [c_frame], [c_data], c_dict))
        for name, frames, datas, dictionary in cases:
            e2e_routes(np, name, frames, datas, dictionary)

    with Phase("chains: card vs CPU on one batch"):
        w = np.asarray(a_datas[0][: 32 * 65536]).astype(np.int32)
        w = w.reshape(32, 65536)
        lens = np.full(32, 65536, np.int32)
        hs = np.zeros(32, np.int32)
        gpu = np.asarray(build_dist_chains(w, lens, 0, hs))
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = np.asarray(build_dist_chains(w, lens, 0, hs))
        diff = int((gpu != cpu).sum())
        print(f"    chains 32 x 64 KB: {diff} of {gpu.size} positions "
              f"differ between card and CPU (a sort tie broken "
              f"differently changes bytes, not validity)", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded codec over four cards")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    cards = card_lines()
    if not args.four:
        run_gpu_tests()

    import numpy as np
    import jax

    devs = jax.devices()
    print(f"jax.devices(): {devs}", flush=True)
    check(devs[0].platform == "gpu",
          f"no GPU: JAX platform is {devs[0].platform}")
    need = 4 if args.four else 1
    check(len(devs) >= need, f"{need} cards needed, {len(devs)} found")
    import divortio_lz4 as lz4
    from divortio_lz4.utils.compile_cache import enable_compile_cache

    check(lz4.NATIVE_AVAILABLE, "native host tier unavailable")
    enable_compile_cache()

    if args.four:
        with Phase("four cards: ShardedCodec(make_mesh(4), 'best'), 128 MB"):
            phase_d(lz4, np, ndev=4, size=128 * MB)
    else:
        with Phase("(a) 64 KB frames, 256 MB mix"):
            a_datas, a_frames = phase_a(lz4, np)
        with Phase("(b) reference config: 25 MB JSON, 4 MB blocks"):
            b_data, b_frame = phase_b(lz4, np)
        with Phase("(c) linked 32 MB frame with a 64 KB dictionary"):
            c_data, c_frame, c_dict = phase_c(lz4, np)
        with Phase("(d) ShardedCodec on one card, 32 MB"):
            phase_d(lz4, np)
        with Phase("(e) streaming device bursts"):
            phase_e(lz4, np)
        kernel_comparison(lz4, np, jax, a_frames, a_datas, b_frame, b_data,
                          c_frame, c_data, c_dict)

    for line in cards:
        print(f"card: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
