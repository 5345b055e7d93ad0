#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line on stdout (re-emitted after
every tier, the last line is the complete record).

Headline metric: encode+decode GB/s of the native host tier on a
silesia-like mixed corpus at 64 KB independent blocks, plus device tiers
(the chain-direct encoder and the region decode kernel) when a GPU is
present. Baseline for vs_baseline is the published reference round-trip
rate: 484 MB/s compress + 459 MB/s decompress on 25 MB
(docs/BENCHMARKS.md:21-22) → 1/(1/484+1/459) = 235.6 MB/s.

Also verifies round-trip bit-exactness and reports the compressed-size ratio
vs the reference-identical host encoder on stderr (gate: ours <= reference).
Device tiers run only on a GPU; any device failure exits non-zero.

Usage: python bench.py [--quick] [--size-mb N] [--host] [--runs R]
"""

import argparse
import glob
import json
import sys
import time

import numpy as np


def build_corpus(size: int, seed: int = 0x51E51A) -> np.ndarray:
    """Deterministic silesia-like mix: structured text, source code, binary,
    JSON logs, RLE runs, random."""
    rng = np.random.default_rng(seed)
    parts = []

    def file_bytes(paths, cap):
        data = b""
        for p in paths:
            try:
                with open(p, "rb") as f:
                    data += f.read()
            except OSError:
                continue
            if len(data) >= cap:
                break
        return np.frombuffer(data[:cap], np.uint8)

    chunk = size // 8
    # text/code (≈ silesia dickens/samba/webster)
    py_files = sorted(glob.glob("/usr/local/lib/python3.12/**/*.py",
                                recursive=True))
    parts.append(file_bytes(py_files, 2 * chunk))
    # binary executables (≈ mozilla/ooffice)
    bin_files = ["/usr/bin/g++-12", "/usr/bin/cmake", "/bin/bash"]
    parts.append(file_bytes(bin_files, 2 * chunk))
    # JSON event logs (the reference's synthetic corpus, benchUtils.js:7-22)
    rec = (b'{"ts":1700000000,"level":"info","service":"api-gateway",'
           b'"msg":"request completed","status":200,"latency_ms":%d,'
           b'"path":"/v1/users/%d"}\n')
    logs = b"".join(rec % (i % 900, i * 7919 % 100000)
                    for i in range(2 * chunk // 120 + 1))
    parts.append(np.frombuffer(logs[: 2 * chunk], np.uint8))
    # long runs (≈ x-ray/sao backgrounds)
    runs = np.repeat(rng.integers(0, 256, max(size // 16 // 512, 1),
                                  dtype=np.uint8), 512)
    parts.append(runs[: size // 16])
    # incompressible
    parts.append(rng.integers(0, 256, size // 16, dtype=np.uint8))

    corpus = np.concatenate(parts)
    if len(corpus) < size:
        reps = -(-size // len(corpus))
        corpus = np.tile(corpus, reps)
    return corpus[:size]


CHUNK_ROWS = 64  # canonical batch shape: one compile serves any corpus size


def device_info() -> dict:
    """The device every device figure was taken on: JAX's view plus the
    card's name and power limit from nvidia-smi."""
    import subprocess

    import jax

    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "not available"
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "nvidia_smi": smi}


def _median_time(fn, runs: int) -> float:
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_device(corpus: np.ndarray, block_size: int, runs: int):
    """The all-XLA data-parallel kernels (encode_xla / decode_xla) over
    fixed-shape row chunks, device-resident inputs, block_until_ready."""
    import jax
    import jax.numpy as jnp

    from divortio_lz4.constants import WINDOW_SIZE, block_bound
    from divortio_lz4.ops.decode_xla import decode_blocks_batch
    from divortio_lz4.ops.encode_xla import encode_blocks_batch

    n = len(corpus)
    nb = -(-n // block_size)
    nchunks = -(-nb // CHUNK_ROWS)
    rows = nchunks * CHUNK_ROWS
    flat = np.zeros(rows * block_size, np.int32)
    flat[:n] = corpus
    work = flat.reshape(rows, block_size)
    lens = np.zeros(rows, np.int32)
    lens[:nb] = block_size
    lens[nb - 1] = n - (nb - 1) * block_size

    d_work = [jax.device_put(work[i * CHUNK_ROWS:(i + 1) * CHUNK_ROWS])
              for i in range(nchunks)]
    d_lens = [jax.device_put(lens[i * CHUNK_ROWS:(i + 1) * CHUNK_ROWS])
              for i in range(nchunks)]
    d_h0 = jnp.zeros(CHUNK_ROWS, jnp.int32)

    def enc():
        return jax.block_until_ready(
            [encode_blocks_batch(w, l, 0, True, d_h0)
             for w, l in zip(d_work, d_lens)])

    enc_res = enc()  # compile + warm
    t_enc = _median_time(enc, runs)

    max_comp = max(int(np.asarray(l).max()) for _, l in enc_res)
    m_cap = 4096
    while m_cap < max_comp:
        m_cap <<= 1
    m_cap = min(m_cap, block_bound(block_size))
    comps = [o[:, :m_cap] for o, _ in enc_res]
    clens = [l for _, l in enc_res]
    d_hist = jnp.zeros((CHUNK_ROWS, WINDOW_SIZE), jnp.int32)

    def dec():
        return jax.block_until_ready(
            [decode_blocks_batch(c, l, d_hist, block_size)
             for c, l in zip(comps, clens)])

    dec_res = dec()
    t_dec = _median_time(dec, runs)

    ok = True
    for ci in range(nchunks):
        dec_np = np.asarray(dec_res[ci][0])
        dec_lens = np.asarray(dec_res[ci][1])
        base = ci * CHUNK_ROWS
        for r in range(CHUNK_ROWS):
            li = int(lens[base + r])
            if int(dec_lens[r]) != li or not np.array_equal(
                    dec_np[r, :li].astype(np.uint8),
                    work[base + r, :li].astype(np.uint8)):
                ok = False
    comp_bytes = int(sum(int(np.asarray(l).sum()) for l in clens)) \
        + 4 * nb + 11
    return t_enc, t_dec, comp_bytes, ok, jax.devices()[0].device_kind


def bench_device_frames(corpus: np.ndarray, block_size: int, runs: int):
    """End-to-end device frame path: device_compress_frame /
    device_decompress_frame with engine="split", transfers, block-index
    scan, record parse and frame assembly included."""
    import jax

    import divortio_lz4 as lz4
    from divortio_lz4.parallel.device import (
        device_compress_frame, device_decompress_frame)

    cfg = lz4.FrameConfig(block_size=block_size, block_independence=True)
    frame = device_compress_frame(corpus, cfg, engine="split")  # warm
    t_enc = _median_time(
        lambda: device_compress_frame(corpus, cfg, engine="split"), runs)
    out = device_decompress_frame(frame, engine="split")
    ok = np.array_equal(np.asarray(out), corpus)
    t_dec = _median_time(
        lambda: device_decompress_frame(frame, engine="split"), runs)
    return t_enc, t_dec, len(frame), ok, jax.devices()[0].device_kind


def bench_device_pipelined(corpus: np.ndarray, block_size: int, runs: int,
                           nframes: int = 8):
    """Multi-frame pipelined e2e path: the corpus splits into *nframes*
    frames through lz4.compress_frames / lz4.decompress_frames. Returns
    (t_enc, t_dec, comp_total, ok)."""
    import divortio_lz4 as lz4
    from divortio_lz4.parallel.device import (
        device_compress_frames, device_decompress_frames)

    cfg = lz4.FrameConfig(block_size=block_size, block_independence=True)
    fs = len(corpus) // nframes
    datas = [corpus[i * fs: (i + 1) * fs] for i in range(nframes)]
    frames = device_compress_frames(datas, cfg)  # compile + warm
    t_enc = _median_time(lambda: device_compress_frames(datas, cfg), runs)
    outs = device_decompress_frames(frames)
    ok = all(np.array_equal(np.asarray(o), d)
             for o, d in zip(outs, datas))
    t_dec = _median_time(lambda: device_decompress_frames(frames), runs)
    return t_enc, t_dec, sum(len(f) for f in frames), ok


def bench_split_decode(corpus: np.ndarray, block_size: int, runs: int):
    """Region decode kernel (ops/gpu_decode) on host-encoded blocks: host
    record parse time, kernel time on device-resident inputs, and the
    bytes shipped to the device relative to the plaintext. Returns
    (bytes, t_parse, t_kernel, wire_ratio)."""
    import jax

    import divortio_lz4 as lz4
    from divortio_lz4.ops.gpu_decode import (
        decode_regions, padded_inputs, plan_regions)
    from divortio_lz4.parallel.device import parse_block_index

    cfg = lz4.FrameConfig(block_size=block_size, block_independence=True)
    frame = np.asarray(lz4.compress(corpus, config=cfg))
    header, blocks, _ = parse_block_index(frame)
    plan = plan_regions(frame, blocks, block_size)
    t_parse = _median_time(
        lambda: plan_regions(frame, blocks, block_size), runs)
    meta, recs, wire, hist, out_len = padded_inputs(plan)
    args = [jax.device_put(x) for x in (meta, recs, wire, hist)]

    def kernel():
        return decode_regions(*args, out_len).block_until_ready()

    out = np.asarray(kernel())[: plan.total]
    assert np.array_equal(out, corpus), "region decode bytes differ"
    t_kern = _median_time(kernel, runs)
    shipped = sum(x.nbytes for x in (meta, recs, wire))
    return plan.total, t_parse, t_kern, shipped / plan.total


def bench_chain_encode(corpus: np.ndarray, block_size: int, runs: int):
    """Chain-direct encoder figures: device candidate chains on
    device-resident rows + the native host select/extend/serialize tail.
    Output is decode-verified and sized against the reference encoder.
    Returns (bytes, t_chains, t_serialize, comp, ref_total)."""
    import jax

    import divortio_lz4 as lz4
    from divortio_lz4.ops.split_encode import (
        chain_select_serialize, encode_blocks_chain)
    from divortio_lz4.utils.pool import host_pool

    n = len(corpus)
    nb = n // block_size
    if nb == 0:
        raise ValueError("corpus too small for chain encode bench")
    work = corpus[: nb * block_size].astype(np.int32) \
        .reshape(nb, block_size)
    d_work = jax.device_put(work)
    d_lens = jax.device_put(np.full(nb, block_size, np.int32))

    def chains():
        return encode_blocks_chain(d_work, d_lens,
                                   block_size).block_until_ready()

    ch_np = np.asarray(chains())
    t_chain = _median_time(chains, runs)

    ex = host_pool()
    corpus_pad = np.zeros(nb * block_size + 8, np.uint8)
    corpus_pad[: nb * block_size] = corpus[: nb * block_size]

    def _ser_one(i):
        return chain_select_serialize(
            corpus_pad[i * block_size: (i + 1) * block_size + 8],
            0, block_size, ch_np[i])

    outs = list(ex.map(_ser_one, range(nb)))
    t_ser = _median_time(lambda: list(ex.map(_ser_one, range(nb))), runs)
    comp = sum(len(o) for o in outs)
    ref_total = 0
    buf = np.empty(block_size, np.uint8)
    for i in range(nb):
        r = np.asarray(lz4.compress_raw(
            corpus[i * block_size:(i + 1) * block_size]))
        ref_total += min(len(r), block_size)
        assert lz4.decompress_raw(outs[i], buf) == block_size
        assert np.array_equal(buf,
                              corpus[i * block_size:(i + 1) * block_size])
    return nb * block_size, t_chain, t_ser, comp, ref_total


def bench_device_bigblock(corpus: np.ndarray, runs: int):
    """Device tier at the reference's DEFAULT config (4 MB blocks,
    bufferCompress.js:100): segmented encode (parallel/bigblock.py) and the
    region decode kernel, end to end. Returns (t_enc, t_dec, comp_len,
    ok)."""
    import divortio_lz4 as lz4
    from divortio_lz4.parallel.bigblock import compress_frame_big
    from divortio_lz4.parallel.device import device_decompress_frame

    cfg = lz4.FrameConfig(block_size=4194304, block_independence=True)
    frame = compress_frame_big(corpus, cfg)  # compile + warm
    t_enc = _median_time(lambda: compress_frame_big(corpus, cfg), runs)
    out = device_decompress_frame(frame, engine="split")
    ok = np.array_equal(np.asarray(out), corpus)
    t_dec = _median_time(
        lambda: device_decompress_frame(frame, engine="split"), runs)
    return t_enc, t_dec, len(frame), ok


def bench_host(corpus: np.ndarray, block_size: int, runs: int):
    import divortio_lz4 as lz4
    cfg = lz4.FrameConfig(block_size=block_size, block_independence=True)
    out_buf = np.empty(len(corpus) * 2 + 4096, np.uint8)
    frame = np.array(lz4.compress(corpus, config=cfg, output_buffer=out_buf))
    t_enc, t_dec = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        frame_v = lz4.compress(corpus, config=cfg, output_buffer=out_buf)
        t_enc.append(time.perf_counter() - t0)
    frame = np.array(frame_v)
    for _ in range(runs):
        t0 = time.perf_counter()
        out = lz4.decompress(frame)
        t_dec.append(time.perf_counter() - t0)
    ok = np.array_equal(out, corpus)
    return (float(np.median(t_enc)), float(np.median(t_dec)), len(frame), ok,
            "host")


class Emitter:
    """Incremental headline emission (VERDICT r4 #1): the driver parses the
    LAST JSON line on stdout, so a complete record is (re)printed after
    EVERY tier — a wall-clock kill at any point still leaves a parseable
    line carrying everything measured so far. Flushed: the process may die
    by SIGKILL with no chance to drain buffers."""

    def __init__(self):
        self.rec = {
            "metric": ("encode+decode GB/s, silesia-like mix, 64KB blocks, "
                       "host C++ tier (structured per-tier fields "
                       "alongside; device figures name their device); "
                       "vs_baseline measured on the reference's own "
                       "corpus+config vs its published 235.6 MB/s"),
            "value": 0.0,
            "unit": "GB/s",
            "vs_baseline": 0.0,
        }

    def update(self, **kw):
        self.rec.update(kw)
        print(json.dumps(self.rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--size-mb", type=float, default=32.0)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--host", action="store_true",
                    help="bench only the native host path")
    ap.add_argument("--device-size-mb", type=float, default=32.0,
                    help="corpus slice for the device tiers")
    args = ap.parse_args()
    if args.quick:
        args.size_mb = min(args.size_mb, 4.0)
        args.device_size_mb = min(args.device_size_mb, 4.0)
        args.runs = min(args.runs, 2)

    t_start = time.monotonic()

    emit = Emitter()
    emit.update()  # a parseable stub lands before any work starts

    size = int(args.size_mb * 1e6)
    corpus = build_corpus(size)

    # Reference-identical host encoder for the ratio gate.
    import divortio_lz4 as lz4
    ref_cfg = lz4.FrameConfig(block_size=args.block, block_independence=True)
    ref_frame_len = len(lz4.compress(corpus, config=ref_cfg))

    gb = size / 1e9
    baseline_rt_gbps = 1.0 / (1 / 0.484 + 1 / 0.459)  # published reference

    def report(tag, res, nbytes, ref_len, block=None):
        t_enc, t_dec, comp_bytes, ok, plat = res
        g = nbytes / 1e9
        rt = g / (t_enc + t_dec)
        ratio_vs_ref = comp_bytes / ref_len
        print(
            f"bench[{tag}/{plat}]: {nbytes / 1e6:.0f}MB, "
            f"block={block or args.block}: enc {g / t_enc:.3f} GB/s, "
            f"dec {g / t_dec:.3f} GB/s, roundtrip {rt:.4f} GB/s, "
            f"compressed {comp_bytes} ({ratio_vs_ref:.4f}x vs reference "
            f"encoder {'OK' if ratio_vs_ref <= 1.0 else 'REGRESSION'}), "
            f"bit-exact={'yes' if ok else 'NO'}",
            file=sys.stderr)
        return rt, ok

    # Host tier: the production per-machine codec path (the reference's own
    # numbers are CPU numbers — like-for-like).
    host_res = bench_host(corpus, args.block, args.runs)
    host_rt, host_ok = report("host", host_res, size, ref_frame_len)
    t_enc_h, t_dec_h, comp_h, _, _ = host_res
    emit.update(
        value=round(host_rt, 4) if host_ok else 0.0,
        host_roundtrip_gbps=round(host_rt, 4),
        host_enc_gbps=round(gb / t_enc_h, 4),
        host_dec_gbps=round(gb / t_dec_h, 4),
        host_ratio_vs_reference=round(comp_h / ref_frame_len, 4),
        host_bit_exact=host_ok,
    )

    # vs_baseline: the reference's published 484/459 MB/s were taken on
    # ITS synthetic repeated-JSON corpus with 4MB independent blocks
    # (benchUtils.js:7-22, benchWorker.js:53-54) — measured like-for-like
    # on this host tier.
    sys.path.insert(0, __import__("os").path.dirname(
        __import__("os").path.abspath(__file__)))
    from benchmark.corpus import synthetic_json
    ref_corpus = np.asarray(synthetic_json(min(size, 25_000_000)))
    refcfg_res = bench_host(ref_corpus, 4194304, args.runs)
    ref_rt, ref_ok = report(
        "host-refcfg", refcfg_res, len(ref_corpus),
        len(lz4.compress(ref_corpus,
                         config=lz4.FrameConfig(block_size=4194304,
                                                block_independence=True))),
        block=4194304)
    emit.update(
        vs_baseline=round(ref_rt / baseline_rt_gbps, 2),
        refcfg_roundtrip_gbps=round(ref_rt, 4),
    )

    # Device tiers: need a GPU; any failure raises and exits non-zero.
    dev_rt, dev_ok = 0.0, True
    if not args.host:
        import jax

        from divortio_lz4.utils.compile_cache import enable_compile_cache

        if jax.devices()[0].platform != "gpu":
            raise SystemExit("bench: device tiers need a GPU (use --host "
                             "for the host tier alone)")
        enable_compile_cache()
        info = device_info()
        kind = info["device_kind"]
        print(f"bench: device {info}", file=sys.stderr)
        emit.update(device=info)
        dev_size = min(size, int(args.device_size_mb * 1e6))
        runs = max(args.runs, 3)

        from benchmark.corpus import synthetic_json
        for tag, c in (("", corpus[:dev_size]),
                       ("refcorpus_", np.asarray(synthetic_json(dev_size)))):
            pb, ptp, ptk, pwr = bench_split_decode(c, args.block, runs)
            print(f"bench[device-{tag}split-decode/{kind}]: "
                  f"{pb / 1e6:.0f}MB kernel {ptk * 1e3:.2f} ms = "
                  f"{pb / ptk / 1e6:.1f} MB/s; host parse "
                  f"{ptp * 1e3:.1f} ms; ships {pwr:.2f}x plaintext bytes",
                  file=sys.stderr)
            emit.update(**{
                f"device_{tag}split_decode_kernel_mbps": pb / ptk / 1e6,
                f"device_{tag}split_decode_parse_ms": ptp * 1e3,
                f"device_{tag}split_wire_ratio": pwr})
            cb, ck, cs, ccomp, cref = bench_chain_encode(c, args.block, runs)
            print(f"bench[device-{tag}chain-encode/{kind}]: "
                  f"{cb / 1e6:.0f}MB chains {ck * 1e3:.2f} ms = "
                  f"{cb / ck / 1e6:.1f} MB/s; + host select/serialize "
                  f"{cs * 1e3:.1f} ms ({ccomp} B out, {ccomp / cref:.4f}x "
                  f"vs reference encoder "
                  f"{'OK' if ccomp <= cref else 'REGRESSION'})",
                  file=sys.stderr)
            emit.update(**{
                f"device_{tag}chain_kernel_mbps": cb / ck / 1e6,
                f"device_{tag}chain_serialize_ms": cs * 1e3,
                f"device_{tag}ratio_vs_reference": ccomp / cref})

        dev_corpus = corpus[:dev_size]
        dev_ref_len = len(lz4.compress(dev_corpus, config=ref_cfg))
        res = bench_device_frames(dev_corpus, args.block, runs)
        dev_rt, dev_ok = report("device", res, dev_size, dev_ref_len)
        emit.update(device_enc_gbps=dev_size / 1e9 / res[0],
                    device_dec_gbps=dev_size / 1e9 / res[1],
                    device_roundtrip_gbps=dev_rt,
                    device_bit_exact=dev_ok)

        pp_enc, pp_dec, pp_comp, pp_ok = bench_device_pipelined(
            dev_corpus, args.block, runs)
        pp_n = (dev_size // 8) * 8
        print(f"bench[device-pipelined/{kind}]: {pp_n / 1e6:.0f}MB as 8 "
              f"frames in flight: enc {pp_n / pp_enc / 1e6:.1f} MB/s, "
              f"dec {pp_n / pp_dec / 1e6:.1f} MB/s, compressed {pp_comp}, "
              f"bit-exact={'yes' if pp_ok else 'NO'}", file=sys.stderr)
        dev_ok = dev_ok and pp_ok
        emit.update(device_pipelined_enc_mbps=pp_n / pp_enc / 1e6,
                    device_pipelined_dec_mbps=pp_n / pp_dec / 1e6)

        bt_enc, bt_dec, bcomp, bok = bench_device_bigblock(dev_corpus, runs)
        print(f"bench[device-bigblock/{kind}]: {dev_size / 1e6:.0f}MB, "
              f"block=4194304: enc {dev_size / bt_enc / 1e6:.1f} MB/s, "
              f"dec {dev_size / bt_dec / 1e6:.1f} MB/s e2e, compressed "
              f"{bcomp}, bit-exact={'yes' if bok else 'NO'}",
              file=sys.stderr)
        dev_ok = dev_ok and bok
        emit.update(device_bigblock_enc_mbps=dev_size / bt_enc / 1e6,
                    device_bigblock_dec_mbps=dev_size / bt_dec / 1e6)

        res = bench_device(dev_corpus, args.block, runs)
        report("device-xla", res, dev_size, dev_ref_len)

    ok = host_ok and dev_ok and ref_ok
    if not ok:
        emit.update(metric="encode+decode GB/s (FAILED roundtrip)",
                    value=0.0, vs_baseline=0.0)
        return
    emit.update(bench_completed=True,
                elapsed_s=round(time.monotonic() - t_start, 1))


if __name__ == "__main__":
    main()
