"""Command-line interface: spec-compliant .lz4 file codec.

    python -m divortio_lz4 compress   <in> [-o out.lz4] [options]
    python -m divortio_lz4 decompress <in.lz4> [-o out]
    python -m divortio_lz4 bench      [--quick]

Frames written here interoperate with any LZ4 Frame tool (lz4 CLI, the JS
reference) — golden-vector tested.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="divortio_lz4")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a file to an LZ4 frame")
    c.add_argument("input")
    c.add_argument("-o", "--output", default=None)
    c.add_argument("-b", "--block-size", type=int, default=4194304)
    c.add_argument("--independent", action="store_true",
                   help="block-independent frame (parallel decode)")
    c.add_argument("--checksum", action="store_true",
                   help="append a content checksum")
    c.add_argument("--block-checksums", action="store_true")
    c.add_argument("-D", "--dictionary", default=None)
    c.add_argument("--device", action="store_true",
                   help="run the block codec on the device path")
    c.add_argument("--engine", default="split",
                   choices=["split", "xla"],
                   help="device engine (with --device)")

    d = sub.add_parser("decompress", help="decompress an LZ4 frame file")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None)
    d.add_argument("-D", "--dictionary", default=None)
    d.add_argument("--no-verify", action="store_true")
    d.add_argument("--device", action="store_true")
    d.add_argument("--engine", default="split",
                   choices=["split", "pallas", "xla"],
                   help="device engine (with --device)")

    b = sub.add_parser("bench", help="run the benchmark harness")
    b.add_argument("--quick", action="store_true")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        import subprocess
        import os
        cmd = [sys.executable, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "bench.py")]
        if args.quick:
            cmd.append("--quick")
        return subprocess.call(cmd)

    import numpy as np

    from . import FrameConfig
    from .stream import CompressStream, DecompressStream

    def _stream_io(in_path, out_path, stream):
        """Pipe in->out through a transform stream; '-' = stdin/stdout."""
        fin = sys.stdin.buffer if in_path == "-" else open(in_path, "rb")
        fout = sys.stdout.buffer if out_path == "-" else open(out_path, "wb")
        total_in = total_out = 0
        try:
            while True:
                chunk = fin.read(1 << 22)
                if not chunk:
                    break
                total_in += len(chunk)
                out = stream.write(chunk)
                total_out += len(out)
                fout.write(out)
            tail = stream.flush()
            total_out += len(tail)
            fout.write(tail)
        finally:
            if in_path != "-":
                fin.close()
            if out_path != "-":
                fout.close()
            else:
                fout.flush()
        return total_in, total_out

    dictionary = None
    if args.dictionary:
        with open(args.dictionary, "rb") as f:
            dictionary = np.frombuffer(f.read(), np.uint8)

    t0 = time.perf_counter()
    if args.cmd == "compress":
        out_path = args.output or (
            "-" if args.input == "-" else args.input + ".lz4")
        cfg = FrameConfig(block_size=args.block_size,
                          block_independence=args.independent,
                          content_checksum=args.checksum,
                          block_checksums=args.block_checksums)
        if args.device:
            from .parallel import device_compress_frame
            with open(args.input, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
            frame = device_compress_frame(
                data, cfg.with_(block_independence=True),
                engine=args.engine)
            with open(out_path, "wb") as f:
                f.write(bytes(frame))
            in_size, out_size = len(data), len(frame)
        else:
            in_size, out_size = _stream_io(
                args.input, out_path, CompressStream(cfg, dictionary))
        dt = time.perf_counter() - t0
        print(f"{args.input}: {in_size} -> {out_size} bytes "
              f"({in_size / max(out_size, 1):.2f}x) in {dt * 1e3:.1f} ms "
              f"({in_size / dt / 1e6:.0f} MB/s)", file=sys.stderr)
    else:
        out_path = args.output or (
            "-" if args.input == "-"
            else args.input[:-4] if args.input.endswith(".lz4")
            else args.input + ".out")
        if args.device:
            from .parallel import device_decompress_frame
            with open(args.input, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
            plain = device_decompress_frame(data, not args.no_verify,
                                            engine=args.engine)
            with open(out_path, "wb") as f:
                f.write(bytes(plain))
            in_size, out_size = len(data), len(plain)
        else:
            in_size, out_size = _stream_io(
                args.input, out_path,
                DecompressStream(dictionary, not args.no_verify))
        dt = time.perf_counter() - t0
        print(f"{args.input}: {in_size} -> {out_size} bytes in "
              f"{dt * 1e3:.1f} ms ({out_size / dt / 1e6:.0f} MB/s)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
