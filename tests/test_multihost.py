"""Multi-host orchestration (single-process degenerate path) + CLI."""

import subprocess
import sys

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame
from divortio_lz4.parallel.multihost import (
    MultiHostCodec,
    shard_bounds,
    split_frames,
    maybe_distributed_init,
)


def test_shard_bounds_cover_exactly():
    total = 1_000_003
    for nshards in (1, 2, 3, 7, 8):
        spans = [shard_bounds(total, nshards, i) for i in range(nshards)]
        assert spans[0][0] == 0 and spans[-1][1] == total
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c
        assert all(b >= a for a, b in spans)


def test_maybe_distributed_init_single_process():
    assert maybe_distributed_init() is False


def test_multihost_codec_single_process(compressible):
    codec = MultiHostCodec(FrameConfig(block_size=65536,
                                       block_independence=True))
    data = np.asarray(compressible(200_000))
    stream = codec.compress_corpus(data)
    assert stream is not None
    # Stream decodes with the host frame decoder (single frame) and the
    # multihost decoder (concatenated-frames path).
    np.testing.assert_array_equal(
        decompress_frame(np.frombuffer(stream, np.uint8)), data)
    out = codec.decompress_corpus(stream)
    np.testing.assert_array_equal(out, data)


def test_split_frames_concatenated(compressible):
    a = np.asarray(compressible(120_000))
    b = np.asarray(compressible(50_000))[::-1].copy()
    f1 = compress_frame(a, config=FrameConfig(block_size=65536,
                                              content_checksum=True))
    f2 = compress_frame(b, config=FrameConfig(block_size=65536,
                                              block_independence=True))
    skip = np.frombuffer(
        b"\x50\x2a\x4d\x18\x04\x00\x00\x00PAYL", np.uint8)
    stream = np.concatenate([f1, skip, f2])
    frames = split_frames(stream)
    assert len(frames) == 2
    (s1, e1), (s2, e2) = frames
    assert s1 == 0 and e1 == len(f1)
    assert s2 == len(f1) + len(skip) and e2 == len(stream)
    np.testing.assert_array_equal(decompress_frame(stream[s1:e1]), a)
    np.testing.assert_array_equal(decompress_frame(stream[s2:e2]), b)


def test_multihost_decode_simulated_two_process(compressible):
    """Simulate the >=2-process frame partitioning without the distributed
    runtime: run each pid's shard selection + device decode, stitch in
    order, and compare with the plain decode (SURVEY §4 fake-cluster
    strategy)."""
    codec = MultiHostCodec(FrameConfig(block_size=65536,
                                       block_independence=True))
    data = np.asarray(compressible(300_000))
    # Build what a 2-process compress_corpus would emit: one frame/shard.
    half = len(data) // 2
    s0 = codec.codec.compress(data[:half])
    s1 = codec.codec.compress(data[half:])
    stream = np.concatenate([np.asarray(s0), np.asarray(s1)])
    frames = split_frames(stream)
    assert len(frames) == 2
    parts = []
    for pid in range(2):
        lo, hi = shard_bounds(len(frames), 2, pid)
        for a, b in frames[lo:hi]:
            parts.append(np.asarray(codec.codec.decompress(
                np.array(stream[a:b])), dtype=np.uint8))
    np.testing.assert_array_equal(np.concatenate(parts), data)


def test_cli_roundtrip(tmp_path, compressible):
    data = bytes(compressible(300_000))
    src = tmp_path / "file.bin"
    src.write_bytes(data)
    comp = tmp_path / "file.bin.lz4"
    out = tmp_path / "file.out"
    r1 = subprocess.run(
        [sys.executable, "-m", "divortio_lz4", "compress", str(src),
         "-o", str(comp), "--checksum", "-b", "65536"],
        capture_output=True, text=True, cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"})
    assert r1.returncode == 0, r1.stderr
    assert comp.stat().st_size < len(data)
    r2 = subprocess.run(
        [sys.executable, "-m", "divortio_lz4", "decompress", str(comp),
         "-o", str(out)],
        capture_output=True, text=True, cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"})
    assert r2.returncode == 0, r2.stderr
    assert out.read_bytes() == data
