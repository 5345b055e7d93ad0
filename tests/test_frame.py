"""Frame-level integration tests (parity with tests/buffer/*.test.mjs)."""

import numpy as np
import pytest

from divortio_lz4 import (
    FrameConfig,
    compress_frame,
    decompress_frame,
)


def test_header_magic_and_flags():
    frame = compress_frame(b"some test data here")
    assert bytes(frame[:4]) == bytes([0x04, 0x22, 0x4D, 0x18])
    flg = frame[4]
    assert (flg >> 6) == 1  # version
    assert flg & 0x08  # content size default on


def test_ratio_sanity(compressible):
    data = compressible(100_000)
    cfg = FrameConfig(block_size=65536, block_independence=True)
    frame = compress_frame(data, config=cfg)
    assert len(frame) < len(data) // 4


def test_roundtrip_multiblock_random(rng):
    # >64KB of random data across multiple 64KB blocks; random is
    # incompressible so this exercises the stored-block fallback too.
    data = rng.integers(0, 256, 150_000, dtype=np.uint8)
    cfg = FrameConfig(block_size=65536, block_independence=True)
    frame = compress_frame(data, config=cfg)
    out = decompress_frame(frame)
    np.testing.assert_array_equal(out, data)


def test_roundtrip_multiblock_linked(compressible):
    data = compressible(200_000)
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = compress_frame(data, config=cfg)
    out = decompress_frame(frame)
    np.testing.assert_array_equal(out, data)


def test_linked_beats_independent_ratio(compressible):
    data = compressible(200_000)
    linked = compress_frame(data, config=FrameConfig(block_size=65536))
    indep = compress_frame(
        data, config=FrameConfig(block_size=65536, block_independence=True))
    assert len(linked) <= len(indep)


def test_roundtrip_without_content_size(compressible):
    # Chunked decode strategy with the rolling 64KB window.
    data = compressible(200_000)
    cfg = FrameConfig(block_size=65536, content_size=False)
    frame = compress_frame(data, config=cfg)
    out = decompress_frame(frame)
    np.testing.assert_array_equal(out, data)


def test_content_checksum_roundtrip_and_corruption(compressible):
    data = compressible(10_000)
    cfg = FrameConfig(content_checksum=True)
    frame = np.array(compress_frame(data, config=cfg))
    out = decompress_frame(frame)
    np.testing.assert_array_equal(out, data)
    bad = frame.copy()
    bad[-1] ^= 0x5A
    with pytest.raises(ValueError, match="Content Checksum"):
        decompress_frame(bad)
    out2 = decompress_frame(bad, verify_checksum=False)
    np.testing.assert_array_equal(out2, data)


def test_content_checksum_adds_four_bytes(compressible):
    data = compressible(5000)
    base = compress_frame(data, config=FrameConfig(content_checksum=False))
    with_ck = compress_frame(data, config=FrameConfig(content_checksum=True))
    assert len(with_ck) == len(base) + 4


def test_block_checksums_roundtrip_and_corruption(compressible):
    data = compressible(150_000)
    cfg = FrameConfig(block_size=65536, block_checksums=True,
                      block_independence=True)
    frame = np.array(compress_frame(data, config=cfg))
    assert frame[4] & 0x10  # FLG block-checksum bit
    out = decompress_frame(frame)
    np.testing.assert_array_equal(out, data)
    bad = frame.copy()
    bad[30] ^= 0xFF  # corrupt inside the first block's data
    with pytest.raises(ValueError, match="Checksum"):
        decompress_frame(bad)


def test_empty_input_roundtrip():
    frame = compress_frame(b"")
    out = decompress_frame(frame)
    assert len(out) == 0


def test_output_buffer_zero_alloc(compressible):
    data = compressible(10_000)
    scratch = np.empty(64_000, dtype=np.uint8)
    frame = compress_frame(data, output_buffer=scratch)
    assert frame.base is scratch or frame.base is scratch.base
    out = decompress_frame(np.array(frame))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("bs,bd", [(65536, 0x40), (262144, 0x50),
                                   (1048576, 0x60), (4194304, 0x70)])
def test_block_size_descriptor(bs, bd, compressible):
    frame = compress_frame(compressible(1000),
                           config=FrameConfig(block_size=bs))
    assert frame[5] == bd


def test_string_input_coercion():
    frame = compress_frame("hello hello hello hello hello")
    out = decompress_frame(frame)
    assert bytes(out).decode() == "hello hello hello hello hello"
