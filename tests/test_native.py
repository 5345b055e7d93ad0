"""Native (C++) backend: availability, correctness, and cross-tier parity.

Cross-validation pattern (SURVEY §4): compress with one tier, decompress with
another, in every direction; plus byte-identical encoder output across tiers
(both implement the reference's exact greedy parse + acceleration heuristic).
"""

import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4 import FrameConfig, compress_frame, decompress_frame
from divortio_lz4.constants import block_bound
from divortio_lz4.ops.block_ref import new_hash_table

pytestmark = pytest.mark.skipif(not lz4.NATIVE_AVAILABLE,
                                reason="native library not built")


def test_native_is_default_backend():
    assert lz4.get_backend().name == "native"


def test_native_xxhash_vectors():
    from divortio_lz4.native import xxhash32_native
    assert xxhash32_native(np.frombuffer(b"", dtype=np.uint8), 0) == 0x02CC5D05
    assert xxhash32_native(np.frombuffer(b"Hello World", dtype=np.uint8),
                           0) == 0xB1FD16EE


def test_native_xxhash_matches_python(rng):
    from divortio_lz4.native import xxhash32_native
    from divortio_lz4.xxh.xxhash32 import _xxhash32_py
    for n in (0, 1, 15, 16, 17, 255, 4096, 100_001):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert xxhash32_native(data, 7) == _xxhash32_py(data, 7)


def test_encoders_byte_identical(compressible, rng):
    from divortio_lz4.backends import get_backend
    nat, py = get_backend("native"), get_backend("python")
    for data in (compressible(50_000),
                 rng.integers(0, 256, 10_000, dtype=np.uint8),
                 np.tile(np.frombuffer(b"abcabcabd", dtype=np.uint8), 2000)):
        out_n = np.zeros(block_bound(len(data)), dtype=np.uint8)
        out_p = np.zeros(block_bound(len(data)), dtype=np.uint8)
        n1 = nat.compress_block(data, out_n, 0, len(data), new_hash_table(), 0)
        n2 = py.compress_block(data, out_p, 0, len(data), new_hash_table(), 0)
        assert n1 == n2
        np.testing.assert_array_equal(out_n[:n1], out_p[:n2])


@pytest.mark.parametrize("enc,dec", [("native", "python"),
                                     ("python", "native"),
                                     ("native", "native")])
def test_cross_tier_frame_roundtrip(enc, dec, compressible):
    data = compressible(150_000)
    cfg = FrameConfig(block_size=65536)
    frame = compress_frame(data, config=cfg, backend=enc)
    out = decompress_frame(np.array(frame), backend=dec)
    np.testing.assert_array_equal(out, data)


def test_native_error_taxonomy():
    data = np.full(100, 65, dtype=np.uint8)
    comp = lz4.compress_raw(data, backend="native")
    small = np.empty(50, dtype=np.uint8)
    with pytest.raises(ValueError, match="Output Buffer Too Small"):
        lz4.decompress_raw(comp, small, backend="native")
    bad = np.array([0x04, 0x00, 0x00], dtype=np.uint8)
    dst = np.empty(64, dtype=np.uint8)
    with pytest.raises(ValueError, match="Invalid Offset 0"):
        lz4.decompress_raw(bad, dst, backend="native")


def test_native_dictionary_frame(compressible):
    data = compressible(100_000)
    d = np.array(data[:5000])
    comp = compress_frame(data, dictionary=d, backend="native")
    out = decompress_frame(comp, dictionary=d, backend="native")
    np.testing.assert_array_equal(out, data)
    with pytest.raises(ValueError, match="(?i)dictionary"):
        decompress_frame(comp, backend="native")


def test_native_large_roundtrip(rng):
    # 8MB mixed data: exercises multi-block 4MB frames at native speed.
    a = rng.integers(0, 256, 4_000_000, dtype=np.uint8)
    b = np.tile(np.frombuffer(b"The quick brown fox. ", dtype=np.uint8),
                200_000)
    data = np.concatenate([a, b])[:8_000_000]
    frame = compress_frame(data, backend="native",
                           config=FrameConfig(content_checksum=True))
    out = decompress_frame(frame, backend="native")
    np.testing.assert_array_equal(out, data)
