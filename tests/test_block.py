"""Raw block kernel tests (single ABI; parity with tests/raw/raw.test.mjs)."""

import numpy as np
import pytest

from divortio_lz4 import compress_raw, decompress_raw
from divortio_lz4.constants import block_bound
from divortio_lz4.ops.block_ref import new_hash_table


def test_raw_roundtrip_random(rng):
    data = rng.integers(0, 256, 1024, dtype=np.uint8)
    out = np.empty(block_bound(len(data)), dtype=np.uint8)
    written = compress_raw(data, out, 0, len(data), new_hash_table(), 0)
    assert written > 0
    restored = np.empty(len(data), dtype=np.uint8)
    n = decompress_raw(out[:written], restored)
    assert n == len(data)
    np.testing.assert_array_equal(restored, data)


def test_raw_roundtrip_compressible(compressible):
    data = compressible(4096)
    comp = compress_raw(data)
    assert len(comp) < len(data) // 2
    restored = np.empty(len(data), dtype=np.uint8)
    n = decompress_raw(comp, restored)
    assert n == len(data)
    np.testing.assert_array_equal(restored, data)


def test_raw_too_small_output():
    data = np.full(100, 65, dtype=np.uint8)
    comp = compress_raw(data)
    too_small = np.empty(50, dtype=np.uint8)
    with pytest.raises(ValueError, match="[Oo]utput [Bb]uffer [Tt]oo [Ss]mall"):
        decompress_raw(comp, too_small)


def test_raw_rle():
    data = np.full(1000, 0xAB, dtype=np.uint8)
    comp = compress_raw(data)
    assert len(comp) < 32
    restored = np.empty(1000, dtype=np.uint8)
    assert decompress_raw(comp, restored) == 1000
    np.testing.assert_array_equal(restored, data)


def test_raw_overlapping_offsets():
    # Period-3 pattern forces offset < match-length copies.
    data = np.tile(np.array([1, 2, 3], dtype=np.uint8), 500)
    comp = compress_raw(data)
    restored = np.empty(len(data), dtype=np.uint8)
    assert decompress_raw(comp, restored) == len(data)
    np.testing.assert_array_equal(restored, data)


def test_raw_long_literal_runs(rng):
    # >15 literals exercises the 0xFF-run length encoding on both sides.
    data = rng.integers(0, 256, 700, dtype=np.uint8)
    comp = compress_raw(data)
    restored = np.empty(len(data), dtype=np.uint8)
    assert decompress_raw(comp, restored) == len(data)
    np.testing.assert_array_equal(restored, data)


def test_raw_invalid_offset_zero():
    # token 0x04 (no literals, matchlen 8) + offset 0x0000.
    bad = np.array([0x04, 0x00, 0x00], dtype=np.uint8)
    dst = np.empty(64, dtype=np.uint8)
    with pytest.raises(ValueError, match="Offset 0"):
        decompress_raw(bad, dst)


def test_raw_dictionary_backref():
    # Compress "dict + payload" then decode just the payload's block with the
    # dict supplied — back-references land in the dictionary.
    dict_bytes = np.frombuffer(b"0123456789abcdefABCDEF~~" * 8, dtype=np.uint8)
    payload = np.frombuffer(b"0123456789abcdefABCDEF~~payload!", dtype=np.uint8)
    combined = np.concatenate([dict_bytes, payload])
    table = new_hash_table()
    out = np.empty(block_bound(len(payload)), dtype=np.uint8)
    from divortio_lz4.backends import get_backend
    be = get_backend()
    be.warm_table(table, combined, len(dict_bytes))
    written = be.compress_block(combined, out, len(dict_bytes), len(payload),
                                table, 0)
    restored = np.empty(len(payload), dtype=np.uint8)
    n = decompress_raw(out[:written], restored, dictionary=dict_bytes)
    assert n == len(payload)
    np.testing.assert_array_equal(restored, payload)
