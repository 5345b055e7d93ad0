"""XLA decode kernel: bit-exactness vs the host encoder + golden data.

The decode kernel is the verification anchor (SURVEY §7 Phase 1): it must be
bit-exact against blocks produced by any encoder tier.
"""

import numpy as np
import pytest

from divortio_lz4 import compress_raw
from divortio_lz4.backends import get_backend
from divortio_lz4.constants import WINDOW_SIZE, block_bound
from divortio_lz4.ops.block_ref import new_hash_table
from divortio_lz4.ops.decode_xla import decode_block_host


def roundtrip(data: np.ndarray, history: np.ndarray | None = None):
    """host-encode → device-decode; returns decoded bytes."""
    if history is not None:
        be = get_backend()
        combined = np.concatenate([history, data])
        table = new_hash_table()
        be.warm_table(table, combined, len(history))
        out = np.empty(block_bound(len(data)), dtype=np.uint8)
        n = be.compress_block(combined, out, len(history), len(data), table, 0)
        comp = out[:n]
    else:
        comp = compress_raw(data)
    return decode_block_host(np.asarray(comp), len(data), history)


def test_simple_text():
    data = np.frombuffer(b"hello hello hello hello hello world!", np.uint8)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_all_literals(rng):
    data = rng.integers(0, 256, 500, dtype=np.uint8)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_rle_block():
    data = np.full(5000, 0x5A, dtype=np.uint8)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_overlapping_matches():
    data = np.tile(np.array([1, 2, 3], dtype=np.uint8), 2000)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_long_literal_run_extension(rng):
    # >270 literals → multi-0xFF length extension bytes.
    data = rng.integers(0, 256, 700, dtype=np.uint8)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_long_match_extension():
    # >270-byte matches → multi-0xFF match length extension.
    base = np.frombuffer(b"0123456789abcdef", np.uint8)
    data = np.concatenate([np.tile(base, 100),
                           np.frombuffer(b"ENDND", np.uint8)])
    np.testing.assert_array_equal(roundtrip(data), data)


def test_compressible_json(compressible):
    data = compressible(60_000)
    np.testing.assert_array_equal(roundtrip(data), data)


def test_mixed_random_and_repeats(rng, compressible):
    data = np.concatenate([rng.integers(0, 256, 10_000, dtype=np.uint8),
                           compressible(20_000),
                           np.full(5000, 7, dtype=np.uint8),
                           rng.integers(0, 256, 1000, dtype=np.uint8)])
    np.testing.assert_array_equal(roundtrip(data), data)


def test_history_backreferences(compressible):
    # Matches reaching into the 64KB history window (linked blocks).
    hist = np.asarray(compressible(3000))
    data = np.asarray(compressible(2000))  # same corpus → matches into hist
    np.testing.assert_array_equal(roundtrip(data, history=hist), data)


def test_history_spanning_match():
    # A match that starts in history and continues into the output.
    hist = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 10)
    data = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 50)
    np.testing.assert_array_equal(roundtrip(data, history=hist), data)


def test_full_window_history(rng, compressible):
    hist = np.concatenate([rng.integers(0, 256, WINDOW_SIZE - 5000,
                                        dtype=np.uint8),
                           np.asarray(compressible(5000))])
    data = np.asarray(compressible(4000))
    np.testing.assert_array_equal(roundtrip(data, history=hist), data)


def test_empty_ish_block():
    data = np.frombuffer(b"xyz", np.uint8)  # below MF_LIMIT: literal-only
    np.testing.assert_array_equal(roundtrip(data), data)


def test_batch_decode(compressible, rng):
    from divortio_lz4.ops.decode_xla import decode_blocks_batch
    import jax.numpy as jnp
    blocks = [np.asarray(compressible(3000)),
              rng.integers(0, 256, 3000, dtype=np.uint8),
              np.tile(np.array([9, 8, 7], dtype=np.uint8), 1000)]
    comps = [np.asarray(compress_raw(b)) for b in blocks]
    M = max(len(c) for c in comps)
    comp_arr = np.zeros((3, M), dtype=np.int32)
    lens = np.zeros(3, dtype=np.int32)
    for i, c in enumerate(comps):
        comp_arr[i, : len(c)] = c
        lens[i] = len(c)
    hist = np.zeros((3, WINDOW_SIZE), dtype=np.int32)
    out, out_lens = decode_blocks_batch(jnp.asarray(comp_arr),
                                        jnp.asarray(lens),
                                        jnp.asarray(hist), 3000)
    for i, b in enumerate(blocks):
        assert int(out_lens[i]) == 3000
        np.testing.assert_array_equal(
            np.asarray(out[i][:3000]).astype(np.uint8), b)
