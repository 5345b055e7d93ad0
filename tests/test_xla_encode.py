"""XLA encode kernel: decode-compatibility across every tier + ratio.

Gates (BASELINE.json): output must be valid LZ4 consumed bit-exactly by any
decoder, at compressed size <= the reference encoder's.
"""

import numpy as np
import pytest

from divortio_lz4 import compress_raw, decompress_raw
from divortio_lz4.ops.decode_xla import decode_block_host
from divortio_lz4.ops.encode_xla import encode_block_host


def host_decode(comp, n, hist=None):
    out = np.empty(n, dtype=np.uint8)
    m = decompress_raw(comp, out, dictionary=hist)
    assert m == n
    return out


CASES = {
    "text": np.frombuffer(b"hello hello hello hello world!xy", np.uint8),
    "rle": np.full(5000, 0x5A, np.uint8),
    "rle_ff": np.full(5000, 0xFF, np.uint8),  # 0xFFFFFFFF words stay matchable
    "period3": np.tile(np.array([1, 2, 3], np.uint8), 1500),
    "tiny": np.frombuffer(b"abc", np.uint8),
    "empty_tail": np.frombuffer(b"0123456789abcdef" * 100, np.uint8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_xla_encode_host_decode(name):
    data = CASES[name]
    comp = encode_block_host(data)
    np.testing.assert_array_equal(host_decode(comp, len(data)), data)


def test_xla_encode_random_incompressible(rng):
    data = rng.integers(0, 256, 4000, dtype=np.uint8)
    comp = encode_block_host(data)
    np.testing.assert_array_equal(host_decode(comp, len(data)), data)


def test_xla_encode_xla_decode(compressible):
    # Full device-only path: XLA encode → XLA decode.
    data = np.asarray(compressible(4000))
    comp = encode_block_host(data)
    out = decode_block_host(np.asarray(comp), len(data))
    np.testing.assert_array_equal(out, data)


def test_xla_encode_ratio_beats_reference(compressible, rng):
    # Exhaustive candidates + exact lengths must compress at least as well
    # as the reference's skip-heuristic hash table on every corpus type.
    import sys
    sys.path.insert(0, "/root/repo")
    from benchmark.corpus import silesia_like, synthetic_json
    corpora = {
        "json": np.asarray(compressible(16384)),
        "varying_json": np.asarray(synthetic_json(16384)),  # medium matches
        "silesia_mix": np.asarray(silesia_like(16384)),
        "text": np.frombuffer(
            (b"the quick brown fox jumps over the lazy dog. " * 400)[:16384],
            np.uint8),
        "rle": np.full(16384, 7, np.uint8),
        "random": rng.integers(0, 256, 16384, dtype=np.uint8),
    }
    for name, data in corpora.items():
        ref = compress_raw(data)  # host tier = reference-identical output
        xla = encode_block_host(data)
        assert len(xla) <= len(ref), (name, len(xla), len(ref))


def test_xla_encode_with_history(compressible):
    hist = np.asarray(compressible(3000))
    data = np.asarray(compressible(2500))
    comp = encode_block_host(data, history=hist)
    np.testing.assert_array_equal(host_decode(comp, len(data), hist), data)
    # history must actually help
    comp_nohist = encode_block_host(data)
    assert len(comp) <= len(comp_nohist)


def test_xla_encode_history_is_bounded(rng, compressible):
    # Offsets may never reach past the real (possibly short) history.
    hist = np.asarray(compressible(100))  # short dict, left-padded internally
    data = np.concatenate([np.zeros(50, np.uint8), np.asarray(compressible(500))])
    comp = encode_block_host(data, history=hist)
    np.testing.assert_array_equal(host_decode(comp, len(data), hist), data)


def test_xla_encode_no_fingerprints_mode(compressible):
    data = np.asarray(compressible(4000))
    comp = encode_block_host(data, use_fingerprints=False)
    np.testing.assert_array_equal(host_decode(comp, len(data)), data)


def test_xla_long_match_lengths():
    # A single 8KB run must encode as one long match (fingerprint extension),
    # near the reference's size, not 16-byte stubs.
    data = np.full(8192, 0xAB, np.uint8)
    comp = encode_block_host(data)
    ref = compress_raw(data)
    assert len(comp) <= len(ref) + 2
    np.testing.assert_array_equal(host_decode(comp, len(data)), data)


def test_xla_encode_batch(compressible, rng):
    import jax.numpy as jnp
    from divortio_lz4.ops.encode_xla import encode_blocks_batch
    blocks = [np.asarray(compressible(2048)),
              rng.integers(0, 256, 2048, dtype=np.uint8),
              np.tile(np.array([3, 1, 4], np.uint8), 683)[:2048]]
    work = np.zeros((3, 2048), dtype=np.int32)
    lens = np.zeros(3, dtype=np.int32)
    for i, b in enumerate(blocks):
        work[i, : len(b)] = b
        lens[i] = len(b)
    outs, out_lens = encode_blocks_batch(
        jnp.asarray(work), jnp.asarray(lens), 0, True,
        jnp.zeros(3, jnp.int32))
    for i, b in enumerate(blocks):
        comp = np.asarray(outs[i][: int(out_lens[i])]).astype(np.uint8)
        np.testing.assert_array_equal(host_decode(comp, len(b)), b)
