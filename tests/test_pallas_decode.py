"""Decode route (engine "pallas" and "split": host record parse + the
region kernel, interpret mode on CPU). Bit-exactness across every copy
branch: literal runs, far matches, overlapping matches at offsets 1-3,
long matches, history back-references, linked frames."""

import numpy as np
import pytest

from divortio_lz4 import compress_raw
from divortio_lz4.backends import get_backend
from divortio_lz4.constants import block_bound
from divortio_lz4.ops.block_ref import new_hash_table
from divortio_lz4.ops.gpu_decode import (
    decode_blocks, decode_frame_body, dispatch, plan_regions)


def roundtrip(data, hist=None):
    if hist is not None:
        be = get_backend()
        combined = np.concatenate([hist, data])
        table = new_hash_table()
        be.warm_table(table, combined, len(hist))
        out = np.empty(block_bound(len(data)), np.uint8)
        n = be.compress_block(combined, out, len(hist), len(data), table, 0)
        comp = out[:n]
    else:
        comp = np.asarray(compress_raw(data))
    win = None if hist is None else np.asarray(hist)[-65536:]
    plan = plan_regions(comp, [(0, len(comp), False)], len(data), True,
                        0 if win is None else len(win))
    got = np.asarray(dispatch(plan, win))[: plan.total]
    np.testing.assert_array_equal(got, data)


CASES = {
    "literals_only": None,  # filled in test
    "far_offsets": np.frombuffer(b'{"a":1,"bb":"xyz"}' * 300, np.uint8),
    "offset3_periodize": np.tile(np.array([1, 2, 3], np.uint8), 800),
    "offset2": np.tile(np.array([9, 8], np.uint8), 900),
    "offset1_rle": np.full(4000, 7, np.uint8),
    "text": np.frombuffer(b"the quick brown fox jumps! " * 200, np.uint8),
    "long_matches": np.tile(np.frombuffer(b"0123456789abcdef", np.uint8),
                            700),
}


@pytest.mark.parametrize("name", sorted(k for k in CASES if CASES[k] is not None))
def test_pallas_decode_branches(name):
    roundtrip(CASES[name])


def test_pallas_decode_literals_only(rng):
    roundtrip(rng.integers(0, 256, 2000, dtype=np.uint8))


def test_pallas_decode_long_literal_extension(rng):
    roundtrip(rng.integers(0, 256, 700, dtype=np.uint8))


def test_pallas_decode_mixed(compressible, rng):
    data = np.concatenate([rng.integers(0, 256, 3000, dtype=np.uint8),
                           np.asarray(compressible(8000)),
                           np.full(2000, 3, np.uint8)])
    roundtrip(data)


def test_pallas_decode_with_history(compressible):
    hist = np.asarray(compressible(3000))
    data = np.asarray(compressible(2500))
    roundtrip(data, hist)


def test_pallas_decode_history_spanning():
    hist = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 30)
    data = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 200)
    roundtrip(data, hist)


def test_pallas_decode_batch(compressible, rng):
    blocks = [np.asarray(compressible(2048)),
              rng.integers(0, 256, 2048, dtype=np.uint8),
              np.tile(np.array([5, 4, 3], np.uint8), 683)[:2048],
              np.full(2048, 9, np.uint8),
              np.asarray(compressible(1000))]
    comps = [np.asarray(compress_raw(b)) for b in blocks]
    for got, b in zip(decode_blocks(comps, 2048), blocks):
        np.testing.assert_array_equal(got, b)


def test_repeated_block_batch_identical(compressible):
    """Eight copies of one block in one dispatch decode identically (no
    cross-region interference)."""
    import divortio_lz4 as lz4

    data = np.asarray(compressible(32768))
    comp = np.asarray(lz4.compress_raw(data))
    outs = decode_blocks([comp] * 8, 32768)
    for o in outs:
        np.testing.assert_array_equal(o, data)


def test_linked_chunk_kernel_roundtrip(compressible):
    """Linked decode: one region decodes dependent blocks with cross-block
    back-references."""
    from divortio_lz4 import FrameConfig, compress
    from divortio_lz4.parallel.device import parse_block_index

    data = np.asarray(compressible(300000))  # 5 linked 64 KB blocks
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = np.array(compress(data, config=cfg))
    header, blocks, _ = parse_block_index(frame)
    assert not header["independent"] and len(blocks) > 1
    out, total = decode_frame_body(frame, blocks, header["block_max"],
                                   False)
    np.testing.assert_array_equal(np.asarray(out)[:total], data)


def test_linked_pallas_engine_stored_blocks(rng, compressible):
    """Linked frames mixing compressed and stored blocks through the
    public device decode with engine='pallas'."""
    from divortio_lz4 import FrameConfig, compress
    from divortio_lz4.parallel.device import device_decompress_frame

    data = np.concatenate([
        np.asarray(compressible(90000)),
        rng.integers(0, 256, 70000, dtype=np.uint8),  # stored rows
        np.asarray(compressible(80000)),
    ])
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = np.array(compress(data, config=cfg))
    out = device_decompress_frame(frame, engine="pallas")
    np.testing.assert_array_equal(np.asarray(out), data)


def test_linked_pallas_engine_dictionary(compressible):
    from divortio_lz4 import FrameConfig, compress
    from divortio_lz4.parallel.device import device_decompress_frame

    d = np.asarray(compressible(5000))
    data = np.asarray(compressible(150000))
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = np.array(compress(data, dictionary=d, config=cfg))
    out = device_decompress_frame(frame, engine="pallas", dictionary=d)
    np.testing.assert_array_equal(np.asarray(out), data)


def test_linked_pallas_matches_xla_scan(compressible):
    """Same frame through both linked device decoders."""
    from divortio_lz4 import FrameConfig, compress
    from divortio_lz4.parallel.device import (
        _decode_linked, parse_block_index)

    data = np.asarray(compressible(200000))
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = np.array(compress(data, config=cfg))
    _, blocks, _ = parse_block_index(frame)
    out, total = decode_frame_body(frame, blocks, 65536, False)
    np.testing.assert_array_equal(np.asarray(out)[:total],
                                  _decode_linked(frame, blocks, 65536))


@pytest.mark.gpu
def test_linked_pallas_gpu_parity(compressible):
    """The compiled kernel on the card decodes a linked frame exactly."""
    from divortio_lz4 import FrameConfig, compress
    from divortio_lz4.parallel.device import device_decompress_frame

    data = np.asarray(compressible(1_000_000))
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = np.array(compress(data, config=cfg))
    out = device_decompress_frame(frame, engine="pallas")
    np.testing.assert_array_equal(np.asarray(out), data)
