"""Split decode route (host record parse + the region kernel, interpret
mode on CPU): bit-exactness vs the host tier, the parser's record
contract, error taxonomy, hostile-record containment, and linked /
dictionary / big-block frames through device_decompress_frame."""

import jax.numpy as jnp
import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.ops.block_ref import compress_block_ref
from divortio_lz4.ops.gpu_decode import (
    SPAN,
    W,
    Plan,
    _parse_records2_py,
    decode_blocks,
    decode_regions,
    dispatch,
    padded_inputs,
    parse_records_wire,
    plan_regions,
)


def _decode_one(comp, out_cap, history=None):
    window = None if history is None else np.asarray(history)[-W:]
    plan = plan_regions(comp, [(0, len(comp), False)], out_cap, True,
                        0 if window is None else len(window))
    return np.asarray(dispatch(plan, window))[: plan.total]


def _replay(recs, wire, out_len):
    """Execute records sequentially in numpy (the record contract)."""
    out = np.zeros(out_len, np.uint8)
    o = 0
    for s, w1 in np.asarray(recs, np.uint32).tolist():
        off, ll, ml = w1 & 0xFFFF, (w1 >> 16) & 0xFF, w1 >> 24
        out[o: o + ll] = wire[s: s + ll]
        o += ll
        out[o: o + ml] = out[o - off: o - off + ml]
        o += ml
    return out


def _cases(rng, compressible):
    return {
        "text": np.frombuffer(b"the quick brown fox jumps! " * 900,
                              np.uint8),
        "rle": np.full(20000, 7, np.uint8),
        "period3": np.tile(np.array([1, 2, 3], np.uint8), 8000),
        "period200": np.tile(rng.integers(0, 256, 200, np.uint8), 120),
        "period130": np.tile(rng.integers(0, 256, 130, np.uint8), 180),
        "json": np.frombuffer(b'{"a":1,"bb":"xyz"}' * 1300, np.uint8),
        "mixed": np.asarray(compressible(30000)),
        "tiny": np.frombuffer(b"compress me compress me!", np.uint8),
        "longlit": np.concatenate(
            [rng.integers(0, 256, 500, np.uint8),
             np.full(300, 9, np.uint8),
             rng.integers(0, 256, 400, np.uint8)]),
    }


@pytest.mark.parametrize("name", ["text", "rle", "period3", "period200",
                                  "period130", "json", "mixed", "tiny",
                                  "longlit"])
def test_split_decode_bit_exact(name, rng, compressible):
    data = _cases(rng, compressible)[name]
    comp = np.asarray(lz4.compress_raw(data))
    if len(comp) >= len(data):
        pytest.skip("stored-class block")
    out = _decode_one(comp, max(len(data), 1))
    np.testing.assert_array_equal(out, data)


def test_split_decode_with_history(compressible):
    data = np.asarray(compressible(70000))
    hist, plain = data[:30000], data[30000:]
    table = np.zeros(16384, np.int32)
    dst = np.zeros(len(data) * 2 + 1024, np.uint8)
    n = compress_block_ref(data, dst, len(hist), len(plain), table, 0)
    out = _decode_one(dst[:n], 65536, history=hist)
    np.testing.assert_array_equal(out, plain)


def test_split_record_contract(compressible):
    """Every record covers <= 128 output bytes, and its match source lies
    fully before its own output (so it is written when it runs)."""
    data = np.asarray(compressible(40000))
    comp = np.asarray(lz4.compress_raw(data))
    recs, out_len = parse_records_wire(comp, len(data))
    assert out_len == len(data)
    o = 0
    for s, w1 in recs.tolist():
        off, ll, ml = w1 & 0xFFFF, (w1 >> 16) & 0xFF, w1 >> 24
        assert 1 <= off and ll + ml <= SPAN
        if ml:
            src = o + ll - off
            assert src >= 0
            assert src + ml <= o  # never overlaps this record's output
        o += ll + ml
    np.testing.assert_array_equal(_replay(recs, comp, out_len), data)


def test_split_parser_py_native_equivalent(compressible):
    """Both parsers produce a plan that replays to the same bytes."""
    data = np.asarray(compressible(20000))
    comp = np.asarray(lz4.compress_raw(data))
    r_py, n_py = _parse_records2_py(comp, len(data))
    np.testing.assert_array_equal(_replay(r_py, comp, n_py), data)
    try:
        from divortio_lz4.native import parse_records2_native
    except Exception:
        pytest.skip("native unavailable")
    r_nat, n_nat = parse_records2_native(comp, len(data))
    assert n_nat == n_py == len(data)
    np.testing.assert_array_equal(_replay(r_nat, comp, n_nat), data)


@pytest.mark.parametrize("parse", ["native", "py"])
@pytest.mark.parametrize("case", ["truncated_run", "offset0", "overflow",
                                  "lit_overrun"])
def test_split_parser_error_taxonomy(parse, case):
    if parse == "native":
        try:
            from divortio_lz4.native import parse_records2_native as fn
        except Exception:
            pytest.skip("native unavailable")
    else:
        fn = _parse_records2_py
    bad = {
        "truncated_run": bytes([0xF0] + [255] * 3),
        "offset0": bytes([0x10, ord("x"), 0x00, 0x00]),
        "overflow": bytes([0x4F, 1, 2, 3, 4, 0x01, 0x00, 250, 250, 250,
                           250, 0]),
        "lit_overrun": bytes([0xF0, 20, ord("x")]),
    }[case]
    msg = {
        "truncated_run": "Malformed",
        "offset0": "Invalid Offset 0",
        "overflow": "Output Buffer Too Small",
        "lit_overrun": "Malformed",
    }[case]
    with pytest.raises(ValueError, match=msg):
        fn(np.frombuffer(bad, np.uint8), 64)


def test_split_batched_blocks_with_sorting(compressible, rng):
    """Multi-block batch of very different record densities in one
    dispatch."""
    blocks = [np.asarray(compressible(16384)) for _ in range(5)]
    blocks.append(np.full(16384, 3, np.uint8))
    blocks.append(np.tile(rng.integers(0, 256, 100, np.uint8), 164)[:16384])
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    for o, b in zip(decode_blocks(comps, 16384), blocks):
        np.testing.assert_array_equal(o, b)


def _run(plan):
    m, r, w, h, out_len = padded_inputs(plan)
    return np.asarray(decode_regions(jnp.asarray(m), jnp.asarray(r),
                                     jnp.asarray(w), jnp.asarray(h),
                                     out_len))


def test_split_hostile_records_stay_in_bounds():
    """Garbage records (not from our parser) must not write outside their
    region or hang — clamps in the kernel, not trust."""
    BSZ = 2048
    rng = np.random.default_rng(3)
    recs = rng.integers(0, 2**31 - 1, (128, 2), dtype=np.int64) \
        .astype(np.uint32)
    recs[::3, 1] = 0  # zero offsets / zero lengths
    wire = np.full(BSZ, 7, np.uint8)
    meta = np.array([[0, 128, 0, BSZ]], np.int32)
    out = _run(Plan(wire, recs.view(np.int32), meta, BSZ))
    assert not out[BSZ:].any()  # completed; nothing past the region


def test_split_noop_record_is_identity():
    """A record with no literal and no match bytes writes nothing."""
    wire = np.arange(256, dtype=np.uint8)
    recs = np.zeros((6, 2), np.uint32)
    recs[0] = (0, 1 | (100 << 16))           # 100 literal bytes
    recs[1] = (0, 1)                          # empty
    recs[2] = (0, 0)                          # empty, zero offset
    recs[3] = (100, 1 | (28 << 16))           # 28 more literals
    recs[4] = (0, 1)                          # empty
    recs[5] = (0, 64 | (64 << 24))            # match 64 bytes back
    plan = Plan(wire, recs.view(np.int32),
                np.array([[0, 6, 0, 192]], np.int32), 192)
    out = _run(plan)[:192]
    np.testing.assert_array_equal(out[:128], wire[:128])
    np.testing.assert_array_equal(out[128:], wire[64:128])


# ---------------------------------------------------------------------------
# Frames through device_decompress_frame(engine="split"): a linked frame is
# one region, a big block one region; small shapes — interpret mode is slow.
# ---------------------------------------------------------------------------

def _chain_cases(compressible, rng):
    base = np.asarray(compressible(120000))
    return base, rng


def test_chain_split_linked_frame(compressible, rng):
    from divortio_lz4.parallel.device import device_decompress_frame

    corpus = np.asarray(compressible(120000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame = np.asarray(lz4.compress(corpus, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_chain_split_linked_dictionary(compressible):
    from divortio_lz4.parallel.device import device_decompress_frame

    corpus = np.asarray(compressible(90000))
    d = bytes(corpus[:6000].tobytes())
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame = np.asarray(lz4.compress(corpus, config=cfg, dictionary=d))
    out = device_decompress_frame(frame, engine="split", dictionary=d)
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_chain_split_linked_stored_mix(compressible, rng):
    from divortio_lz4.parallel.device import device_decompress_frame

    corpus = np.concatenate([np.asarray(compressible(80000)),
                             rng.integers(0, 256, 70000, np.uint8)])
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame = np.asarray(lz4.compress(corpus, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_chain_split_bigblock_independent(compressible):
    from divortio_lz4.parallel.device import device_decompress_frame

    corpus = np.asarray(compressible(150000))
    cfg = lz4.FrameConfig(block_size=1048576, block_independence=True)
    frame = np.asarray(lz4.compress(corpus, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_chain_split_giant_rle_falls_back(rng):
    from divortio_lz4.parallel.device import device_decompress_frame

    corpus = np.zeros(400000, np.uint8)  # single >256KB-output sequence
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame = np.asarray(lz4.compress(corpus, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_chain_split_rejects_oob_backref():
    """A linked frame whose first sequence back-references before the
    stream start (no dictionary) must raise the host taxonomy on the
    split route too — not silently decode zeros."""
    from divortio_lz4.parallel.device import device_decompress_frame
    from divortio_lz4.xxh import xxhash32

    # hand-built: lit 5 "HELLO", match offset 16 (OOB), mlen 4; trailing
    # lit 5 "WORLD"
    block = bytes([0x50]) + b"HELLO" + bytes([0x10, 0x00]) \
        + bytes([0x50]) + b"WORLD"
    desc = bytes([0x40, 0x40])  # linked, 64KB
    hc = bytes([(xxhash32(np.frombuffer(desc, np.uint8), 0) >> 8) & 0xFF])
    frame = (bytes([0x04, 0x22, 0x4D, 0x18]) + desc + hc
             + len(block).to_bytes(4, "little") + block
             + b"\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="Dictionary Offset|Malformed"):
        lz4.decompress(np.frombuffer(frame, np.uint8))
    with pytest.raises(ValueError, match="Dictionary Offset|Malformed"):
        device_decompress_frame(np.frombuffer(frame, np.uint8),
                                engine="split")


def test_sharded_split_decode_respects_frame_block_size(compressible):
    """ShardedCodec configured with one block size must decode frames
    written with ANOTHER block size bit-exactly (the kernel's output
    capacity comes from the frame header, not the codec config)."""
    from divortio_lz4.parallel.sharding import ShardedCodec, make_mesh

    corpus = np.asarray(compressible(120000))
    frame_cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    frame = np.asarray(lz4.compress(corpus, config=frame_cfg))
    codec = ShardedCodec(make_mesh(), lz4.FrameConfig(
        block_size=4096, block_independence=True), engine="best")
    out = codec.decompress(frame)
    np.testing.assert_array_equal(np.asarray(out), corpus)
