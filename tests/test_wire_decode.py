"""Region decode (ops/gpu_decode): the kernel reads literal slices
straight from the compressed bytes. Covers: bit-exactness vs the host tier,
the record contract (native parser == Python fallback == sequential
simulation), dictionary history, stored blocks, batched dispatch, error
taxonomy, and hostile-record containment.

Reference semantics: /root/reference/src/block/blockDecompress.js:61-268.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.ops.block_ref import compress_block_ref
from divortio_lz4.ops.gpu_decode import (
    W,
    Plan,
    _parse_records2_py,
    decode_blocks,
    decode_regions,
    dispatch,
    padded_inputs,
    parse_records_wire,
    plan_regions,
    stored_wire_records,
)

try:
    from divortio_lz4.native import parse_records2_native
except Exception:
    parse_records2_native = None


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


def _simulate(wire, recs, out_len, hist=b""):
    """Execute v2 records sequentially in numpy — the executable spec of
    the record contract (each record: literal slice from the wire, then a
    match copy whose source is fully written when it runs)."""
    hl = len(hist)
    out = np.zeros(hl + out_len + 256, np.uint8)
    out[:hl] = np.frombuffer(bytes(hist), np.uint8) if hl else 0
    o = hl
    for s, w1 in recs:
        off = int(w1) & 0xFFFF
        ll = (int(w1) >> 16) & 0xFF
        ml = (int(w1) >> 24) & 0xFF
        assert ll + ml <= 128
        out[o: o + ll] = wire[s: s + ll]
        o += ll
        src = o - off
        assert src >= 0, "source before history start"
        # contract: the source range is fully written before the record
        assert src + ml <= o, (src, ml, o)
        out[o: o + ml] = out[src: src + ml]
        o += ml
    return out[hl: o]


@pytest.mark.parametrize("name", ["text", "rle", "period3", "period200",
                                  "period130", "json", "mixed", "tiny",
                                  "longlit"])
def test_wire_records_simulation_bit_exact(name, rng, compressible):
    data = _cases(rng, compressible)[name]
    comp = np.asarray(lz4.compress_raw(data))
    if len(comp) >= len(data):
        pytest.skip("stored-class block")
    recs, out_len = parse_records_wire(comp, max(len(data), 1))
    assert out_len == len(data)
    np.testing.assert_array_equal(_simulate(comp, recs, out_len), data)


@pytest.mark.parametrize("name", ["text", "rle", "period3", "mixed",
                                  "longlit"])
def test_wire_parser_native_matches_python(name, rng, compressible):
    if parse_records2_native is None:
        pytest.skip("native unavailable")
    data = _cases(rng, compressible)[name]
    comp = np.ascontiguousarray(np.asarray(lz4.compress_raw(data)))
    if len(comp) >= len(data):
        pytest.skip("stored-class block")
    r_n, ol_n = parse_records2_native(comp, len(data))
    r_p, ol_p = _parse_records2_py(comp, len(data))
    assert ol_n == ol_p
    np.testing.assert_array_equal(r_n, r_p)


@pytest.mark.parametrize("name", ["text", "rle", "period3", "period200",
                                  "json", "mixed", "longlit"])
def test_wire_kernel_bit_exact(name, rng, compressible):
    data = _cases(rng, compressible)[name]
    comp = np.asarray(lz4.compress_raw(data))
    if len(comp) >= len(data):
        pytest.skip("stored-class block")
    out = decode_blocks([comp], max(len(data), 1))[0]
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("lengths", [
    (32768, 65536, 98304, 131072, 163840, 196608, 229376, 262144),
    (262144, 4096, 200000)])
def test_wide_blocks_varied_lengths_one_dispatch(lengths, rng):
    """256 KB blocks of varied output length (and so varied record
    counts) decode bit-exact in one dispatch, a dense noise block
    among them."""
    blocks = [np.tile(rng.integers(0, 256, 1024, np.uint8),
                      -(-n // 1024))[:n] for n in lengths]
    blocks.append(rng.integers(0, 16, 262144).astype(np.uint8) * 13)
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    assert all(len(c) < len(b) for c, b in zip(comps, blocks))
    for o, b in zip(decode_blocks(comps, 262144), blocks):
        np.testing.assert_array_equal(o, b)


@pytest.mark.parametrize("split", [1, 3])
def test_regions_any_order_bit_exact(split, rng, compressible):
    """Regions are independent: the same blocks decode identically
    whatever regions share a dispatch."""
    cases = _cases(rng, compressible)
    blocks = [v for v in cases.values()
              if len(np.asarray(lz4.compress_raw(v))) < len(v)]
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    bs = max(len(b) for b in blocks)
    outs = []
    for k in range(0, len(comps), split):
        outs += decode_blocks(comps[k: k + split], bs)
    for o, b in zip(outs, blocks):
        np.testing.assert_array_equal(o, b)


def test_wire_kernel_batched_sorted_groups(rng, compressible):
    cases = _cases(rng, compressible)
    blocks = [v for v in cases.values()
              if len(np.asarray(lz4.compress_raw(v))) < len(v)]
    bs = max(len(b) for b in blocks)
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    outs = decode_blocks(comps, bs)
    for o, b in zip(outs, blocks):
        np.testing.assert_array_equal(o, b)


def test_wire_kernel_history(compressible):
    """Back-references into a dictionary window resolve through the
    history input."""
    data = np.asarray(compressible(70000))
    hist, plain = data[:30000], data[30000:]
    table = np.zeros(16384, np.int32)
    dst = np.zeros(len(data) * 2 + 1024, np.uint8)
    n = compress_block_ref(data, dst, len(hist), len(plain), table, 0)
    comp = dst[:n]
    win = hist[-W:]
    plan = plan_regions(comp, [(0, len(comp), False)], len(plain), True,
                        len(win))
    out = np.asarray(dispatch(plan, win))[: plan.total]
    np.testing.assert_array_equal(out, plain)


def test_stored_wire_records_roundtrip(rng):
    data = rng.integers(0, 256, 33333, np.uint8)  # incompressible
    recs = stored_wire_records(len(data))
    np.testing.assert_array_equal(_simulate(data, recs, len(data)), data)
    assert stored_wire_records(0).shape == (0, 2)


def test_wire_parser_error_taxonomy():
    with pytest.raises(ValueError, match="Malformed"):
        parse_records_wire(np.array([0xF0], np.uint8), 1 << 16)
    with pytest.raises(ValueError, match="Invalid Offset 0"):
        parse_records_wire(
            np.array([0x10, 65, 0x00, 0x00], np.uint8), 1 << 16)
    with pytest.raises(ValueError, match="Dictionary Offset"):
        parse_records_wire(
            np.array([0x10, 65, 0x09, 0x00], np.uint8), 1 << 16)
    with pytest.raises(ValueError, match="Output Buffer Too Small"):
        parse_records_wire(
            np.asarray(lz4.compress_raw(np.zeros(9000, np.uint8))), 100)


def test_wire_kernel_hostile_records_contained(rng):
    """Garbage records (huge src/ll/ml/offset) must stay inside the
    buffers: the kernel clamps, cannot crash, and writes no more than its
    region's declared length."""
    wire = rng.integers(0, 256, 2048, np.uint8)
    recs = rng.integers(0, 2**32, (128, 2), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    meta = np.array([[0, 128, 0, 4096]], np.int32)
    m, r, w, h, out_len = padded_inputs(Plan(wire, recs, meta, 4096))
    out = np.asarray(decode_regions(jnp.asarray(m), jnp.asarray(r),
                                    jnp.asarray(w), jnp.asarray(h),
                                    out_len))
    assert out.shape == (out_len,)  # completed, in bounds
    assert not out[4096:].any()  # nothing past the region


def test_wire_frame_path_engine_split(compressible):
    """device_decompress_frame(engine='split') rides the v2 path end to
    end, stored blocks included."""
    from divortio_lz4.parallel.device import (device_compress_frame,
                                                  device_decompress_frame)

    rng = np.random.default_rng(7)
    data = np.concatenate([
        np.asarray(compressible(150000)),
        rng.integers(0, 256, 70000, np.uint8),   # stored blocks
        np.asarray(compressible(50000)),
    ])
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    frame = device_compress_frame(data, cfg, engine="split")
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(out, data)


def test_wire_frame_path_dictionary(compressible):
    from divortio_lz4.parallel.device import (device_compress_frame,
                                                  device_decompress_frame)

    data = np.asarray(compressible(100000))
    d = np.asarray(compressible(30000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    frame = device_compress_frame(data, cfg, dictionary=d, engine="split")
    out = device_decompress_frame(frame, engine="split", dictionary=d)
    np.testing.assert_array_equal(out, data)


@pytest.mark.gpu
def test_wire_kernel_gpu_parity(compressible):
    """The compiled region kernel on the card matches the input bytes."""
    data = np.asarray(compressible(200000))
    bs = 65536
    comps = [np.asarray(lz4.compress_raw(data[i * bs:(i + 1) * bs]))
             for i in range(3)]
    for i, o in enumerate(decode_blocks(comps, bs)):
        np.testing.assert_array_equal(o, data[i * bs:(i + 1) * bs])
