"""The kernel route and the region decode kernel's host wrapper: which
route each platform takes, the region layout, bucketed padding, and the
compiled kernel against the plain XLA decode on the card."""

import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.ops import route
from divortio_lz4.ops.gpu_decode import (
    SPAN, W, _bucket, decode_blocks, padded_inputs, plan_regions)
from divortio_lz4.parallel.device import parse_block_index

from conftest import make_compressible


# ------------------------------------------------------------------ route --

def test_route_gpu_compiles():
    assert route.kernel_interpret("gpu") is False


def test_route_cpu_interprets_when_asked(monkeypatch):
    monkeypatch.setenv(route.INTERPRET_ENV, "1")
    assert route.kernel_interpret("cpu") is True


@pytest.mark.parametrize("value", [None, "0", ""])
def test_route_cpu_without_opt_in_raises(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(route.INTERPRET_ENV, raising=False)
    else:
        monkeypatch.setenv(route.INTERPRET_ENV, value)
    with pytest.raises(RuntimeError, match=route.INTERPRET_ENV):
        route.kernel_interpret("cpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_route_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no LZ4 kernel route"):
        route.kernel_interpret(platform)


def test_route_default_is_first_device():
    # the suite runs on the CPU with the opt-in set (conftest)
    assert route.kernel_interpret() is True


# ---------------------------------------------------------------- padding --

@pytest.mark.parametrize("n,want", [(0, 1024), (1, 1024), (1024, 1024),
                                    (1025, 1152), (4097, 4608),
                                    (33554432, 33554432),
                                    (33554433, 37748736)])
def test_bucket_values(n, want):
    assert _bucket(n) == want


def test_bucket_padding_bounded():
    for n in np.random.default_rng(1).integers(1, 1 << 30, 200):
        b = _bucket(int(n))
        assert n <= b <= max(1024, int(n) * 9 // 8 + 1)
        m = b >> max(b.bit_length() - 4, 0)
        assert 8 <= m < 16 or b <= 1024


# ----------------------------------------------------------------- layout --

def _frame(n=200_000, bs=65536, independent=True, seed=0):
    rng = np.random.default_rng(seed)
    data = np.array(make_compressible(n))
    data[5000:5600] = rng.integers(0, 256, 600, dtype=np.uint8)
    cfg = lz4.FrameConfig(block_size=bs, block_independence=independent)
    frame = np.asarray(lz4.compress(data, config=cfg))
    return data, frame, parse_block_index(frame)


def test_plan_independent_regions_back_to_back():
    data, frame, (hdr, blocks, _) = _frame()
    plan = plan_regions(frame, blocks, hdr["block_max"])
    first, count, start, length = plan.meta.T
    assert plan.total == len(data)
    np.testing.assert_array_equal(start, np.cumsum(length) - length)
    np.testing.assert_array_equal(first, np.cumsum(count) - count)
    assert int(count.sum()) == len(plan.recs)
    # the wire is the frame body itself, from the first block on
    assert len(plan.wire) == blocks[-1][0] + blocks[-1][1] - blocks[0][0]
    # every record's literal slice lies inside the wire
    w1 = plan.recs[:, 1].view(np.uint32)
    ll = (w1 >> 16) & 0xFF
    assert (plan.recs[:, 0].astype(np.int64) + ll <= len(plan.wire)).all()
    # records tile each region
    tot = ll + (w1 >> 24)
    for f, c, s_, n in plan.meta:
        assert int(tot[f: f + c].sum()) == n


def test_plan_linked_frame_is_one_region():
    data, frame, (hdr, blocks, _) = _frame(independent=False)
    assert len(blocks) > 1
    plan = plan_regions(frame, blocks, hdr["block_max"], False)
    assert plan.meta.shape == (1, 4)
    assert plan.meta[0, 3] == len(data) == plan.total


def test_padded_inputs_shapes_and_margin():
    data, frame, (hdr, blocks, _) = _frame()
    plan = plan_regions(frame, blocks, hdr["block_max"])
    window = np.arange(300, dtype=np.uint8)
    meta, recs, wire, hist, out_len = padded_inputs(plan, window)
    assert meta.shape[0] == _bucket(len(plan.meta), 8)
    assert recs.shape == (_bucket(len(plan.recs)), 2)
    assert wire.shape == (_bucket(len(plan.wire)),)
    assert out_len == _bucket(plan.total + SPAN)
    assert out_len >= plan.total + SPAN
    # pad regions run no records
    assert not meta[len(plan.meta):, 1].any()
    # history is right-aligned in a 64 KB window
    assert hist.shape == (W,)
    np.testing.assert_array_equal(hist[-300:], window)
    assert not hist[:-300].any()


def test_decode_blocks_empty_and_single():
    assert decode_blocks([], 65536) == []
    comp = np.asarray(lz4.compress_raw(b"hello hello hello hello hello"))
    assert bytes(decode_blocks([comp], 64)[0]) == b"hello hello hello " \
        b"hello hello"


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
def test_region_kernel_matches_xla_decode_on_gpu():
    """The compiled kernel and the plain XLA decode give the same bytes."""
    from divortio_lz4.parallel.device import device_decompress_frame

    data, frame, _ = _frame(2_000_000)
    a = device_decompress_frame(frame, engine="split")
    b = device_decompress_frame(frame, engine="xla")
    np.testing.assert_array_equal(a, data)
    np.testing.assert_array_equal(b, data)


# ------------------------------------------------------- batched host parse --

@pytest.mark.parametrize("independent", [True, False])
@pytest.mark.parametrize("with_dict", [False, True])
def test_batch_parse_matches_per_block_parse(independent, with_dict):
    """The native one-call parse (threads over independent blocks, one
    chain for a linked frame) gives the records the per-block parse
    gives."""
    from divortio_lz4.ops.gpu_decode import parse_records_wire

    rng = np.random.default_rng(3)
    data = np.array(make_compressible(300_000))
    data[70_000:140_000] = rng.integers(0, 256, 70_000, dtype=np.uint8)
    d = data[:20_000] if with_dict else None
    cfg = lz4.FrameConfig(block_size=65536, block_independence=independent)
    frame = np.asarray(lz4.compress(data, config=cfg, dictionary=d))
    hdr, blocks, _ = parse_block_index(frame)
    dict_len = 0 if d is None else len(d)
    plan = plan_regions(frame, blocks, 65536, independent, dict_len)
    parts, hist = [], dict_len
    lo = blocks[0][0]
    for off, size, stored in blocks:
        if stored:
            from divortio_lz4.ops.gpu_decode import stored_wire_records
            r, ol = stored_wire_records(size), size
        else:
            r, ol = parse_records_wire(frame[off: off + size], 65536, hist)
        r = r.copy()
        r[:, 0] += off - lo
        parts.append(r)
        if not independent:
            hist += ol
    np.testing.assert_array_equal(plan.recs.view(np.uint32),
                                  np.concatenate(parts))
    assert plan.total == len(data)


def test_batch_parse_raises_first_failing_block():
    """Two bad blocks: the error of the first one, in block order."""
    good = np.asarray(lz4.compress_raw(b"abcdabcdabcdabcd" * 50))
    oob = np.frombuffer(bytes([0x10, 65, 0x09, 0x00]), np.uint8)
    zero = np.frombuffer(bytes([0x10, 65, 0x00, 0x00]), np.uint8)
    buf = np.concatenate([good, oob, zero])
    blocks = [(0, len(good), False), (len(good), 4, False),
              (len(good) + 4, 4, False)]
    with pytest.raises(ValueError, match="Dictionary Offset"):
        plan_regions(buf, blocks, 65536)


@pytest.mark.parametrize("bs,independent,fits", [
    (65536, True, True), (1 << 20, True, True), (4 << 20, True, False),
    (65536, False, False)])
def test_region_kernel_regime(bs, independent, fits):
    from divortio_lz4.parallel.device import region_kernel_fits

    assert region_kernel_fits({"independent": independent,
                               "block_max": bs}) is fits


def _bad_frame(bd: int, independent: bool) -> np.ndarray:
    """One block whose match reaches before the stream start."""
    from divortio_lz4.xxh import xxhash32

    block = bytes([0x50]) + b"HELLO" + bytes([0x10, 0x00]) \
        + bytes([0x50]) + b"WORLD"
    desc = bytes([0x40 | (0x20 if independent else 0), bd << 4])
    hc = bytes([(xxhash32(np.frombuffer(desc, np.uint8), 0) >> 8) & 0xFF])
    return np.frombuffer(bytes([0x04, 0x22, 0x4D, 0x18]) + desc + hc
                         + len(block).to_bytes(4, "little") + block
                         + b"\x00\x00\x00\x00", np.uint8)


@pytest.mark.parametrize("bd,independent", [(4, True), (7, True),
                                            (4, False), (7, False)])
def test_split_route_validates_in_every_regime(bd, independent):
    """Where the split route decodes with the XLA kernels (4 MB blocks,
    linked frames) it still raises the host taxonomy on malformed input."""
    from divortio_lz4.parallel.device import (device_decompress_frame,
                                              device_decompress_frames)

    frame = _bad_frame(bd, independent)
    with pytest.raises(ValueError, match="Dictionary Offset"):
        device_decompress_frame(frame, engine="split")
    with pytest.raises(ValueError, match="Dictionary Offset"):
        device_decompress_frames([frame])


def test_decompress_frames_mixed_regimes_in_order():
    from divortio_lz4.parallel.device import device_decompress_frames

    data = np.array(make_compressible(600_000))
    cfgs = [lz4.FrameConfig(block_size=4 << 20, block_independence=True),
            lz4.FrameConfig(block_size=65536, block_independence=True),
            lz4.FrameConfig(block_size=65536, block_independence=False)]
    frames = [np.asarray(lz4.compress(data[i * 1000:], config=c))
              for i, c in enumerate(cfgs)]
    outs = device_decompress_frames(frames)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, data[i * 1000:])
