"""Big-block (256 KB - 4 MB) device codec: segmented chain-direct encode
(parallel/bigblock.py) and the region decode kernel. Interpret mode on
CPU; the gpu marker runs the compiled kernel.

Cross-validation style per SURVEY §4: compress with one tier, decompress
with another, in both directions, against the reference-identical host
tier. Reference parity targets: bufferCompress.js:100 (4 MB default block
size), blockDecompress.js:55-272.
"""

import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.parallel.bigblock import SEG, compress_frame_big
from divortio_lz4.parallel.device import (
    device_compress_frame,
    device_decompress_frame,
    parse_block_index,
)

from conftest import make_compressible

BS = 262144  # smallest big-block tier; 1 MB/4 MB differ only in count


def mixed_corpus(n: int, seed: int = 3) -> np.ndarray:
    """Compressible text + a dash of noise so blocks stay compressed but
    segments carry real literal runs."""
    rng = np.random.default_rng(seed)
    base = make_compressible(n)
    out = np.array(base)
    for _ in range(max(n // 40000, 1)):
        at = int(rng.integers(0, max(n - 600, 1)))
        out[at: at + 600] = rng.integers(0, 256, 600, dtype=np.uint8)
    return out


# --------------------------------------------------------------- segments --

def test_segment_rows_cover_blocks_with_history():
    """Every 64 KB segment row carries its payload after a 64 KB history
    slice that stops at its block's start (independent) or reaches into
    the previous block (linked)."""
    from divortio_lz4.parallel.bigblock import _segment_rows

    raw = mixed_corpus(3 * SEG + 5000)
    for linked in (False, True):
        work, lens, hist_start, seg_rows = _segment_rows(raw, 2 * SEG,
                                                         None, linked)
        assert [len(r) for r in seg_rows] == [2, 2]
        assert int(lens.sum()) == len(raw)
        # second segment of block 0 sees the first as history
        np.testing.assert_array_equal(work[1, :SEG], raw[:SEG])
        # first segment of block 1: history only when linked
        assert hist_start[2] == (0 if linked else SEG)


def test_big_encode_segment_splice_tiles_block():
    """The spliced block stream decodes to exactly its block."""
    raw = mixed_corpus(4 * SEG, seed=41)
    cfg = lz4.FrameConfig(block_size=4 * SEG, block_independence=True)
    frame = compress_frame_big(raw, cfg)
    hdr, blocks, _ = parse_block_index(np.asarray(frame))
    assert len(blocks) == 1 and not blocks[0][2]
    off, size, _ = blocks[0]
    out = np.empty(4 * SEG, np.uint8)
    assert lz4.decompress_raw(np.asarray(frame)[off: off + size], out) \
        == len(raw)
    np.testing.assert_array_equal(out, raw)


# ----------------------------------------------------------------- encode --

@pytest.mark.parametrize("independent", [True, False])
def test_big_encode_host_decodes(independent):
    raw = mixed_corpus(600000)  # 3 blocks: 256K + 256K + tail
    cfg = lz4.FrameConfig(block_size=BS, block_independence=independent,
                          content_checksum=True)
    frame = compress_frame_big(raw, cfg)
    out = lz4.decompress(frame)
    assert np.array_equal(out, raw)
    # ratio gate: the segmented device encoder must not exceed the
    # reference-identical host encoder (bench.py asserts the same).
    ref = len(lz4.compress(raw, config=cfg))
    assert len(frame) <= ref


def test_big_encode_routing_via_device_compress_frame():
    raw = mixed_corpus(400000)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = device_compress_frame(raw, cfg, engine="split")
    assert np.array_equal(lz4.decompress(frame), raw)


def test_big_encode_dictionary_both_modes():
    raw = mixed_corpus(300000, seed=9)
    dic = raw[:40000]
    for indep in (True, False):
        cfg = lz4.FrameConfig(block_size=BS, block_independence=indep)
        frame = compress_frame_big(raw, cfg, dictionary=dic)
        assert np.array_equal(lz4.decompress(frame, dictionary=dic), raw)
        with pytest.raises(ValueError, match="Dictionary"):
            lz4.decompress(frame)


def test_big_encode_block_checksums_and_stored_fallback(rng):
    # incompressible corpus: every block takes the stored path
    raw = rng.integers(0, 256, 300000, dtype=np.uint8)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True,
                          block_checksums=True)
    frame = compress_frame_big(raw, cfg)
    assert np.array_equal(lz4.decompress(frame), raw)
    hdr, blocks, _ = parse_block_index(frame)
    assert all(stored for _, _, stored in blocks)


def test_big_encode_single_short_block():
    raw = mixed_corpus(50000)  # smaller than one segment
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = compress_frame_big(raw, cfg)
    assert np.array_equal(lz4.decompress(frame), raw)


# ----------------------------------------------------------------- decode --

@pytest.mark.parametrize("independent", [True, False])
def test_big_decode_of_host_frames(independent):
    raw = mixed_corpus(600000, seed=5)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=independent,
                          content_checksum=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="pallas")
    assert np.array_equal(out, raw)


def test_big_decode_dictionary_both_modes():
    raw = mixed_corpus(300000, seed=11)
    dic = raw[100000:160000]
    for indep in (True, False):
        cfg = lz4.FrameConfig(block_size=BS, block_independence=indep)
        frame = np.asarray(lz4.compress(raw, dictionary=dic, config=cfg))
        out = device_decompress_frame(frame, engine="pallas",
                                      dictionary=dic)
        assert np.array_equal(out, raw)


def test_big_decode_stored_blocks(rng):
    raw = rng.integers(0, 256, 300000, dtype=np.uint8)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="pallas")
    assert np.array_equal(out, raw)


def test_big_decode_giant_rle_falls_back():
    # A 1 MB zero block encodes to a single monster sequence; the region
    # kernel decodes it like any other block.
    raw = np.zeros(1048576 + 1000, np.uint8)
    cfg = lz4.FrameConfig(block_size=1048576, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="pallas")
    assert np.array_equal(out, raw)


def test_big_roundtrip_device_both_directions():
    raw = mixed_corpus(550000, seed=13)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = device_compress_frame(raw, cfg, engine="split")
    out = device_decompress_frame(frame, engine="pallas")
    assert np.array_equal(out, raw)


@pytest.mark.gpu
def test_bigblock_gpu_parity(compressible):
    """The reference's default 4 MB blocks on the card: the segmented
    encoder holds the ratio gate and the compiled kernel decodes exact."""
    corpus = np.asarray(compressible(4_500_000))
    cfg = lz4.FrameConfig(block_size=4194304, block_independence=True)
    frame = compress_frame_big(corpus, cfg)
    assert len(frame) <= len(lz4.compress(corpus, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), corpus)


def test_bigblock_multiframe_pipelined_roundtrip(compressible):
    """compress_frames_big / decompress_frames: N big-block frames queue
    every device dispatch before the first fetch — byte-identical to the
    serial per-frame path."""
    import numpy as np

    import divortio_lz4 as lz4
    from divortio_lz4.frame import decompress_frame
    from divortio_lz4.parallel.device import (
        device_compress_frame, device_compress_frames,
        device_decompress_frames)

    cfg = lz4.FrameConfig(block_size=262144, block_independence=True)
    datas = [np.asarray(compressible(260000 + 9000 * i)) for i in range(3)]
    frames = device_compress_frames(datas, cfg)
    for d, f in zip(datas, frames):
        one = device_compress_frame(d, cfg, engine="split")
        np.testing.assert_array_equal(np.asarray(f), np.asarray(one))
        np.testing.assert_array_equal(decompress_frame(np.asarray(f)), d)
    outs = device_decompress_frames(frames)
    for o, d in zip(outs, datas):
        np.testing.assert_array_equal(np.asarray(o), d)
