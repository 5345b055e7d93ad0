"""Big-block (256 KB - 4 MB) and linked frames through the region kernel.

The reference's DEFAULT config is 4 MB independent blocks
(bufferCompress.js:100): each block is one region of the kernel, and a
linked frame of any block size is one region whose back-references reach
earlier blocks. Contract: bit-exact output vs the host tier and spec
window semantics (blockDecompress.js:145-154 — reset at independent block
boundaries, carry across linked blocks). Interpret mode on CPU; the gpu
marker runs the compiled kernel.
"""

import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.ops.gpu_decode import decode_frame_body, plan_regions
from divortio_lz4.parallel.device import (
    device_decompress_frame,
    parse_block_index,
)

from conftest import make_compressible

BS = 262144  # smallest big-block tier — same route as 1 MB/4 MB


def mixed_corpus(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.array(make_compressible(n))
    for _ in range(max(n // 40000, 1)):
        at = int(rng.integers(0, max(n - 600, 1)))
        out[at: at + 600] = rng.integers(0, 256, 600, dtype=np.uint8)
    return out


def region_decode(frame: np.ndarray, dictionary=None):
    hdr, blocks, _ = parse_block_index(frame)
    window = None
    if dictionary is not None:
        window = np.asarray(dictionary)[-65536:]
    out, total = decode_frame_body(frame, blocks, hdr["block_max"],
                                   hdr["independent"], window)
    return np.asarray(out)[:total]


# ------------------------------------------------------------ round trips --

def test_wave_independent_bigblocks():
    raw = mixed_corpus(900000)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = region_decode(frame)
    np.testing.assert_array_equal(out, raw)


def test_wave_linked_frame_carries_window():
    # Linked frames re-use cross-block history: one region, no reset.
    raw = mixed_corpus(700000, seed=7)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=False)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = region_decode(frame)
    np.testing.assert_array_equal(out, raw)


def test_wave_linked_small_blocks_via_device_path():
    # engine="split" on a linked 64 KB frame: one region, back-references
    # across block boundaries.
    raw = mixed_corpus(500000, seed=9)
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(out, raw)


def test_wave_dictionary_window_both_modes():
    raw = mixed_corpus(400000, seed=11)
    dic = raw[100000:160000]
    for indep in (True, False):
        cfg = lz4.FrameConfig(block_size=BS, block_independence=indep)
        frame = np.asarray(lz4.compress(raw, dictionary=dic, config=cfg))
        out = device_decompress_frame(frame, engine="split",
                                      dictionary=dic)
        np.testing.assert_array_equal(out, raw)


def test_wave_default_4mb_config():
    # The reference's default block size — two regions.
    raw = mixed_corpus(4_500_000, seed=13)
    cfg = lz4.FrameConfig(block_size=4194304, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(out, raw)


def test_wave_stored_blocks_inline():
    # Incompressible data stores blocks verbatim; stored blocks decode as
    # pure literal records over their own bytes.
    rng = np.random.default_rng(17)
    raw = rng.integers(0, 256, 600000, dtype=np.uint8)
    raw[100000:140000] = 65  # one compressible island between stored spans
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = region_decode(frame)
    np.testing.assert_array_equal(out, raw)


def test_wave_window_reset_between_independent_blocks():
    # Identical content in consecutive independent blocks: the encoder may
    # not reference across the boundary and the decoder must reset — a
    # carried window would still decode right, so assert the plan itself
    # gives every block its own region.
    raw = np.tile(mixed_corpus(BS, seed=19), 3)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    hdr, blocks, _ = parse_block_index(frame)
    plan = plan_regions(frame, blocks, hdr["block_max"])
    assert len(plan.meta) == len(blocks)
    np.testing.assert_array_equal(plan.meta[:, 3], [BS] * 3)
    out = region_decode(frame)
    np.testing.assert_array_equal(out, raw)


def test_bigblocks_mixed_stored_and_short_tail():
    """Compressible, stored and short-tail blocks in one dispatch."""
    parts = [mixed_corpus(BS, seed=s) for s in (31, 32, 35)]
    rng = np.random.default_rng(33)
    parts.append(rng.integers(0, 256, BS, np.uint8))  # stored block
    parts.append(mixed_corpus(70000, seed=34))  # short tail block
    raw = np.concatenate(parts)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    np.testing.assert_array_equal(region_decode(frame), raw)


def test_wave_linked_plan_has_single_reset():
    raw = mixed_corpus(800000, seed=23)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=False)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    hdr, blocks, _ = parse_block_index(frame)
    plan = plan_regions(frame, blocks, hdr["block_max"], False)
    assert len(plan.meta) == 1  # linked = one region, window carried
    assert plan.total == len(raw)
    np.testing.assert_array_equal(region_decode(frame), raw)


# -------------------------------------------------------------- fallbacks --

def test_giant_rle_sequence_decodes():
    """One sequence whose output spans a whole 1 MB block (a zero run)."""
    raw = np.zeros(1048576 + 1000, np.uint8)
    cfg = lz4.FrameConfig(block_size=1048576, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(out, raw)


def _dense_sequence_block(n_seq: int) -> bytes:
    """Hand-built valid raw block of n_seq minimal sequences: 1 literal +
    4-byte match at offset 1 (5 output bytes each, RLE of the literal)."""
    parts = [b"\x10A\x01\x00" for _ in range(n_seq)]
    parts.append(b"\x50ABCDE")  # final sequence: 5 literals, no match
    return b"".join(parts)


def test_dense_record_block_decodes():
    """One record per 5 output bytes across a 1 MB block (the densest
    stream a block can hold) decodes bit-exact."""
    n_seq = 262144 // 5 + 1000
    blk = _dense_sequence_block(n_seq)
    out_len = n_seq * 5 + 5
    raw = np.asarray(lz4.decompress_raw(np.frombuffer(blk, np.uint8),
                                        out_len))
    cfg = lz4.FrameConfig(block_size=1048576, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(out, raw)


def test_wave_empty_frame():
    frame = np.asarray(lz4.compress(b""))
    hdr, blocks, _ = parse_block_index(frame)
    out = device_decompress_frame(frame, engine="split")
    assert len(out) == 0
    if blocks:  # encoder may emit a zero-length frame body instead
        assert len(region_decode(frame)) == 0


# ------------------------------------------------------- cross-validation --

def test_wave_matches_pallas_engine():
    raw = mixed_corpus(1_200_000, seed=29)
    cfg = lz4.FrameConfig(block_size=BS, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    a = device_decompress_frame(frame, engine="split")
    b = device_decompress_frame(frame, engine="pallas")
    c = device_decompress_frame(frame, engine="xla")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(a, raw)


@pytest.mark.gpu
def test_wave_gpu_parity():
    """The compiled kernel on the card, at the default config and on a
    linked frame, matches the input bytes."""
    raw = mixed_corpus(4_500_000, seed=31)
    cfg = lz4.FrameConfig(block_size=4194304, block_independence=True)
    frame = np.asarray(lz4.compress(raw, config=cfg))
    out = device_decompress_frame(frame, engine="split")
    np.testing.assert_array_equal(np.asarray(out), raw)
    linked = np.asarray(lz4.compress(raw[:1_000_000], config=lz4.FrameConfig(
        block_size=BS, block_independence=False)))
    out2 = device_decompress_frame(linked, engine="split")
    np.testing.assert_array_equal(np.asarray(out2), raw[:1_000_000])
