"""Chain-direct encoder with exact-word chains (device candidate chains
+ host select/serialize): decode-compatible streams at a ratio <= the
reference encoder's, including the adversarial ratio gate."""

import numpy as np
import pytest

from divortio_lz4 import compress_raw, decompress_raw
from divortio_lz4.constants import WINDOW_SIZE
from divortio_lz4.ops.block_ref import decompress_block_ref
from divortio_lz4.ops.split_encode import (
    chain_select_serialize, encode_block_split_host, encode_blocks_chain)


def encode_block_hybrid_host(data, history=None, block_size=None):
    """One block through exact-word chains, with an optional history
    window (right-aligned before the payload)."""
    if history is None or not len(history):
        return encode_block_split_host(data, block_size, exact=True)
    h = np.asarray(history, np.uint8)[-WINDOW_SIZE:]
    n = len(data)
    bs = block_size or max(-(-n // 1024) * 1024, 1024)
    work = np.zeros((1, WINDOW_SIZE + bs), np.int32)
    work[0, WINDOW_SIZE - len(h): WINDOW_SIZE] = h
    work[0, WINDOW_SIZE: WINDOW_SIZE + n] = data
    chains = np.asarray(encode_blocks_chain(
        work, np.array([n], np.int32), bs, WINDOW_SIZE,
        WINDOW_SIZE - len(h), exact=True))
    wk = np.zeros(WINDOW_SIZE + n + 8, np.uint8)
    wk[: WINDOW_SIZE + n] = work[0, : WINDOW_SIZE + n]
    return chain_select_serialize(wk, WINDOW_SIZE, n, chains[0])


CASES = {
    "text": np.frombuffer(b"the quick brown fox jumps! " * 200, np.uint8),
    "rle": np.full(4000, 7, np.uint8),
    "offset3": np.tile(np.array([1, 2, 3], np.uint8), 800),
    "json": np.frombuffer(b'{"a":1,"bb":"xyz"}' * 300, np.uint8),
    "long_matches": np.tile(np.frombuffer(b"0123456789abcdef", np.uint8),
                            700),
    "tiny": np.frombuffer(b"abc", np.uint8),
    "empty": np.zeros(0, np.uint8),
}


def _roundtrip(data, comp):
    out = np.empty(max(len(data), 1), np.uint8)
    n = decompress_raw(np.asarray(comp), out)
    assert n == len(data)
    np.testing.assert_array_equal(out[: len(data)], data)


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_roundtrip_and_ratio(name):
    data = CASES[name]
    comp = encode_block_hybrid_host(data)
    _roundtrip(data, comp)
    ref = np.asarray(compress_raw(data))
    assert len(comp) <= len(ref), (len(comp), len(ref))


def test_hybrid_random_incompressible(rng):
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    comp = encode_block_hybrid_host(data)
    _roundtrip(data, comp)


def test_hybrid_compressible_corpus(compressible):
    data = np.asarray(compressible(20000))
    comp = encode_block_hybrid_host(data, block_size=20480)
    _roundtrip(data, comp)
    ref = np.asarray(compress_raw(data))
    assert len(comp) <= len(ref)


def test_hybrid_batch_mixed_lens(compressible, rng):
    """Several rows per batch, full and partial payloads."""
    B = 2048
    rows = [
        np.asarray(compressible(B)),
        rng.integers(0, 256, B, dtype=np.uint8),       # incompressible
        np.asarray(compressible(700)),                  # partial
        np.tile(np.array([5, 6], np.uint8), B // 2),    # offset-2 runs
        np.zeros(B, np.uint8),                          # RLE zeros
    ]
    nb = len(rows)
    work = np.zeros((nb, B), np.int32)
    lens = np.zeros(nb, np.int32)
    for i, r in enumerate(rows):
        work[i, : len(r)] = r
        lens[i] = len(r)
    chains = np.asarray(encode_blocks_chain(work, lens, B, exact=True))
    for i, r in enumerate(rows):
        wk = np.zeros(B + 8, np.uint8)
        wk[: len(r)] = r
        _roundtrip(r, chain_select_serialize(wk, 0, len(r), chains[i]))


def test_hybrid_history_dictionary(compressible):
    """Dictionary window: back-references reach into history; output decodes
    with the same dictionary and beats the no-dict encoding."""
    dict_bytes = np.asarray(compressible(8000))
    data = np.asarray(compressible(6000))
    comp = encode_block_hybrid_host(data, history=dict_bytes)
    out = np.zeros(len(data), np.uint8)
    n = decompress_block_ref(np.asarray(comp), 0, len(comp), out, 0,
                             dictionary=dict_bytes)
    assert n == len(data)
    np.testing.assert_array_equal(out, data)
    comp_nodict = encode_block_hybrid_host(data)
    assert len(comp) <= len(comp_nodict)


def test_hybrid_history_partial_window(compressible):
    """History shorter than 64 KB is right-aligned; hist_start poisons the
    zero padding so no match reaches into fake zeros."""
    dict_bytes = np.asarray(compressible(1500))
    data = np.concatenate([np.zeros(64, np.uint8),
                           np.asarray(compressible(3000))])
    comp = encode_block_hybrid_host(data, history=dict_bytes)
    out = np.zeros(len(data), np.uint8)
    n = decompress_block_ref(np.asarray(comp), 0, len(comp), out, 0,
                             dictionary=dict_bytes)
    assert n == len(data)
    np.testing.assert_array_equal(out, data)


def test_hybrid_frame_engine(compressible):
    """engine='split' through the device frame path: independent, linked,
    and dictionary frames all decode on the host tier."""
    from divortio_lz4 import FrameConfig, decompress
    from divortio_lz4.parallel.device import (
        device_compress_frame, device_decompress_frame)

    data = np.asarray(compressible(30000))
    for indep in (True, False):
        cfg = FrameConfig(block_size=4096, block_independence=indep)
        f = device_compress_frame(data, cfg, engine="split")
        assert bytes(decompress(np.array(f))) == bytes(data)
        assert bytes(np.asarray(device_decompress_frame(
            np.array(f)))) == bytes(data)

    d = np.asarray(compressible(9000))
    cfg = FrameConfig(block_size=4096, block_independence=True)
    f = device_compress_frame(data[:8000], cfg, dictionary=d,
                              engine="split")
    assert bytes(decompress(np.array(f), dictionary=d)) == bytes(data[:8000])


def test_hybrid_large_block_falls_back_to_xla(compressible):
    """Blocks past hybrid_max_bs (u16 chain-position ceiling) encode as
    64 KB segments spliced on the host and still round-trip."""
    from divortio_lz4 import FrameConfig, decompress
    from divortio_lz4.ops.hybrid_encode import hybrid_max_bs
    from divortio_lz4.parallel.device import device_compress_frame

    bs = 262144
    assert bs > hybrid_max_bs()
    data = np.asarray(compressible(30000))
    cfg = FrameConfig(block_size=bs, block_independence=True)
    f = device_compress_frame(data, cfg, engine="split")
    assert bytes(decompress(np.array(f))) == bytes(data)


# ---------------------------------------------------------------------------
# Adversarial ratio gate (VERDICT r2 weak #4): the chain scores a few
# nearby candidates; the reference's stale 16K table can in principle hold
# an older longer match, so `<= reference` is empirical. These corpora pin
# the known failure classes as a regression fence — period-53 data was
# measured 55x WORSE before the run-interior poison fix
# (ops/hybrid_encode.py _cand_row).
# ---------------------------------------------------------------------------

def _adversarial_cases(rng):
    base53 = rng.integers(0, 256, 53, dtype=np.uint8)
    cases = {
        # the period-53 trap (run-interior poison sources)
        "period53": np.tile(base53, 16000 // 53 + 1)[:16000],
        # small power-of-two periods: hash-aligned repeats
        "period4": np.tile(np.arange(4, dtype=np.uint8), 4000),
        "period8": np.tile(np.arange(8, dtype=np.uint8), 2000),
        "period64": np.tile(rng.integers(0, 256, 64, dtype=np.uint8), 250),
        # run-heavy: alternating long RLE runs of different bytes
        "runs": np.repeat(rng.integers(0, 256, 64, dtype=np.uint8), 250),
        # aligned repeats of a 256-byte page with single-byte perturbations
        "aligned_pages": None,
        # RLE runs split by incompressible spacers
        "runs_spacers": None,
        # near-periodic: period 53 with a mutation every 200 bytes
        "period53_mut": None,
    }
    page = rng.integers(0, 256, 256, dtype=np.uint8)
    pages = np.tile(page, 60)
    pages[::257] ^= 1
    cases["aligned_pages"] = pages
    parts = []
    for k in range(40):
        parts.append(np.full(300, k, np.uint8))
        parts.append(rng.integers(0, 256, 37, dtype=np.uint8))
    cases["runs_spacers"] = np.concatenate(parts)
    p53 = np.tile(base53, 300)[:15000].copy()
    p53[::200] ^= 0xFF
    cases["period53_mut"] = p53
    return cases


@pytest.mark.parametrize("name", ["period53", "period4", "period8",
                                  "period64", "runs", "aligned_pages",
                                  "runs_spacers", "period53_mut"])
def test_hybrid_adversarial_ratio_gate(name, rng):
    data = _adversarial_cases(rng)[name]
    comp = encode_block_hybrid_host(data)
    _roundtrip(data, comp)
    ref = np.asarray(compress_raw(data))
    assert len(comp) <= len(ref), \
        f"{name}: chain {len(comp)} > reference {len(ref)}"
