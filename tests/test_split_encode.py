"""Chain-direct encoder (device candidate chains + host select/extend/
serialize): native == Python serializer wire identity, round-trips, ratio
gates, frame and streaming integration."""

import numpy as np
import pytest

import divortio_lz4 as lz4
from divortio_lz4.ops.split_encode import (
    _chain_serialize16_py,
    chain_select_serialize,
    encode_block_split_host,
    encode_blocks_chain,
)


def _py_serialized(data, exact=True):
    """The same block through the pure-Python serializer."""
    n = len(data)
    bs = max(-(-n // 1024) * 1024, 1024)
    work = np.zeros((1, bs), np.int32)
    work[0, :n] = data
    chains = np.asarray(encode_blocks_chain(
        work, np.array([n], np.int32), bs, exact=exact))
    wk = np.zeros(bs + 8, np.uint8)
    wk[:n] = data
    return _chain_serialize16_py(wk, 0, n, chains[0])


def _roundtrip(data, comp):
    out = np.empty(max(len(data), 1), np.uint8)
    n = lz4.decompress_raw(np.asarray(comp), out)
    assert n == len(data)
    np.testing.assert_array_equal(out[: len(data)], data)


CASES = {
    "text": np.frombuffer(b"the quick brown fox jumps! " * 500, np.uint8),
    "rle": np.full(30000, 7, np.uint8),
    "period3": np.tile(np.array([1, 2, 3], np.uint8), 9000),
    "json": np.frombuffer(b'{"a":1,"bb":"xyz"}' * 800, np.uint8),
    "long_matches": np.tile(np.frombuffer(b"0123456789abcdef", np.uint8),
                            1500),
    "tiny": np.frombuffer(b"abcabcabcabc", np.uint8),
    "empty": np.zeros(0, np.uint8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_encode_matches_hybrid_wire(name):
    data = CASES[name]
    c = encode_block_split_host(data, exact=True)
    _roundtrip(data, c)
    if len(data):
        # exact chains: same candidates + same greedy + same exact
        # extension => same bytes from the native and Python serializers
        np.testing.assert_array_equal(np.asarray(c),
                                      np.asarray(_py_serialized(data)))
    ref = np.asarray(lz4.compress_raw(data))
    assert len(c) <= max(len(ref), 1)
    # production hashed sort diet: collisions are verified away on host;
    # the stream stays valid and within the reference's size
    ch = encode_block_split_host(data)
    _roundtrip(data, ch)
    assert len(ch) <= max(len(ref), 1)


@pytest.mark.parametrize("name", ["period53", "period4", "period8",
                                  "period64", "runs", "aligned_pages",
                                  "runs_spacers", "period53_mut"])
def test_chain_encode_hashed_adversarial_ratio_gate(name, rng):
    """The hashed sort diet shares the reference table's collision
    exposure — fence it with the same adversarial corpora as the exact
    chains' gate (plus the decode-correctness roundtrip)."""
    from test_hybrid_encode import _adversarial_cases

    data = _adversarial_cases(rng)[name]
    comp = encode_block_split_host(data)
    _roundtrip(data, comp)
    ref = np.asarray(lz4.compress_raw(data))
    assert len(comp) <= len(ref), \
        f"{name}: hashed chain {len(comp)} > reference {len(ref)}"


def test_chain_encode_random_incompressible(rng):
    data = rng.integers(0, 256, 5000, dtype=np.uint8)
    _roundtrip(data, encode_block_split_host(data))


def test_chain_encode_mixed_corpus(compressible):
    data = np.asarray(compressible(40000))
    c = encode_block_split_host(data, block_size=40960)
    _roundtrip(data, c)
    assert len(c) <= len(np.asarray(lz4.compress_raw(data)))


def test_chain_encode_batch_varied_lens(compressible, rng):
    B = 2048
    rows = [
        np.asarray(compressible(B)),
        np.zeros(B, np.uint8),
        rng.integers(0, 256, B, np.uint8),
        np.concatenate([np.asarray(compressible(B // 2)),
                        np.zeros(B // 2, np.uint8)]),
    ]
    lens = np.array([B, B, B, B // 2], np.int32)
    work = np.zeros((4, B), np.int32)
    for i, r in enumerate(rows):
        work[i] = r
    chains = np.asarray(encode_blocks_chain(work, lens, B))
    for i in range(4):
        src_len = int(lens[i])
        wk = np.zeros(B + 8, np.uint8)
        wk[:B] = rows[i]
        c = chain_select_serialize(wk, 0, src_len, chains[i])
        _roundtrip(rows[i][:src_len], c)


def test_chain_encode_history_row(compressible):
    """Dictionary/linked-style [history | payload] rows: back-references
    into the history resolve during host extension."""
    from divortio_lz4.constants import WINDOW_SIZE

    data = np.asarray(compressible(9000))
    hist, payload = data[:4096], data[4096:]
    hl = WINDOW_SIZE
    work = np.zeros((1, hl + 8192), np.int32)
    work[0, hl - len(hist): hl] = hist
    work[0, hl: hl + len(payload)] = payload
    chains = np.asarray(encode_blocks_chain(
        work, np.array([len(payload)], np.int32), 8192, hl,
        hl - len(hist)))
    wk = np.zeros(hl + len(payload) + 8, np.uint8)
    wk[hl - len(hist): hl] = hist
    wk[hl: hl + len(payload)] = payload
    c = chain_select_serialize(wk, hl, len(payload), chains[0])
    out = np.empty(len(payload), np.uint8)
    from divortio_lz4.ops.block_ref import decompress_block_ref
    n = decompress_block_ref(np.asarray(c), 0, len(c), out, 0, hist)
    assert n == len(payload)
    np.testing.assert_array_equal(out, payload)


def test_chain_serializers_agree(compressible):
    """Native u16 == Python u16 serializer, over the same candidate
    search, exact and hashed."""
    data = np.asarray(compressible(8192))
    work = data.astype(np.int32).reshape(1, -1)
    lens = np.array([8192], np.int32)
    chains = np.asarray(encode_blocks_chain(work, lens, 8192, exact=True))
    assert chains.dtype == np.uint16
    wk = np.zeros(8192 + 8, np.uint8)
    wk[:8192] = data
    a = chain_select_serialize(wk, 0, 8192, chains[0])
    b = _chain_serialize16_py(wk, 0, 8192, chains[0])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # hashed chains: native and Python serializers must also agree on the
    # VERIFIED (collision-filtered) stream
    hashed = np.asarray(encode_blocks_chain(work, lens, 8192))
    ah = chain_select_serialize(wk, 0, 8192, hashed[0])
    bh = _chain_serialize16_py(wk, 0, 8192, hashed[0])
    np.testing.assert_array_equal(np.asarray(ah), np.asarray(bh))
    _roundtrip(data, ah)


def test_chain_serializer_rejects_false_candidates():
    """A hashed chain may CLAIM a match whose bytes differ (hash collision)
    — the serializer must verify 4 bytes and skip it, producing a valid
    stream, for both the native and the Python serializer."""
    data = np.frombuffer(b"abcdefgh" * 8 + b"ABCDWXYZ" * 8, np.uint8)
    n = len(data)
    wk = np.zeros(n + 8, np.uint8)
    wk[:n] = data
    dist16 = np.zeros(n, np.uint16)
    dist16[64] = 64   # claims data[64:68]==data[0:4]: FALSE ('ABCD' vs 'abcd')
    dist16[72] = 8    # true: 'ABCDWXYZ' repeats with period 8
    a = chain_select_serialize(wk, 0, n, dist16)
    b = _chain_serialize16_py(wk, 0, n, dist16)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _roundtrip(data, a)
    # the false candidate must not have been emitted as a match
    out = np.empty(n, np.uint8)
    assert lz4.decompress_raw(np.asarray(a), out) == n


def test_chain_encode_long_match_single_sequence(rng):
    """A 1 KB+ match must serialize as ONE sequence (exact extension runs
    to the limit, not a compare-window cap)."""
    pat = rng.integers(0, 256, 64, dtype=np.uint8)
    data = np.concatenate([pat, np.tile(pat, 20)])
    c = encode_block_split_host(data, exact=True)
    _roundtrip(data, c)
    np.testing.assert_array_equal(
        np.asarray(c), np.asarray(_py_serialized(data)))
    ch = encode_block_split_host(data)
    _roundtrip(data, ch)
    assert len(ch) <= len(c) + 8  # hashed diet: same single-sequence shape


def test_chain_encode_frame_paths(compressible):
    from divortio_lz4.parallel.device import device_compress_frame

    corpus = np.asarray(compressible(150000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    f = device_compress_frame(corpus, cfg, engine="split")
    out = lz4.decompress(np.asarray(f))
    np.testing.assert_array_equal(np.asarray(out), corpus)
    assert len(f) <= len(lz4.compress(corpus, config=cfg))
    d = bytes(corpus[:4096].tobytes())
    fd = device_compress_frame(corpus[:80000], cfg, engine="split",
                               dictionary=d)
    out = lz4.decompress(np.asarray(fd), dictionary=d)
    np.testing.assert_array_equal(np.asarray(out), corpus[:80000])


def test_device_streaming_engines(compressible, rng):
    """backend="device" streaming: encoder batches full blocks through the
    chain-direct encoder; decoder batches buffered blocks through the split
    kernel; cross-checked against the host tier both ways."""
    from divortio_lz4.stream import LZ4Decoder, LZ4Encoder

    corpus = np.concatenate([np.asarray(compressible(400000)),
                             rng.integers(0, 256, 70000, np.uint8)])
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True,
                          content_checksum=True)
    enc = LZ4Encoder(cfg, backend="device")
    frame = b"".join(bytes(c) for c in enc.add(corpus))
    frame += b"".join(bytes(c) for c in enc.finish())
    out = lz4.decompress(np.frombuffer(frame, np.uint8))
    np.testing.assert_array_equal(np.asarray(out), corpus)
    assert len(frame) <= len(np.asarray(lz4.compress(corpus, config=cfg)))

    ref = np.asarray(lz4.compress(corpus, config=cfg)).tobytes()
    dec = LZ4Decoder(backend="device")
    got = b"".join(bytes(c) for c in dec.update(ref))
    assert got == corpus.tobytes()
    # fragmented feed still batches whatever is complete
    dec = LZ4Decoder(backend="device")
    got = b""
    for i in range(0, len(frame), 150_000):
        got += b"".join(bytes(c) for c in dec.update(frame[i: i + 150_000]))
    assert got == corpus.tobytes()

def test_streaming_backend_observability(compressible, rng):
    """VERDICT r3 #7: stats counters tell which backend served each block
    instead of leaving offload behavior untelegraphed."""
    from divortio_lz4.stream import LZ4Decoder, LZ4Encoder

    corpus = np.asarray(compressible(400000))  # 6 full 64K blocks + tail
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    enc = LZ4Encoder(cfg, backend="device")
    frame = b"".join(bytes(c) for c in enc.add(corpus))
    frame += b"".join(bytes(c) for c in enc.finish())
    assert enc.stats["device_blocks"] == 6
    assert enc.stats["host_blocks"] == 1  # the 6.1th (remainder) block
    out = lz4.decompress(np.frombuffer(frame, np.uint8))
    np.testing.assert_array_equal(np.asarray(out), corpus)

    host_enc = LZ4Encoder(cfg)  # default backend never offloads
    host_enc.add(corpus)
    host_enc.finish()
    assert host_enc.stats["device_blocks"] == 0
    assert host_enc.stats["host_blocks"] == 7

    dec = LZ4Decoder(backend="device")
    got = b"".join(bytes(c) for c in dec.update(frame))
    assert got == corpus.tobytes()
    assert dec.stats["device_blocks"] >= 4
    assert dec.stats["device_blocks"] + dec.stats["host_blocks"] == 7


def test_streaming_linked_device_offload(compressible, rng):
    """Linked-frame bursts offload through the chain-direct encoder with
    per-row history slices (VERDICT r3 #7); the stream stays spec-valid,
    window-continuous across the burst boundary, and no larger than the
    host tier's."""
    from divortio_lz4.stream import LZ4Encoder

    corpus = np.concatenate([np.asarray(compressible(380000)),
                             rng.integers(0, 256, 30000, np.uint8)])
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False,
                          content_checksum=True)
    enc = LZ4Encoder(cfg, backend="device")
    frame = b""
    # feed 100 KB fragments: bursts interleave with host-flushed blocks,
    # so the carried window crosses device/host boundaries both ways
    for i in range(0, len(corpus), 100000):
        frame += b"".join(bytes(c) for c in enc.add(corpus[i: i + 100000]))
    frame += b"".join(bytes(c) for c in enc.finish())
    assert enc.stats["device_blocks"] == 0  # 100 KB < 4 blocks: host path

    enc2 = LZ4Encoder(cfg, backend="device")
    frame2 = b"".join(bytes(c) for c in enc2.add(corpus))
    frame2 += b"".join(bytes(c) for c in enc2.finish())
    assert enc2.stats["device_blocks"] == 6
    out = lz4.decompress(np.frombuffer(frame2, np.uint8))
    np.testing.assert_array_equal(np.asarray(out), corpus)
    # linked window reaches across blocks: must beat the independent frame
    indep = lz4.compress(corpus, config=lz4.FrameConfig(
        block_size=65536, block_independence=True))
    assert len(frame2) <= len(np.asarray(indep)) + 64
    # burst resumed mid-stream: carried history stays consistent
    enc3 = LZ4Encoder(cfg, backend="device")
    frame3 = b"".join(bytes(c) for c in enc3.add(corpus[:70000]))
    frame3 += b"".join(bytes(c) for c in enc3.add(corpus[70000:]))
    frame3 += b"".join(bytes(c) for c in enc3.finish())
    assert enc3.stats["device_blocks"] >= 4
    out3 = lz4.decompress(np.frombuffer(frame3, np.uint8))
    np.testing.assert_array_equal(np.asarray(out3), corpus)

def test_chain_encode_linked_frame(compressible):
    """engine='split' covers LINKED frames natively (per-block known-
    plaintext history rows); the linked window beats the independent
    frame on this corpus."""
    from divortio_lz4.parallel.device import device_compress_frame

    corpus = np.asarray(compressible(150000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    f = device_compress_frame(corpus, cfg, engine="split")
    h = device_compress_frame(corpus, cfg.with_(block_independence=True),
                              engine="split")
    assert len(f) <= len(h) + 64
    out = lz4.decompress(np.asarray(f))
    np.testing.assert_array_equal(np.asarray(out), corpus)
    assert len(f) <= len(lz4.compress(corpus, config=cfg))
    # dictionary + checksums
    d = bytes(corpus[:4096].tobytes())
    cfgc = lz4.FrameConfig(block_size=65536, block_independence=False,
                           content_checksum=True, block_checksums=True)
    fd = device_compress_frame(corpus[:80000], cfgc, engine="split",
                               dictionary=d)
    out = lz4.decompress(np.asarray(fd), dictionary=d)
    np.testing.assert_array_equal(np.asarray(out), corpus[:80000])


@pytest.mark.gpu
def test_chain_encode_gpu_parity(compressible):
    """The chain kernel compiled for the card: frames decode bit-exact on
    the host tier and hold the ratio gate vs the reference-identical host
    encoder."""
    from divortio_lz4.parallel.device import device_compress_frame

    corpus = np.asarray(compressible(2_000_000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    f = device_compress_frame(corpus, cfg, engine="split")
    out = lz4.decompress(np.asarray(f))
    np.testing.assert_array_equal(np.asarray(out), corpus)
    assert len(f) <= len(lz4.compress(corpus, config=cfg))


def test_multiframe_pipelined_roundtrip(compressible, rng):
    """device_compress_frames/device_decompress_frames (VERDICT r3 #5):
    N frames in flight, results identical to the per-frame calls."""
    from divortio_lz4.parallel.device import (
        device_compress_frame, device_compress_frames,
        device_decompress_frame, device_decompress_frames)

    cfg = lz4.FrameConfig(block_size=65536, block_independence=True,
                          content_checksum=True)
    datas = [np.asarray(compressible(150000 + 7000 * i)) for i in range(4)]
    datas.append(rng.integers(0, 256, 90000, np.uint8))  # stored blocks
    frames = device_compress_frames(datas, cfg, engine="split")
    for d, f in zip(datas, frames):
        one = device_compress_frame(d, cfg, engine="split")
        np.testing.assert_array_equal(np.asarray(f), np.asarray(one))
        np.testing.assert_array_equal(
            np.asarray(lz4.decompress(np.asarray(f))), d)
    outs = device_decompress_frames(frames, engine="split")
    for d, o in zip(datas, outs):
        np.testing.assert_array_equal(np.asarray(o), d)
    # linked frames ride the same pipeline as one region
    lcfg = lz4.FrameConfig(block_size=65536, block_independence=False)
    mixed = [np.asarray(lz4.compress(datas[0], config=lcfg)), frames[1]]
    outs = device_decompress_frames(mixed, engine="split")
    np.testing.assert_array_equal(np.asarray(outs[0]), datas[0])
    np.testing.assert_array_equal(np.asarray(outs[1]), datas[1])
    # checksum verification still bites in the pipelined path
    bad = np.array(frames[0])
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError):
        device_decompress_frames([bad], engine="split")


def test_multiframe_facade_exports(compressible):
    data = np.asarray(compressible(140000))
    cfg = lz4.FrameConfig(block_size=65536, block_independence=True)
    frames = lz4.compress_frames([data, data[:70000]], cfg)
    outs = lz4.decompress_frames(frames)
    np.testing.assert_array_equal(np.asarray(outs[0]), data)
    np.testing.assert_array_equal(np.asarray(outs[1]), data[:70000])
