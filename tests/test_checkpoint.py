"""Checkpoint/resume of streaming sessions (SURVEY §5.4 state tuple).

The LZ4 wire format makes any frame boundary a safe resume point; these
tests prove the *mid-stream* state (window, hasher, FSM) snapshots and
restores bit-exactly — including across a pickle round trip (process
migration).
"""

import pickle

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, XXHash32, decompress_frame, xxhash32
from divortio_lz4.stream import LZ4Decoder, LZ4Encoder


def collect(parts):
    return b"".join(bytes(p) for p in parts)


def test_hasher_state_roundtrip():
    h = XXHash32(7)
    h.update(b"first part of the data, deliberately not 16-aligned..")
    h2 = XXHash32.from_state(pickle.loads(pickle.dumps(h.state_dict())))
    h.update(b"tail")
    h2.update(b"tail")
    assert h.digest() == h2.digest()


def test_encoder_checkpoint_mid_stream(compressible):
    data = bytes(compressible(300_000))
    cfg = FrameConfig(block_size=65536, content_checksum=True)

    # Uninterrupted reference run.
    enc_ref = LZ4Encoder(cfg)
    frame_ref = collect(enc_ref.add(data)) + collect(enc_ref.finish())

    # Interrupted at an arbitrary mid-stream point, resumed from snapshot.
    enc = LZ4Encoder(cfg)
    out1 = collect(enc.add(data[:150_000]))
    snap = pickle.dumps(enc.state_dict())
    enc2 = LZ4Encoder.from_state(pickle.loads(snap))
    out2 = collect(enc2.add(data[150_000:])) + collect(enc2.finish())

    assert out1 + out2 == frame_ref
    np.testing.assert_array_equal(
        decompress_frame(np.frombuffer(out1 + out2, np.uint8)),
        np.frombuffer(data, np.uint8))


def test_decoder_checkpoint_mid_frame(compressible):
    from divortio_lz4 import compress_frame
    data = bytes(compressible(300_000))
    frame = bytes(compress_frame(
        data, config=FrameConfig(block_size=65536, content_checksum=True)))

    cut = len(frame) // 2
    dec = LZ4Decoder()
    part1 = collect(dec.update(frame[:cut]))
    snap = pickle.dumps(dec.state_dict())
    dec2 = LZ4Decoder.from_state(pickle.loads(snap))
    part2 = collect(dec2.update(frame[cut:]))
    assert part1 + part2 == data
    assert dec2.finished_frame


def test_decoder_checkpoint_preserves_dictionary(compressible):
    from divortio_lz4 import compress_frame
    data = np.asarray(compressible(120_000))
    d = np.array(data[:5000])
    frame = bytes(compress_frame(data, dictionary=d,
                                 config=FrameConfig(block_size=65536)))
    dec = LZ4Decoder(dictionary=d)
    part1 = collect(dec.update(frame[:100]))
    dec2 = LZ4Decoder.from_state(dec.state_dict())
    part2 = collect(dec2.update(frame[100:]))
    assert part1 + part2 == bytes(data)
