"""Streaming layer tests.

Parity targets: tests/stream/streamCompress.test.mjs,
streamDecompress.test.mjs, shared/lz4Encode.test.mjs, lz4Decode.test.mjs —
including the cross-path validation pattern (stream-compress →
buffer-decompress and vice versa) and the byte-at-a-time FSM stress.
"""

import numpy as np
import pytest

from divortio_lz4 import (
    FrameConfig,
    compress_frame,
    decompress_frame,
)
from divortio_lz4.stream import (
    CompressStream,
    DecompressStream,
    LZ4Decoder,
    LZ4Encoder,
    compress_file,
    decompress_file,
)


def collect(chunks):
    return b"".join(bytes(c) for c in chunks)


def test_encoder_emits_header_on_first_add():
    enc = LZ4Encoder()
    out = enc.add(b"hi")
    assert out and bytes(out[0][:4]) == bytes([0x04, 0x22, 0x4D, 0x18])


def test_encoder_buffers_until_block_size(compressible):
    cfg = FrameConfig(block_size=65536)
    enc = LZ4Encoder(cfg)
    first = enc.add(compressible(1000))
    assert len(first) == 1  # header only, no block yet
    rest = enc.add(compressible(70_000))
    assert len(rest) >= 1  # 64KB block flushed


def test_encoder_finish_emits_endmark():
    enc = LZ4Encoder()
    enc.add(b"data")
    tail = enc.finish()
    assert bytes(tail[-1][-4:]) == b"\x00\x00\x00\x00"


def test_encoder_closed_after_finish():
    enc = LZ4Encoder()
    enc.finish()
    with pytest.raises(RuntimeError, match="closed"):
        enc.add(b"more")


def test_stream_compress_buffer_decompress(compressible):
    # Cross-path: streaming encoder → one-shot frame decoder.
    data = compressible(200_000)
    cfg = FrameConfig(block_size=65536)
    enc = LZ4Encoder(cfg)
    frame = b""
    for i in range(0, len(data), 7919):
        frame += collect(enc.add(data[i: i + 7919]))
    frame += collect(enc.finish())
    out = decompress_frame(np.frombuffer(frame, dtype=np.uint8))
    np.testing.assert_array_equal(out, data)


def test_buffer_compress_stream_decompress(compressible):
    # Cross-path: one-shot frame encoder → streaming FSM decoder.
    data = compressible(200_000)
    frame = bytes(compress_frame(data, config=FrameConfig(block_size=65536)))
    dec = LZ4Decoder()
    out = b""
    for i in range(0, len(frame), 50):  # 50-byte feeds
        out += collect(dec.update(frame[i: i + 50]))
    assert out == bytes(data)
    assert dec.finished_frame


def test_decoder_byte_at_a_time(compressible):
    data = compressible(5000)
    frame = bytes(compress_frame(data))
    dec = LZ4Decoder()
    out = b""
    for i in range(len(frame)):
        out += collect(dec.update(frame[i: i + 1]))
    assert out == bytes(data)


def test_decoder_concatenated_frames(compressible):
    a, b = compressible(3000), bytes(reversed(compressible(2000)))
    frame = bytes(compress_frame(a)) + bytes(compress_frame(b))
    dec = LZ4Decoder()
    out = collect(dec.update(frame))
    assert out == bytes(a) + bytes(b)
    assert dec.finished_frame


def test_decoder_content_checksum_corruption(compressible):
    data = compressible(5000)
    frame = bytearray(
        bytes(compress_frame(data, config=FrameConfig(content_checksum=True))))
    frame[-1] ^= 0xAA
    dec = LZ4Decoder()
    with pytest.raises(ValueError, match="Content Checksum"):
        dec.update(bytes(frame))
    # skip-verify decodes fine
    dec2 = LZ4Decoder(verify_checksum=False)
    assert collect(dec2.update(bytes(frame))) == bytes(data)


def test_decoder_dict_id_verification(compressible):
    data = compressible(5000)
    d = np.frombuffer(b"dictionary-content-shared", dtype=np.uint8)
    frame = bytes(compress_frame(data, dictionary=d))
    with pytest.raises(ValueError, match="requires a Dictionary"):
        LZ4Decoder().update(frame)
    wrong = np.frombuffer(b"some-other-dictionary!!!!", dtype=np.uint8)
    with pytest.raises(ValueError, match="Dictionary ID Mismatch"):
        LZ4Decoder(dictionary=wrong).update(frame)
    out = collect(LZ4Decoder(dictionary=d).update(frame))
    assert out == bytes(data)


def test_stream_roundtrip_with_dictionary(compressible):
    data = compressible(150_000)
    d = np.array(data[:4000])
    cfg = FrameConfig(block_size=65536)
    enc = LZ4Encoder(cfg, dictionary=d)
    frame = collect(enc.add(data)) + collect(enc.finish())
    out = collect(LZ4Decoder(dictionary=d).update(frame))
    assert out == bytes(data)


def test_sliding_window_across_chunk_boundaries(compressible):
    # Linked blocks must match back across block boundaries through the
    # rolling 64KB window (streamCompress.test.mjs:102-126).
    data = compressible(300_000)
    cfg_linked = FrameConfig(block_size=65536, block_independence=False)
    cfg_indep = FrameConfig(block_size=65536, block_independence=True)
    enc_l, enc_i = LZ4Encoder(cfg_linked), LZ4Encoder(cfg_indep)
    frame_l = collect(enc_l.add(data)) + collect(enc_l.finish())
    frame_i = collect(enc_i.add(data)) + collect(enc_i.finish())
    assert len(frame_l) <= len(frame_i)
    assert collect(LZ4Decoder().update(frame_l)) == bytes(data)


def test_stream_block_checksums(compressible):
    data = compressible(150_000)
    cfg = FrameConfig(block_size=65536, block_checksums=True)
    enc = LZ4Encoder(cfg)
    frame = bytearray(collect(enc.add(data)) + collect(enc.finish()))
    assert collect(LZ4Decoder().update(bytes(frame))) == bytes(data)
    frame[30] ^= 0xFF
    with pytest.raises(ValueError, match="Checksum"):
        LZ4Decoder().update(bytes(frame))


def test_transform_stream_pipe(compressible):
    data = bytes(compressible(123_456))
    chunks = [data[i: i + 10_000] for i in range(0, len(data), 10_000)]
    comp = b"".join(CompressStream(FrameConfig(block_size=65536)).pipe(chunks))
    out = b"".join(DecompressStream().pipe([comp[i: i + 8192]
                                            for i in range(0, len(comp), 8192)]))
    assert out == data


def test_file_roundtrip(tmp_path, compressible):
    data = bytes(compressible(500_000))
    src = tmp_path / "input.bin"
    dst = tmp_path / "input.bin.lz4"
    back = tmp_path / "restored.bin"
    src.write_bytes(data)
    csize = compress_file(str(src), str(dst), FrameConfig(block_size=65536))
    assert dst.stat().st_size == csize
    psize = decompress_file(str(dst), str(back))
    assert psize == len(data)
    assert back.read_bytes() == data


def test_stream_content_checksum_roundtrip(compressible):
    data = compressible(100_000)
    cfg = FrameConfig(block_size=65536, content_checksum=True)
    enc = LZ4Encoder(cfg)
    frame = collect(enc.add(data)) + collect(enc.finish())
    # one-shot decoder verifies the streaming encoder's checksum
    out = decompress_frame(np.frombuffer(frame, dtype=np.uint8))
    np.testing.assert_array_equal(out, data)
    # and the streaming decoder verifies it too
    assert collect(LZ4Decoder().update(frame)) == bytes(data)
