"""Header-checksum / dictID / truncation verification on every decode path.

The reference computes the HC byte on encode (bufferCompress.js:176-178) but
never verifies it on decode (bufferDecompress.js:91-92, lz4Decode.js skips).
This framework verifies it on all three decode tiers — a corrupted FLG or
descriptor byte raises a typed error instead of misparsing the frame.
"""

import numpy as np
import pytest

from divortio_lz4 import (
    FrameConfig,
    LZ4Decoder,
    compress_frame,
    decompress_frame,
)
from divortio_lz4.parallel import (
    device_compress_frame,
    device_decompress_frame,
    parse_block_index,
)

DATA = np.frombuffer(b"header verify payload " * 400, dtype=np.uint8)


def _corrupt_flg(frame: np.ndarray) -> np.ndarray:
    bad = np.array(frame)
    bad[4] ^= 0x04  # flip the content-checksum bit in FLG
    return bad


def test_host_decode_rejects_corrupt_flg():
    frame = compress_frame(DATA)
    with pytest.raises(ValueError, match="Header Checksum"):
        decompress_frame(_corrupt_flg(frame))


def test_host_decode_rejects_corrupt_hc_byte():
    frame = np.array(compress_frame(DATA, config=FrameConfig(
        content_size=True)))
    # HC byte sits right after magic+FLG+BD+8-byte content size.
    frame[14] ^= 0xFF
    with pytest.raises(ValueError, match="Header Checksum"):
        decompress_frame(frame)


def test_host_decode_skip_verify_still_decodes():
    frame = np.array(compress_frame(DATA))
    frame[4 + 2 + 8] ^= 0xFF  # corrupt only the HC byte, descriptor intact
    out = decompress_frame(frame, verify_checksum=False)
    np.testing.assert_array_equal(out, DATA)


def test_stream_decoder_rejects_corrupt_flg():
    frame = compress_frame(DATA, config=FrameConfig(content_size=False))
    dec = LZ4Decoder()
    with pytest.raises(ValueError, match="Header Checksum"):
        dec.update(_corrupt_flg(frame))


def test_device_decode_rejects_corrupt_flg():
    frame = device_compress_frame(DATA, FrameConfig(
        block_size=65536, block_independence=True))
    with pytest.raises(ValueError, match="Header Checksum"):
        device_decompress_frame(_corrupt_flg(frame))


def test_golden_frames_pass_header_verification():
    # The reference encoder writes correct HC bytes; golden vectors decode.
    from test_golden import GOLDEN_HELLO  # noqa: PLC0415
    out = decompress_frame(np.frombuffer(bytes.fromhex(GOLDEN_HELLO),
                                         dtype=np.uint8))
    assert bytes(out) == b"Hello World"


def test_buffer_decode_verifies_dict_id():
    d = np.frombuffer(b"dictionary-bytes" * 10, dtype=np.uint8)
    frame = compress_frame(DATA, dictionary=d)
    with pytest.raises(ValueError, match="requires a Dictionary"):
        decompress_frame(frame)
    wrong = np.frombuffer(b"other-dict" * 20, dtype=np.uint8)
    with pytest.raises(ValueError, match="Dictionary ID Mismatch"):
        decompress_frame(frame, dictionary=wrong)
    np.testing.assert_array_equal(decompress_frame(frame, dictionary=d), DATA)


def test_truncated_at_block_checksum_is_malformed():
    cfg = FrameConfig(block_checksums=True, content_checksum=False)
    frame = np.array(compress_frame(DATA, config=cfg))
    # Drop the final EndMark (4) and the last block checksum (4), so the
    # frame ends exactly where a block checksum should begin.
    cut = frame[:-8]
    with pytest.raises(ValueError, match="Malformed"):
        decompress_frame(cut)


def test_parse_block_index_rejects_truncated_block():
    frame = np.array(device_compress_frame(DATA, FrameConfig(
        block_size=65536, block_independence=True)))
    cut = frame[: len(frame) // 2]
    with pytest.raises(ValueError, match="Malformed|Checksum"):
        parse_block_index(cut)


def test_parse_block_index_requires_endmark():
    frame = np.array(device_compress_frame(DATA, FrameConfig(
        block_size=65536, block_independence=True)))
    cut = frame[:-4]  # exactly the EndMark removed
    with pytest.raises(ValueError, match="Malformed"):
        parse_block_index(cut)


def test_device_decode_content_checksum_truncated():
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)
    frame = np.array(device_compress_frame(DATA, cfg))
    cut = frame[:-2]  # half the trailing content checksum
    with pytest.raises(ValueError, match="Malformed"):
        device_decompress_frame(cut)
