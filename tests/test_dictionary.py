"""Dictionary support (parity with tests/dictionary/dictionary.test.mjs)."""

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame

DICT_STRING = b"CommonPrefix_SharedData_Reference_1234567890"
MSG_1 = DICT_STRING + b"_UniquePartA"
DICT = np.frombuffer(DICT_STRING, dtype=np.uint8)
INPUT1 = np.frombuffer(MSG_1, dtype=np.uint8)


def test_dictionary_improves_ratio():
    no_dict = compress_frame(INPUT1)
    with_dict = compress_frame(INPUT1, dictionary=DICT)
    assert len(with_dict) < len(no_dict)


def test_decompress_without_dictionary_fails():
    comp = compress_frame(INPUT1, dictionary=DICT)
    with pytest.raises(ValueError, match="(?i)dictionary"):
        decompress_frame(comp)


def test_roundtrip_with_dictionary():
    comp = compress_frame(INPUT1, dictionary=DICT)
    out = decompress_frame(comp, dictionary=DICT)
    assert bytes(out) == MSG_1


def test_dict_id_flag_in_header():
    comp = compress_frame(INPUT1, dictionary=DICT)
    assert comp[4] & 0x01  # FLG dictID bit


def test_large_dictionary_uses_last_64kb(rng):
    big_dict = rng.integers(0, 256, 100_000, dtype=np.uint8)
    tail = big_dict[-1000:]
    payload = np.concatenate([tail, tail])  # matches against dict tail
    comp = compress_frame(payload, dictionary=big_dict)
    out = decompress_frame(comp, dictionary=big_dict)
    np.testing.assert_array_equal(out, payload)


def test_multiblock_with_dictionary(compressible):
    data = compressible(150_000)
    d = np.array(data[:8000])
    cfg = FrameConfig(block_size=65536)
    comp = compress_frame(data, dictionary=d, config=cfg)
    out = decompress_frame(comp, dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_chunked_decode_with_dictionary(compressible):
    # content_size off forces the rolling-window chunked strategy with the
    # dictionary pre-seeded (bufferDecompress.js:113-123).
    data = compressible(150_000)
    d = np.array(data[:8000])
    cfg = FrameConfig(block_size=65536, content_size=False)
    comp = compress_frame(data, dictionary=d, config=cfg)
    out = decompress_frame(comp, dictionary=d)
    np.testing.assert_array_equal(out, data)
