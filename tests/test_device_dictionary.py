"""Device-tier dictionary support (VERDICT round-1 item 3 / ADVICE high).

The device frame codec plumbs the dictionary into the kernels' history
inputs (encode_xla hist_len/hist_start, decode_xla hist rows, the linked
scans' init window), matching the host tier's semantics
(/root/reference/src/buffer/bufferCompress.js:109-125,
blockDecompress.js:145-154). Cross-tier: every combination of
host/device x encode/decode round-trips with the dictionary.
"""

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame
from divortio_lz4.parallel import (
    ShardedCodec,
    device_compress_frame,
    device_decompress_frame,
    make_mesh,
)

CFG_I = FrameConfig(block_size=65536, block_independence=True)
CFG_L = FrameConfig(block_size=65536, block_independence=False)


def _dict_and_payload(compressible, n=150_000, dict_n=8000):
    data = np.asarray(compressible(n))
    d = np.array(data[:dict_n])
    return d, data


def test_device_encode_dict_improves_ratio(compressible):
    d, data = _dict_and_payload(compressible)
    plain = device_compress_frame(data[:4000], CFG_I)
    with_dict = device_compress_frame(data[:4000], CFG_I, dictionary=d)
    assert len(with_dict) < len(plain)


def test_device_encode_dict_host_decode(compressible):
    d, data = _dict_and_payload(compressible)
    frame = device_compress_frame(data, CFG_I, dictionary=d)
    assert frame[4] & 0x01  # FLG dictID bit set
    out = decompress_frame(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_host_encode_dict_device_decode(compressible):
    d, data = _dict_and_payload(compressible)
    frame = compress_frame(data, dictionary=d, config=CFG_I)
    out = device_decompress_frame(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_device_roundtrip_with_dict(compressible):
    d, data = _dict_and_payload(compressible)
    frame = device_compress_frame(data, CFG_I, dictionary=d)
    out = device_decompress_frame(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_device_decode_dict_frame_without_dict_raises(compressible):
    d, data = _dict_and_payload(compressible)
    frame = np.array(device_compress_frame(data, CFG_I, dictionary=d))
    with pytest.raises(ValueError, match="requires a Dictionary"):
        device_decompress_frame(frame)
    wrong = np.frombuffer(b"not-the-dict" * 30, dtype=np.uint8)
    with pytest.raises(ValueError, match="Dictionary ID Mismatch"):
        device_decompress_frame(frame, dictionary=wrong)


def test_device_decode_dict_pallas_engine(compressible):
    d, data = _dict_and_payload(compressible)
    frame = compress_frame(data, dictionary=d, config=CFG_I)
    out = device_decompress_frame(np.array(frame), engine="pallas",
                                  dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_device_linked_roundtrip_with_dict(compressible):
    d, data = _dict_and_payload(compressible)
    frame = device_compress_frame(data, CFG_L, dictionary=d)
    assert frame[4] & 0x01
    np.testing.assert_array_equal(
        decompress_frame(np.array(frame), dictionary=d), data)
    np.testing.assert_array_equal(
        device_decompress_frame(np.array(frame), dictionary=d), data)


def test_host_linked_dict_device_decode(compressible):
    d, data = _dict_and_payload(compressible)
    frame = compress_frame(data, dictionary=d, config=CFG_L)
    out = device_decompress_frame(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, data)


def test_dict_references_resolve_exactly():
    # Payload that matches ONLY into the dictionary: device decode must
    # read real dict bytes, not zero history.
    d = np.frombuffer(b"The quick brown fox jumps over the lazy dog. " * 100,
                      dtype=np.uint8)
    payload = np.concatenate([d[:2000], d[3000:5000]])
    frame = compress_frame(payload, dictionary=d, config=CFG_I)
    out = device_decompress_frame(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, payload)


def test_large_dict_uses_last_64kb_device(rng):
    big_dict = rng.integers(0, 256, 100_000, dtype=np.uint8)
    tail = big_dict[-1000:]
    payload = np.concatenate([tail, tail])
    frame = device_compress_frame(payload, CFG_I, dictionary=big_dict)
    out = device_decompress_frame(np.array(frame), dictionary=big_dict)
    np.testing.assert_array_equal(out, payload)


def test_sharded_codec_dict_roundtrip(compressible):
    codec = ShardedCodec(make_mesh(4))
    d, data = _dict_and_payload(compressible, n=300_000)
    frame = codec.compress(data, dictionary=d)
    out = codec.decompress(np.array(frame), dictionary=d)
    np.testing.assert_array_equal(out, data)
    # cross-tier both directions
    np.testing.assert_array_equal(
        decompress_frame(np.array(frame), dictionary=d), data)
    host_frame = compress_frame(data, dictionary=d, config=CFG_I)
    np.testing.assert_array_equal(
        codec.decompress(np.array(host_frame), dictionary=d), data)
