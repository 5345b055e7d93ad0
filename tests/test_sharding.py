"""Multi-device sharded codec on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from divortio_lz4 import FrameConfig, decompress_frame, compress_frame
from divortio_lz4.parallel import (
    ShardedCodec,
    device_compress_frame,
    device_decompress_frame,
    make_mesh,
)


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_device_frame_roundtrip(compressible):
    data = np.asarray(compressible(50_000))
    cfg = FrameConfig(block_size=65536, block_independence=True)
    frame = device_compress_frame(data, cfg)
    out = device_decompress_frame(np.array(frame))
    np.testing.assert_array_equal(out, data)


def test_device_frame_cross_host(compressible):
    # device-encode → host frame decode, and host-encode → device decode.
    data = np.asarray(compressible(150_000))
    cfg = FrameConfig(block_size=65536, block_independence=True)
    dev_frame = device_compress_frame(data, cfg)
    np.testing.assert_array_equal(decompress_frame(np.array(dev_frame)), data)
    host_frame = compress_frame(data, config=cfg)
    np.testing.assert_array_equal(
        device_decompress_frame(np.array(host_frame)), data)


def test_device_decode_linked_frame(compressible):
    data = np.asarray(compressible(150_000))
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = compress_frame(data, config=cfg)
    out = device_decompress_frame(np.array(frame))
    np.testing.assert_array_equal(out, data)


def test_device_linked_encode_cross_host(compressible):
    # Device linked-scan encoder -> host decoder, and ratio beats the
    # device-independent encoding (cross-block window matches).
    data = np.asarray(compressible(200_000))
    linked = device_compress_frame(
        data, FrameConfig(block_size=65536, block_independence=False))
    np.testing.assert_array_equal(decompress_frame(np.array(linked)), data)
    indep = device_compress_frame(
        data, FrameConfig(block_size=65536, block_independence=True))
    assert len(linked) <= len(indep)
    # and the device linked decoder round-trips its own encoder
    np.testing.assert_array_equal(
        device_decompress_frame(np.array(linked)), data)


def test_device_linked_with_stored_blocks(rng, compressible):
    # Mixed chain: incompressible (stored) blocks interleave with
    # compressible ones; the window must advance through stored bytes.
    data = np.concatenate([
        np.asarray(compressible(70_000)),
        rng.integers(0, 256, 70_000, dtype=np.uint8),
        np.asarray(compressible(70_000)),
    ])
    cfg = FrameConfig(block_size=65536, block_independence=False)
    frame = compress_frame(data, config=cfg)  # host encode (has stored blk)
    out = device_decompress_frame(np.array(frame))
    np.testing.assert_array_equal(out, data)


def test_sharded_codec_roundtrip(compressible):
    codec = ShardedCodec(make_mesh(8))
    data = np.asarray(compressible(300_000))  # 5 blocks over 8 devices
    frame = codec.compress(data)
    out = codec.decompress(np.array(frame))
    np.testing.assert_array_equal(out, data)


def test_sharded_interops_with_host_paths(compressible, rng):
    codec = ShardedCodec(make_mesh(4))
    data = np.concatenate([np.asarray(compressible(200_000)),
                           rng.integers(0, 256, 100_000, dtype=np.uint8)])
    frame = codec.compress(data)
    # host one-shot decoder consumes the sharded frame
    np.testing.assert_array_equal(decompress_frame(np.array(frame)), data)
    # sharded decoder consumes a host frame
    host_frame = compress_frame(
        data, config=FrameConfig(block_size=65536, block_independence=True))
    np.testing.assert_array_equal(codec.decompress(np.array(host_frame)), data)


def test_sharded_linked_roundtrip(compressible):
    # Linked frames shard at encode time (per-row plaintext windows);
    # output is byte-identical to the single-device linked encoder and
    # ratio beats independent mode (cross-block window matches).
    codec = ShardedCodec(make_mesh(4),
                         config=FrameConfig(block_size=65536,
                                            block_independence=False))
    data = np.asarray(compressible(300_000))
    frame = codec.compress(data)
    single = device_compress_frame(
        data, FrameConfig(block_size=65536, block_independence=False))
    assert bytes(frame) == bytes(single)
    np.testing.assert_array_equal(decompress_frame(np.array(frame)), data)
    np.testing.assert_array_equal(codec.decompress(np.array(frame)), data)
    indep = ShardedCodec(make_mesh(4)).compress(data)
    assert len(frame) <= len(indep)


def test_sharded_linked_with_dictionary(compressible):
    codec = ShardedCodec(make_mesh(4),
                         config=FrameConfig(block_size=65536,
                                            block_independence=False))
    data = np.asarray(compressible(200_000))
    d = np.array(data[:8000])
    frame = codec.compress(data, dictionary=d)
    np.testing.assert_array_equal(
        decompress_frame(np.array(frame), dictionary=d), data)
    np.testing.assert_array_equal(
        codec.decompress(np.array(frame), dictionary=d), data)


def test_device_frame_with_checksums(compressible):
    data = np.asarray(compressible(80_000))
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True, block_checksums=True)
    frame = np.array(device_compress_frame(data, cfg))
    out = device_decompress_frame(frame)
    np.testing.assert_array_equal(out, data)
    bad = frame.copy()
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="Checksum"):
        device_decompress_frame(bad)


def test_device_decode_pallas_engine(compressible, rng):
    # engine="pallas" decode takes the split route (region kernel,
    # interpret mode on CPU), incl. stored rows.
    data = np.concatenate([np.asarray(compressible(150_000)),
                           rng.integers(0, 256, 70_000, dtype=np.uint8)])
    cfg = FrameConfig(block_size=65536, block_independence=True)
    frame = compress_frame(data, config=cfg)
    out = device_decompress_frame(np.array(frame), engine="pallas")
    np.testing.assert_array_equal(out, data)


def test_device_encode_pallas_engine(compressible, rng):
    # engine="pallas" encode is gone (the native host tier is the
    # byte-identical encoder): it raises, naming the supported engines,
    # rather than rerouting silently.
    data = np.asarray(compressible(10_000))
    cfg = FrameConfig(block_size=65536, block_independence=True)
    with pytest.raises(ValueError, match="xla, split"):
        device_compress_frame(data, cfg, engine="pallas")
    with pytest.raises(ValueError, match="xla, split"):
        device_compress_frame(data, cfg, engine="hybrid")


def test_sharded_codec_best_engine(compressible, rng):
    """engine='best' (chain-direct encoder + region decode kernel on
    every device): round-trips through itself and cross-validates with
    the host tier."""
    codec = ShardedCodec(make_mesh(4),
                         FrameConfig(block_size=4096,
                                     block_independence=True),
                         engine="best")
    data = np.concatenate([np.asarray(compressible(60_000)),
                           rng.integers(0, 256, 9_000, dtype=np.uint8)])
    frame = codec.compress(data)
    np.testing.assert_array_equal(codec.decompress(np.array(frame)), data)
    # host one-shot decoder consumes the best-engine sharded frame
    np.testing.assert_array_equal(decompress_frame(np.array(frame)), data)
    # best-engine decoder consumes a host frame
    host_frame = compress_frame(
        data, config=FrameConfig(block_size=4096, block_independence=True))
    np.testing.assert_array_equal(codec.decompress(np.array(host_frame)),
                                  data)
    # ratio gate vs the reference-identical host encoder
    assert len(frame) <= len(host_frame)


def test_sharded_best_engine_dictionary(compressible):
    d = np.asarray(compressible(9000))
    codec = ShardedCodec(make_mesh(4),
                         FrameConfig(block_size=4096,
                                     block_independence=True),
                         engine="best")
    data = np.asarray(compressible(30_000))
    frame = codec.compress(data, dictionary=d)
    np.testing.assert_array_equal(
        codec.decompress(np.array(frame), dictionary=d), data)
    np.testing.assert_array_equal(
        decompress_frame(np.array(frame), dictionary=d), data)
