"""Low-level helpers (parity with tests/shared/lz4Base.test.mjs)."""

import numpy as np
import pytest

from divortio_lz4 import ensure_buffer
from divortio_lz4.constants import (
    BLOCK_MAX_SIZES,
    block_bound,
    frame_bound,
    get_block_id,
)
from divortio_lz4.utils import read_u32le, write_u32le


@pytest.mark.parametrize("v", [0, 1, 0xFF, 0x1234, 0xDEADBEEF, 0xFFFFFFFF])
def test_u32le_write_read_symmetry(v):
    buf = np.zeros(8, np.uint8)
    write_u32le(buf, 2, v)
    assert read_u32le(buf, 2) == v


def test_u32le_is_little_endian():
    buf = np.zeros(4, np.uint8)
    write_u32le(buf, 0, 0x04224D18)
    assert list(buf) == [0x18, 0x4D, 0x22, 0x04]


@pytest.mark.parametrize("size,bid", [
    (0, 4), (1, 4), (65536, 4), (65537, 5), (262144, 5), (262145, 6),
    (1048576, 6), (1048577, 7), (4194304, 7), (10 ** 9, 7)])
def test_block_id_mapping(size, bid):
    assert get_block_id(size) == bid
    if size:
        assert BLOCK_MAX_SIZES[get_block_id(size)] >= min(size, 4194304)


def test_block_bound_covers_worst_case():
    # Worst case: n incompressible bytes = token-run overhead.
    from divortio_lz4 import compress_raw
    rng = np.random.default_rng(5)
    for n in (1, 14, 15, 16, 254, 255, 256, 5000):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        comp = compress_raw(data)
        assert len(comp) <= block_bound(n)


def test_frame_bound_covers_compress():
    from divortio_lz4 import FrameConfig, compress_frame
    rng = np.random.default_rng(6)
    for n in (0, 100, 70_000, 200_000):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        cfg = FrameConfig(block_size=65536, content_checksum=True)
        frame = compress_frame(data, config=cfg)
        assert len(frame) <= frame_bound(n, 65536)


def test_ensure_buffer_coercions():
    np.testing.assert_array_equal(ensure_buffer(b"ab"), [97, 98])
    np.testing.assert_array_equal(ensure_buffer("ab"), [97, 98])
    np.testing.assert_array_equal(ensure_buffer(bytearray(b"ab")), [97, 98])
    np.testing.assert_array_equal(ensure_buffer(memoryview(b"ab")), [97, 98])
    np.testing.assert_array_equal(ensure_buffer([97, 98]), [97, 98])
    arr32 = np.array([0x64636261], dtype=np.uint32)
    np.testing.assert_array_equal(ensure_buffer(arr32), [97, 98, 99, 100])
    out = ensure_buffer({"k": 1})
    assert bytes(out) == b'{"k": 1}'
    with pytest.raises(TypeError, match="LZ4"):
        ensure_buffer(object())


def test_ensure_buffer_jax_array():
    import jax.numpy as jnp
    x = jnp.asarray(np.array([1, 2, 3], np.uint8))
    np.testing.assert_array_equal(ensure_buffer(x), [1, 2, 3])
