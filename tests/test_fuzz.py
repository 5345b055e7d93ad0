"""Deterministic robustness fuzz: hostile inputs must raise typed errors or
return data — never crash, hang, or read out of bounds.

The reference's JS memory model silently drops OOB writes (SURVEY §5.2);
the native C++ tier has no such safety net, so this suite is the bounds
discipline proof for both host backends.
"""

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame
from divortio_lz4.stream import LZ4Decoder

# The complete rejection taxonomy (SURVEY §5.3): every fuzz-raised error
# must carry one of these messages — proving typed rejection, not an
# accidental crash that happens to be a ValueError.
_TAXONOMY = (
    "LZ4: Invalid Magic Number",
    "LZ4: Unsupported Version",
    "LZ4: Malformed Input",
    "LZ4: Output Buffer Too Small",
    "LZ4: Invalid Offset 0",
    "LZ4: Dictionary Offset Out of Bounds",
    "LZ4: Block Checksum Error",
    "LZ4: Content Checksum Error",
    "LZ4: Header Checksum Error",
    "LZ4: Dictionary ID Mismatch",
    "LZ4: Frame requires a Dictionary",
)


def _assert_taxonomy(exc: BaseException) -> None:
    if isinstance(exc, IndexError):
        return  # numpy bounds rejection on the python oracle tier
    msg = str(exc)
    assert any(msg.startswith(t) for t in _TAXONOMY), \
        f"untyped fuzz error: {msg!r}"


def _try_decode(frame_bytes, backend):
    try:
        decompress_frame(np.frombuffer(frame_bytes, np.uint8),
                         backend=backend)
    except (ValueError, IndexError) as e:
        _assert_taxonomy(e)  # typed rejection only; crashes/hangs are not


@pytest.mark.parametrize("backend", ["python", "native"])
def test_truncation_fuzz(backend, compressible):
    frame = bytes(compress_frame(
        compressible(5000),
        config=FrameConfig(block_size=65536, content_checksum=True)))
    for cut in range(0, len(frame), 7):
        _try_decode(frame[:cut], backend)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_mutation_fuzz(backend, compressible, rng):
    base = bytes(compress_frame(
        compressible(3000), config=FrameConfig(block_size=65536)))
    for _ in range(150):
        buf = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(buf)))
            buf[pos] = int(rng.integers(0, 256))
        _try_decode(bytes(buf), backend)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_garbage_fuzz(backend, rng):
    magic = bytes([0x04, 0x22, 0x4D, 0x18])
    for n in (0, 1, 4, 7, 32, 300):
        _try_decode(bytes(rng.integers(0, 256, n, dtype=np.uint8)), backend)
        _try_decode(magic + bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                    backend)


def test_streaming_fsm_mutation_fuzz(compressible, rng):
    base = bytes(compress_frame(
        compressible(3000), config=FrameConfig(block_size=65536)))
    for _ in range(60):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        dec = LZ4Decoder()
        try:
            for i in range(0, len(buf), 97):
                dec.update(bytes(buf[i: i + 97]))
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


# --- Device-tier fuzz (VERDICT r1 #10): hostile blocks through the XLA and
# Pallas decode kernels must produce CLIPPED-BUT-BOUNDED output — indices
# clamp, out_len stays within [0, out_cap], nothing crashes or hangs.

def test_xla_decode_kernel_hostile_blocks(rng):
    import jax.numpy as jnp

    from divortio_lz4.constants import WINDOW_SIZE
    from divortio_lz4.ops.decode_xla import decode_block

    CAP = 2048
    hist = jnp.zeros(WINDOW_SIZE, jnp.int32)
    for trial in range(40):
        m = int(rng.integers(1, 192))
        comp = np.zeros(256, np.int32)
        comp[:m] = rng.integers(0, 256, m)
        out, out_len = decode_block(jnp.asarray(comp), jnp.int32(m), hist,
                                    CAP)
        ol = int(out_len)
        assert 0 <= ol <= CAP
        body = np.asarray(out)
        assert ((body >= 0) & (body <= 255)).all()


def test_pallas_decode_kernel_hostile_blocks(rng):
    """Random garbage blocks through the split route: the host parser
    rejects them with the taxonomy, and whatever parses decodes within
    the block capacity."""
    from divortio_lz4.ops.gpu_decode import decode_blocks

    CAP = 2048
    for _ in range(8):
        m = int(rng.integers(1, 192))
        comp = rng.integers(0, 256, m).astype(np.uint8)
        try:
            out = decode_blocks([comp], CAP)[0]
        except ValueError as e:
            _assert_taxonomy(e)
            continue
        assert 0 <= len(out) <= CAP


def test_device_frame_decode_mutation_fuzz(compressible, rng):
    """Mutated frames through the DEVICE frame path: typed rejection or
    data, never a crash (parse_block_index bounds + clamped kernels)."""
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True)))
    for _ in range(25):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            device_decompress_frame(np.frombuffer(bytes(buf), np.uint8))
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_device_frame_decode_truncation_fuzz(compressible):
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True,
                           content_checksum=True)))
    for cut in range(0, len(base), 13):
        try:
            device_decompress_frame(np.frombuffer(base[:cut], np.uint8))
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_pallas_frame_decode_mutation_fuzz(compressible, rng):
    """Mutated INDEPENDENT frames through engine='pallas' (the split
    route): typed rejection or bounded data, never a crash or
    out-of-region write."""
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True)))
    for _ in range(15):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            out = device_decompress_frame(np.frombuffer(bytes(buf), np.uint8),
                                          engine="pallas")
            assert len(out) <= 65536  # one block's capacity
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_pallas_linked_frame_decode_mutation_fuzz(compressible, rng):
    """Mutated LINKED frames through the split route (one region): output
    stays bounded by the declared chain."""
    from divortio_lz4.parallel import device_decompress_frame

    data = np.asarray(compressible(150000))
    base = bytes(compress_frame(
        data, config=FrameConfig(block_size=65536,
                                 block_independence=False)))
    nblocks = -(-len(data) // 65536)
    for _ in range(10):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            out = device_decompress_frame(np.frombuffer(bytes(buf), np.uint8),
                                          engine="pallas")
            assert len(out) <= nblocks * 65536
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_pallas_frame_decode_truncation_fuzz(compressible):
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True,
                           content_checksum=True)))
    for cut in range(0, len(base), 29):
        try:
            device_decompress_frame(np.frombuffer(base[:cut], np.uint8),
                                    engine="pallas")
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_split_frame_decode_mutation_fuzz(compressible, rng):
    """Mutated INDEPENDENT frames through engine='split' (host record
    parse + region kernel): the parser raises the host taxonomy
    on malformed streams; surviving mutations decode to bounded data."""
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True)))
    for _ in range(15):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            out = device_decompress_frame(np.frombuffer(bytes(buf), np.uint8),
                                          engine="split")
            assert len(out) <= 65536
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_split_linked_frame_decode_mutation_fuzz(compressible, rng):
    """Mutated LINKED frames through the chain-split decoder (piece scan +
    per-piece host parse + chained chunks)."""
    from divortio_lz4.parallel import device_decompress_frame

    data = np.asarray(compressible(150000))
    base = bytes(compress_frame(
        data, config=FrameConfig(block_size=65536,
                                 block_independence=False)))
    nblocks = -(-len(data) // 65536)
    for _ in range(10):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            out = device_decompress_frame(np.frombuffer(bytes(buf), np.uint8),
                                          engine="split")
            assert len(out) <= nblocks * 65536
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_split_frame_decode_truncation_fuzz(compressible):
    from divortio_lz4.parallel import device_decompress_frame

    base = bytes(compress_frame(
        compressible(3000),
        config=FrameConfig(block_size=65536, block_independence=True,
                           content_checksum=True)))
    for cut in range(0, len(base), 29):
        try:
            device_decompress_frame(np.frombuffer(base[:cut], np.uint8),
                                    engine="split")
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)


def test_device_streaming_decoder_mutation_fuzz(compressible, rng):
    """Mutated frames through LZ4Decoder(backend='device') — the batch
    scanner + split kernel must reject or bound, never crash."""
    from divortio_lz4.stream import LZ4Decoder

    data = np.asarray(compressible(400000))
    base = bytes(compress_frame(
        data, config=FrameConfig(block_size=65536, block_independence=True,
                                 content_checksum=True)))
    for _ in range(8):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        dec = LZ4Decoder(backend="device")
        try:
            got = b"".join(bytes(c) for c in dec.update(bytes(buf)))
            assert len(got) <= len(data) + 65536
        except (ValueError, IndexError) as e:
            _assert_taxonomy(e)
