"""Golden spec vectors — byte-level interop with the LZ4 frame format.

Hex frames and expected header bytes from
/root/reference/tests/golden.test.mjs:17-89. These are the normative
bit-exactness anchors for every decode path in this framework.
"""

import numpy as np
import pytest

from divortio_lz4 import FrameConfig, compress_frame, decompress_frame

GOLDEN_HELLO = "04224D186040820B00008048656c6c6f20576f726c6400000000"
GOLDEN_EMPTY_4MB = "04224D1860707300000000"
GOLDEN_HELLO_CK = "04224D186440A70B00008048656c6c6f20576f726c6400000000EE16FDB1"


def from_hex(s: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(s), dtype=np.uint8)


def test_decode_minimal_hello_world_frame():
    out = decompress_frame(from_hex(GOLDEN_HELLO))
    assert bytes(out) == b"Hello World"


def test_decode_empty_frame_4mb_blocks():
    out = decompress_frame(from_hex(GOLDEN_EMPTY_4MB))
    assert len(out) == 0


def test_decode_frame_with_content_checksum():
    out = decompress_frame(from_hex(GOLDEN_HELLO_CK))
    assert bytes(out) == b"Hello World"


def test_decode_frame_with_corrupted_content_checksum():
    bad = bytearray(bytes.fromhex(GOLDEN_HELLO_CK))
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="Content Checksum"):
        decompress_frame(np.frombuffer(bytes(bad), dtype=np.uint8))
    # skip-verify recovers (bufferDecompress.test.mjs:44-56 pattern)
    out = decompress_frame(np.frombuffer(bytes(bad), dtype=np.uint8),
                           verify_checksum=False)
    assert bytes(out) == b"Hello World"


def test_header_generation_standard():
    # golden.test.mjs:62-72 — FLG 0x60, BD 0x40, HC 0x82 for
    # (64KB blocks, independent, no checksum, no content size).
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=False, content_size=False)
    frame = compress_frame(b"Hello World", config=cfg)
    assert frame[4] == 0x60
    assert frame[5] == 0x40
    assert frame[6] == 0x82


def test_header_generation_with_content_checksum():
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True, content_size=False)
    frame = compress_frame(b"Hello World", config=cfg)
    assert frame[4] == 0x64
    assert frame[5] == 0x40
    assert frame[6] == 0xA7


def test_hello_world_roundtrip_is_bit_exact_golden():
    # An 11-byte input cannot compress; the encoder must emit the stored
    # block exactly as the golden frame does.
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=False, content_size=False)
    frame = compress_frame(b"Hello World", config=cfg)
    assert bytes(frame) == bytes.fromhex(GOLDEN_HELLO)


def test_hello_world_checksum_frame_is_bit_exact_golden():
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True, content_size=False)
    frame = compress_frame(b"Hello World", config=cfg)
    assert bytes(frame) == bytes.fromhex(GOLDEN_HELLO_CK)


def test_invalid_magic():
    with pytest.raises(ValueError, match="Magic"):
        decompress_frame(np.frombuffer(b"\x00\x00\x00\x00rest", dtype=np.uint8))


def test_unsupported_version():
    frame = bytearray(bytes.fromhex(GOLDEN_HELLO))
    frame[4] = (frame[4] & 0x3F) | (2 << 6)  # version 2
    with pytest.raises(ValueError, match="Version"):
        decompress_frame(np.frombuffer(bytes(frame), dtype=np.uint8))


# ---------------------------------------------------------------------------
# Hand-built spec vectors (round 3): every FLG feature with FIXED bytes.
#
# These frames were constructed byte-by-byte from the LZ4 Frame/Block spec
# (wire layout per /root/reference/src/buffer/bufferCompress.js:144-178 and
# blockDecompress.js:55-272), NOT round-tripped through this framework's
# encoder. The only computed constants are xxHash32 values, which are
# themselves anchored by the spec vectors in test_xxhash32.py (empty ->
# 0x02CC5D05, "Hello World" -> 0xB1FD16EE). The 0xFF-run extension bytes
# ("FF"*k) are spec run-length encoding, written out programmatically for
# readability only.
# ---------------------------------------------------------------------------

def _a_block_hex() -> str:
    """64 KB of 'A' as one hand-written sequence stream:
    token 0x1F (lit 1, mlen 15+ext), literal 'A', offset 0001,
    match-ext run for mlen 65530 (65511 = 255*256 + 231 -> 256xFF + E7),
    final literal-only sequence token 0x50 + 'AAAAA'."""
    return "1F410100" + "FF" * 256 + "E750" + "41" * 5


# FLG 0x60 (v01 + independent), BD 0x40 (64 KB), HC 0x82; two identical
# compressed blocks of 0x10B bytes each; EndMark.
GOLDEN_MULTIBLOCK = ("04224D18604082"
                     + ("0B010000" + _a_block_hex()) * 2
                     + "00000000")

# FLG 0x40 (v01, LINKED), BD 0x40, HC 0xC0. Block 1 = 64 KB of a 16-byte
# pattern; block 2's FIRST sequence is lit 0 + offset 16 — a match that
# reaches across the block boundary into block 1's tail (the linked-mode
# wire contract, lz4Decode.js:279-306 window semantics).
_PAT = "4142434445464748494A4B4C4D4E4F50"  # "ABCDEFGHIJKLMNOP"
GOLDEN_LINKED_XBLOCK = (
    "04224D184040C0"
    + "1B010000" + "FF01" + _PAT + "1000" + "FF" * 256 + "D850"
    + "4C4D4E4F50"                                  # block 1 (0x11B bytes)
    + "8A000000" + "0F1000" + "FF" * 128 + "6850" + "4C4D4E4F50"
    + "00000000")
GOLDEN_LINKED_PLAINTEXT = (b"ABCDEFGHIJKLMNOP" * 4096
                           + b"ABCDEFGHIJKLMNOP" * 2048)

# FLG 0x41 (linked + dictID), dictID = xxh32("0123456789abcdef"*4) =
# 0xE717E5FB (LE FBE517E7), HC 0x08. One block whose first sequence is
# lit 0 + offset 64: a pure dictionary back-reference (indexed from the
# dict's END, blockDecompress.js:145-154).
GOLDEN_DICT = "04224D184140FBE517E7080A0000000F40006850626364656600000000"
GOLDEN_DICT_DICTIONARY = b"0123456789abcdef" * 4
GOLDEN_DICT_PLAINTEXT = GOLDEN_DICT_DICTIONARY * 2

# FLG 0x70 (independent + BLOCK CHECKSUMS), HC 0xAD; stored block
# "Hello World" followed by its xxh32 0xB1FD16EE (LE EE16FDB1) — the same
# spec constant test_xxhash32.py anchors. The reference parses this flag
# but never verifies (bufferDecompress.js:190-191); this framework does.
GOLDEN_BLOCK_CK = ("04224D187040AD0B00008048656C6C6F20576F726C64EE16FDB1"
                   "00000000")

# FLG 0x60; one compressed 64 KB block + one STORED short final block
# (high-bit size, bufferCompress.js:221-231).
GOLDEN_MIXED_STORED = ("04224D18604082"
                       + "0B010000" + _a_block_hex()
                       + "1B000080"
                       + b"incompressible tail bytes!!".hex().upper()
                       + "00000000")

# FLG 0x68 (independent + CONTENT SIZE 11), HC 0x58 — drives the decoder's
# direct-write strategy (bufferDecompress.js:96-107).
GOLDEN_CONTENT_SIZE = ("04224D1868400B00000000000000580B00008048656C6C6F2057"
                       "6F726C6400000000")


def _stream_decode(frame: bytes, dictionary=None) -> bytes:
    from divortio_lz4.stream import LZ4Decoder
    dec = LZ4Decoder(dictionary=dictionary)
    got = b""
    for i in range(0, len(frame), 997):
        got += b"".join(bytes(c) for c in dec.update(frame[i: i + 997]))
    return got


def test_golden_multiblock_independent():
    plain = b"A" * 131072
    assert bytes(decompress_frame(from_hex(GOLDEN_MULTIBLOCK))) == plain
    assert _stream_decode(bytes.fromhex(GOLDEN_MULTIBLOCK)) == plain


def test_golden_linked_cross_block_match():
    frame = from_hex(GOLDEN_LINKED_XBLOCK)
    assert bytes(decompress_frame(frame)) == GOLDEN_LINKED_PLAINTEXT
    assert _stream_decode(bytes(frame.tobytes())) == GOLDEN_LINKED_PLAINTEXT


def test_golden_dictionary_frame():
    frame = from_hex(GOLDEN_DICT)
    out = decompress_frame(frame, dictionary=GOLDEN_DICT_DICTIONARY)
    assert bytes(out) == GOLDEN_DICT_PLAINTEXT
    # dictID is VERIFIED: wrong dictionary must be rejected
    with pytest.raises(ValueError, match="Dictionary"):
        decompress_frame(frame, dictionary=b"wrong dictionary bytes")
    assert _stream_decode(frame.tobytes(),
                          dictionary=GOLDEN_DICT_DICTIONARY) \
        == GOLDEN_DICT_PLAINTEXT


def test_golden_block_checksum_frame():
    assert bytes(decompress_frame(from_hex(GOLDEN_BLOCK_CK))) \
        == b"Hello World"
    # flip one stored byte: the block checksum must catch it
    bad = bytearray(bytes.fromhex(GOLDEN_BLOCK_CK))
    bad[12] ^= 0x01
    with pytest.raises(ValueError, match="Block Checksum"):
        decompress_frame(np.frombuffer(bytes(bad), np.uint8))


def test_golden_mixed_stored_block():
    plain = b"A" * 65536 + b"incompressible tail bytes!!"
    assert bytes(decompress_frame(from_hex(GOLDEN_MIXED_STORED))) == plain
    assert _stream_decode(bytes.fromhex(GOLDEN_MIXED_STORED)) == plain


def test_golden_content_size_direct_write():
    assert bytes(decompress_frame(from_hex(GOLDEN_CONTENT_SIZE))) \
        == b"Hello World"


def test_golden_frames_on_device_path():
    # The device frame decoder must agree with the host tier on the same
    # fixed bytes (runs in interpret mode on the CPU mesh under pytest).
    from divortio_lz4.parallel.device import device_decompress_frame
    got = device_decompress_frame(from_hex(GOLDEN_MULTIBLOCK))
    assert bytes(np.asarray(got).tobytes()) == b"A" * 131072
    got = device_decompress_frame(from_hex(GOLDEN_LINKED_XBLOCK))
    assert bytes(np.asarray(got).tobytes()) == GOLDEN_LINKED_PLAINTEXT
    got = device_decompress_frame(from_hex(GOLDEN_DICT),
                                  dictionary=GOLDEN_DICT_DICTIONARY)
    assert bytes(np.asarray(got).tobytes()) == GOLDEN_DICT_PLAINTEXT


def test_skippable_frame_is_skipped():
    # Spec skippable frame (magic 0x184D2A50 + size) prepended to a real
    # frame — the reference rejects these; this framework skips them.
    skip = bytes([0x50, 0x2A, 0x4D, 0x18, 0x05, 0, 0, 0]) + b"USER!"
    frame = skip + bytes.fromhex(GOLDEN_HELLO)
    out = decompress_frame(np.frombuffer(frame, np.uint8))
    assert bytes(out) == b"Hello World"
    # streaming FSM path, fed in small fragments
    from divortio_lz4.stream import LZ4Decoder
    dec = LZ4Decoder()
    got = b""
    for i in range(0, len(frame), 3):
        got += b"".join(bytes(c) for c in dec.update(frame[i: i + 3]))
    assert got == b"Hello World"
