"""LZ4 Frame/Block format constants.

Single source of truth for every layer of the framework (the
reference scatters these across modules; see /root/reference/src/buffer/
bufferCompress.js:17-48 and src/block/blockCompress.js:13-17).
"""

# --- Frame magic / version ---------------------------------------------------
# LZ4 Frame magic number, little-endian on the wire (bufferCompress.js:147).
MAGIC_NUMBER = 0x184D2204
LZ4_VERSION = 1

# Skippable frames (spec §"Skippable Frames"): magic 0x184D2A50..5F followed
# by a 4-byte LE size of user data to skip. The reference does not handle
# these (its decoders reject them as invalid magic); this framework skips
# them for interop with lz4 CLI archives.
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F

# --- FLG byte bit masks (bufferCompress.js:27-37, bufferDecompress.js:28-32) --
FLG_VERSION_MASK = 0xC0
FLG_BLOCK_INDEPENDENCE = 0x20
FLG_BLOCK_CHECKSUM = 0x10
FLG_CONTENT_SIZE = 0x08
FLG_CONTENT_CHECKSUM = 0x04
FLG_DICT_ID = 0x01

# --- BD byte: block max sizes (bufferCompress.js:43-48) ----------------------
BLOCK_MAX_SIZES = {
    4: 65536,      # 64 KB
    5: 262144,     # 256 KB
    6: 1048576,    # 1 MB
    7: 4194304,    # 4 MB
}
DEFAULT_BLOCK_SIZE = BLOCK_MAX_SIZES[7]

# High bit of a block-size word marks a stored (uncompressed) block
# (bufferCompress.js:228, bufferDecompress.js:142-143).
UNCOMPRESSED_FLAG = 0x80000000
BLOCK_SIZE_MASK = 0x7FFFFFFF

# --- Block compression kernel constants (blockCompress.js:13-17) -------------
MIN_MATCH = 4
LAST_LITERALS = 5       # final bytes of a block must be literals
MF_LIMIT = 12           # match search stops MF_LIMIT bytes before block end
HASH_LOG = 14
HASH_TABLE_SIZE = 1 << HASH_LOG     # 16384 entries
HASH_SHIFT = 18
HASH_MASK = HASH_TABLE_SIZE - 1
# Knuth multiplicative hash constant. The ONE hash used everywhere in this
# framework (the reference uses a mismatched Jenkins hash in its dictionary
# warm-ups, bufferCompress.js:194-201 — a bug this build does not inherit).
HASH_MULTIPLIER = 2654435761

# Acceleration: the skip stride grows by one every 1<<SKIP_TRIGGER misses
# (blockCompress.js:40,66-67).
SKIP_TRIGGER = 6

# LZ4 match window: back-references reach at most 65535 bytes.
WINDOW_SIZE = 65536

# --- Sizing helpers ----------------------------------------------------------


def block_bound(n: int) -> int:
    """Worst-case compressed size of one n-byte block.

    Token-per-run overhead: 1 token + ceil((n-15)/255) length bytes, plus
    slack. This is the *correct* bound (the reference's streaming encoder
    under-sizes its staging buffer, lz4Encode.js:232 — not inherited here).
    """
    return n + (n // 255) + 16


def frame_bound(n: int, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Worst-case whole-frame size for an n-byte payload."""
    nblocks = max(1, -(-n // block_size))
    # max header: magic(4)+FLG(1)+BD(1)+size(8)+dictId(4)+HC(1) = 19
    return 19 + nblocks * 4 + n + (n // 255) + 16 * nblocks + 4 + 4


def get_block_id(nbytes: int) -> int:
    """Quantize a requested max block size to an LZ4 BD id (4..7).

    Mirrors bufferCompress.js:77-82.
    """
    if not nbytes or nbytes <= 65536:
        return 4
    if nbytes <= 262144:
        return 5
    if nbytes <= 1048576:
        return 6
    return 7
