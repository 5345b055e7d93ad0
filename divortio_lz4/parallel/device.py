"""Single-device frame codec: batched block kernels + host frame assembly.

The frame wire format (headers, sizes, stored-block fallback, checksums) is
cheap host work; the block codec is the compute. Blocks are padded into a
(nblocks, block_size) batch, encoded/decoded on device in one jit call, and
stitched into a spec-exact LZ4 frame on host.

Independent blocks (FrameConfig.block_independence=True) are the natural
device layout — every block is data-parallel. Linked frames are decoded by
carrying the 64 KB tail window between batched calls (still device compute,
serial across blocks), and encoded with a device loop over blocks.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, FrameConfig
from ..constants import (
    BLOCK_SIZE_MASK,
    FLG_BLOCK_CHECKSUM,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICT_ID,
    FLG_VERSION_MASK,
    LZ4_VERSION,
    MAGIC_NUMBER,
    UNCOMPRESSED_FLAG,
    WINDOW_SIZE,
    block_bound,
)
from ..utils import ensure_buffer, read_u32le, write_u32le
from ..xxh import xxhash32
from ..ops.decode_xla import decode_blocks_batch
from ..ops.encode_xla import encode_blocks_batch
from ..ops.gpu_decode import decode_frame_body, plan_regions


def _blocks_to_batch(raw: np.ndarray, block_size: int):
    n = len(raw)
    nblocks = max(1, -(-n // block_size))
    # uint8 rows: device transfers ship 1 byte/byte; kernels widen to i32
    # lanes on device.
    work = np.zeros((nblocks, block_size), dtype=np.uint8)
    lens = np.zeros(nblocks, dtype=np.int32)
    for i in range(nblocks):
        chunk = raw[i * block_size: (i + 1) * block_size]
        work[i, : len(chunk)] = chunk
        lens[i] = len(chunk)
    return work, lens, nblocks


def _frame_header_bytes(config: FrameConfig, n: int,
                        dict_id: Optional[int] = None) -> np.ndarray:
    """Build the frame header (magic..header checksum) for the device path."""
    hdr = np.empty(19, np.uint8)
    hdr[0:4] = (0x04, 0x22, 0x4D, 0x18)
    flg = LZ4_VERSION << 6
    if config.block_independence:
        flg |= 0x20
    if config.content_checksum:
        flg |= FLG_CONTENT_CHECKSUM
    if config.block_checksums:
        flg |= FLG_BLOCK_CHECKSUM
    if config.content_size:
        flg |= FLG_CONTENT_SIZE
    if dict_id is not None:
        flg |= FLG_DICT_ID
    hdr[4] = flg
    hdr[5] = (config.block_id & 0x07) << 4
    pos = 6
    if config.content_size:
        write_u32le(hdr, pos, n & 0xFFFFFFFF)
        write_u32le(hdr, pos + 4, n >> 32)
        pos += 8
    if dict_id is not None:
        write_u32le(hdr, pos, dict_id)
        pos += 4
    hdr[pos] = (xxhash32(hdr[4:pos], 0) >> 8) & 0xFF
    return hdr[: pos + 1]


def _dict_window(dictionary) -> tuple[Optional[np.ndarray], Optional[int]]:
    """Last-64KB window + dictID of a dictionary (None, None when absent)."""
    if dictionary is None:
        return None, None
    dict_buf = ensure_buffer(dictionary)
    if len(dict_buf) == 0:
        return None, None
    dict_id = xxhash32(dict_buf, 0)
    window = dict_buf[-WINDOW_SIZE:]
    return np.asarray(window, np.uint8), dict_id


ENCODE_ENGINES = ("xla", "split")
DECODE_ENGINES = ("xla", "split", "pallas")


def device_compress_frame(data,
                          config: FrameConfig = DEFAULT_CONFIG,
                          use_fingerprints: Optional[bool] = None,
                          encode_batch=None,
                          dictionary=None,
                          engine: str = "xla",
                          assemble: str = "host") -> np.ndarray:
    """Compress *data* into an LZ4 frame with the block codec on device.

    Independent frames batch data-parallel (BASELINE configs 1/2/5); linked
    frames run as a single jitted lax.scan carrying the 64 KB window on
    device (BASELINE config 3). *encode_batch* optionally overrides the
    batch kernel — signature (work, lens, hist_len, hist_start) where work
    rows carry a static hist_len-byte history prefix (the sharded codec
    passes its shard_map-wrapped version). *dictionary* feeds every block's
    history window and stamps the frame's dictID
    (bufferCompress.js:109-125 semantics on the device tier).

    engine: "xla" (sort-based data-parallel kernel) or "split" (device
    candidate chains + native host select/serialize, ops/split_encode —
    independent and linked frames, dictionaries; blocks above 64 KB are
    encoded as 64 KB segments spliced on the host, parallel/bigblock).
    Output is decode-compatible LZ4 at a ratio <= the reference encoder's
    on the measured corpora.
    """
    if engine not in ENCODE_ENGINES:
        raise ValueError(f"unknown encode engine {engine!r}; supported: "
                         f"{', '.join(ENCODE_ENGINES)}")
    if use_fingerprints is None:
        use_fingerprints = config.favor_ratio
    if engine == "split" and encode_batch is None:
        from ..ops.hybrid_encode import hybrid_max_bs
        if config.resolved_block_size > hybrid_max_bs():
            from .bigblock import compress_frame_big
            return compress_frame_big(data, config, dictionary)
        if config.block_independence:
            return _compress_independent_split(data, config, dictionary)
        return _compress_linked_split(data, config, dictionary)
    if not config.block_independence:
        return _compress_linked(data, config, use_fingerprints, dictionary,
                                encode_batch, assemble)

    raw = ensure_buffer(data)
    n = len(raw)
    bs = config.resolved_block_size
    work, lens, nblocks = _blocks_to_batch(raw, bs)

    window, dict_id = _dict_window(dictionary)
    if window is not None:
        # Every independent block sees the dictionary as history: rows are
        # [64 KB window (right-aligned) | payload], hist_len = WINDOW_SIZE.
        hist_len = WINDOW_SIZE
        hist_start = WINDOW_SIZE - len(window)
        hist_block = np.zeros((nblocks, WINDOW_SIZE), np.uint8)
        hist_block[:, hist_start:] = window
        work = np.concatenate([hist_block, work], axis=1)
    else:
        hist_len = 0
        hist_start = 0

    if encode_batch is None:
        def encode_batch(w, l, hl, hs):
            hs_rows = jnp.broadcast_to(
                jnp.asarray(hs, jnp.int32), (w.shape[0],))
            return encode_blocks_batch(w, l, hl, use_fingerprints, hs_rows)

    if not config.block_checksums and n > 0 and assemble == "device":
        # Device assembly: stitch size words + payloads (incl. stored
        # fallback and EndMark) on device. Keeps the frame device-resident
        # for downstream device consumers; a host-bound result takes the
        # default host assembly below.
        from ..ops.assemble_xla import assemble_blocks
        d_work = jnp.asarray(work)
        outs, out_lens = encode_batch(d_work, jnp.asarray(lens), hist_len,
                                      hist_start)
        d_payload = d_work[:, hist_len:] if hist_len else d_work
        cap = nblocks * (4 + bs) + 4
        body, body_total = assemble_blocks(
            jnp.asarray(outs), jnp.asarray(out_lens), d_payload,
            jnp.asarray(lens), cap)
        body_np = np.asarray(body[: int(body_total)].astype(jnp.uint8))
        header = _frame_header_bytes(config, n, dict_id)
        parts = [header, body_np]
        if config.content_checksum:
            ck = np.empty(4, np.uint8)
            write_u32le(ck, 0, xxhash32(raw, 0))
            parts.append(ck)
        return np.concatenate(parts)

    outs, out_lens = _chunked_encode(work, lens, encode_batch, hist_len,
                                     hist_start)
    return _host_assemble(raw, outs, out_lens, lens, nblocks, bs, config,
                          dict_id)


def _compress_independent_split(data, config: FrameConfig,
                                dictionary=None, defer: bool = False,
                                chains=None, chunk_rows: int = 0):
    """Independent-frame encode via the chain-direct path
    (ops/split_encode): the device builds exhaustive candidate chains (the
    expensive search); the native host greedy-selects, exactly extends, and
    serializes at memcpy-class speed. Stored fallback and frame assembly as
    the host tier. *chains* (work, lens, bs, hist_len, hist_start) ->
    device chains overrides the single-device chain builder (the sharded
    codec passes its mesh version), over *chunk_rows*-row dispatches."""
    from ..ops.split_encode import encode_blocks_chain
    chains = chains or encode_blocks_chain

    raw = ensure_buffer(data)
    n = len(raw)
    bs = config.resolved_block_size
    work, lens, nblocks = _blocks_to_batch(raw, bs)
    window, dict_id = _dict_window(dictionary)
    if window is not None:
        hist_len = WINDOW_SIZE
        hist_start = WINDOW_SIZE - len(window)
        hist_block = np.zeros((nblocks, WINDOW_SIZE), np.uint8)
        hist_block[:, hist_start:] = window
        work = np.concatenate([hist_block, work], axis=1)
    else:
        hist_len = 0
        hist_start = 0

    CH = chunk_rows or _FRAME_CHUNK_ROWS
    pend = []
    for i in range(0, nblocks, CH):
        rows = min(CH, nblocks - i)
        target = CH if nblocks > CH else _chunk_rows_bucket(rows)
        w = work[i: i + rows]
        l = lens[i: i + rows]
        if rows < target:
            w = np.concatenate(
                [w, np.zeros((target - rows,) + w.shape[1:], w.dtype)])
            l = np.concatenate([l, np.zeros(target - rows, np.int32)])
        pend.append((i, rows, chains(w, l, bs, hist_len, hist_start)))
    state = (raw, work, lens, nblocks, bs, hist_len, pend, config, dict_id)
    if defer:
        return state
    return _split_encode_fetch(state)


def _split_encode_fetch(state) -> np.ndarray:
    """Select/serialize/assemble phase of the chain-direct encode.
    Separated so device_compress_frames can queue every frame's chain
    dispatches before the first host serialize (the device computes frame
    k+1's chains while the host serializes frame k)."""
    raw, work, lens, nblocks, bs, hist_len, pend, config, dict_id = state
    from ..ops.split_encode import chain_select_serialize

    comps = [None] * nblocks

    if hist_len == 0:
        # ONE padded copy of the frame instead of a zeros+memcpy per
        # block (8 MB of pure memory traffic per 4 MB batch): row b's
        # work view is raw_pad[b*bs : b*bs+src_len+8]. The 8 slack bytes
        # may be the NEXT block's bytes — harmless: the extension loop
        # clamps at match_limit and only needs them readable.
        raw_pad = np.empty(nblocks * bs + 8, np.uint8)
        raw_np = np.asarray(raw, np.uint8)
        raw_pad[: len(raw_np)] = raw_np
        raw_pad[len(raw_np):] = 0

        def _serialize_one(b, chains_np, k):
            src_len = int(lens[b])
            comps[b] = chain_select_serialize(
                raw_pad[b * bs: b * bs + src_len + 8], 0, src_len,
                chains_np[k])
    else:
        def _serialize_one(b, chains_np, k):
            src_len = int(lens[b])
            wk = np.zeros(hist_len + src_len + 8, np.uint8)
            wk[:hist_len] = work[b, :hist_len]
            wk[hist_len: hist_len + src_len] = raw[b * bs: b * bs + src_len]
            comps[b] = chain_select_serialize(wk, hist_len, src_len,
                                              chains_np[k])

    # The native selector releases the GIL — blocks serialize in parallel
    # on the shared internal pool (a fresh executor costs ~1-2 ms/call).
    from ..utils.pool import host_pool
    ex = host_pool()
    futs = []
    for i, rows, chains in pend:
        chains_np = np.asarray(chains)
        for k in range(rows):
            futs.append(ex.submit(_serialize_one, i + k, chains_np, k))
    for f in futs:
        f.result()

    return _assemble_frame_host(raw, comps, lens, nblocks, bs, config,
                                dict_id)


def _assemble_frame_host(raw, comps, lens, nblocks, bs, config,
                         dict_id) -> np.ndarray:
    """Host frame assembly over per-block wire streams: header, size
    words, stored fallback, optional block checksums, EndMark, content
    checksum."""
    n = len(raw)
    frame = np.empty(19 + n + (n // 255) + 16 * max(nblocks, 1) + 8,
                     np.uint8)
    header = _frame_header_bytes(config, n, dict_id)
    frame[: len(header)] = header
    pos = len(header)
    for b in range(nblocks):
        bsize = int(lens[b])
        comp = comps[b]
        clen = len(comp)
        if 0 < clen < bsize:
            write_u32le(frame, pos, clen)
            pos += 4
            frame[pos: pos + clen] = comp
            pos += clen
            data_start = pos - clen
        else:
            write_u32le(frame, pos, bsize | UNCOMPRESSED_FLAG)
            pos += 4
            frame[pos: pos + bsize] = raw[b * bs: b * bs + bsize]
            pos += bsize
            data_start = pos - bsize
        if config.block_checksums:
            write_u32le(frame, pos, xxhash32(frame[data_start:pos], 0))
            pos += 4
    write_u32le(frame, pos, 0)
    pos += 4
    if config.content_checksum:
        write_u32le(frame, pos, xxhash32(raw, 0))
        pos += 4
    return frame[:pos]


def _compress_linked_split(data, config: FrameConfig,
                           dictionary=None, chains=None,
                           chunk_rows: int = 0) -> np.ndarray:
    """Linked-frame encode via the chain-direct path: per-block
    [history | payload] rows (the linked chain's serialism is an
    encoder-side illusion — block i's window is known plaintext, see
    _compress_linked), device candidate chains, host select/serialize.
    *chains*/*chunk_rows* as in _compress_independent_split."""
    from ..ops.split_encode import chain_select_serialize, encode_blocks_chain
    chains = chains or encode_blocks_chain

    raw = ensure_buffer(data)
    n = len(raw)
    bs = config.resolved_block_size
    work, lens, nblocks = _blocks_to_batch(raw, bs)
    window, dict_id = _dict_window(dictionary)
    dict_len = len(window) if window is not None else 0

    W = WINDOW_SIZE
    hist = np.zeros((nblocks, W), np.uint8)
    for i in range(nblocks):
        avail = min(i * bs, W)
        if avail > 0:
            hist[i, W - avail:] = raw[i * bs - avail: i * bs]
        room = W - avail
        take = min(dict_len, room)
        if take > 0:
            hist[i, room - take: room] = window[dict_len - take:]
    work_h = np.concatenate([hist, work], axis=1)
    valid = np.minimum(np.arange(nblocks, dtype=np.int64) * bs + dict_len, W)
    hist_start = (W - valid).astype(np.int32)

    CH = chunk_rows or _FRAME_CHUNK_ROWS
    pend = []
    for i in range(0, nblocks, CH):
        rows = min(CH, nblocks - i)
        target = CH if nblocks > CH else _chunk_rows_bucket(rows)
        w = work_h[i: i + rows]
        l = lens[i: i + rows]
        hs = hist_start[i: i + rows]
        if rows < target:
            w = np.concatenate(
                [w, np.zeros((target - rows,) + w.shape[1:], w.dtype)])
            l = np.concatenate([l, np.zeros(target - rows, np.int32)])
            hs = np.concatenate([hs, np.full(target - rows, W, np.int32)])
        pend.append((i, rows, chains(w, l, bs, W, hs)))

    comps = [None] * nblocks

    def _serialize_one(b, chains_np, k):
        src_len = int(lens[b])
        wk = np.zeros(W + src_len + 8, np.uint8)
        wk[:W] = hist[b]
        wk[W: W + src_len] = raw[b * bs: b * bs + src_len]
        comps[b] = chain_select_serialize(wk, W, src_len, chains_np[k])

    from ..utils.pool import host_pool
    ex = host_pool()
    futs = []
    for i, rows, dev_chains in pend:
        chains_np = np.asarray(dev_chains)
        for k in range(rows):
            futs.append(ex.submit(_serialize_one, i + k, chains_np, k))
    for f in futs:
        f.result()
    return _assemble_frame_host(raw, comps, lens, nblocks, bs, config,
                                dict_id)


# Device-dispatch granularity for the encode paths: fixed-shape chunks keep
# the compile cache to a handful of shapes across all corpus sizes, and
# queueing chunk k+1's host->device transfer while chunk k computes overlaps
# the transfer with the kernel.
_FRAME_CHUNK_ROWS = 32


def _chunk_rows_bucket(rows: int) -> int:
    return -(-rows // 8) * 8


def _chunked_encode(work: np.ndarray, lens: np.ndarray, encode_batch,
                    hist_len: int, hist_start):
    """Run encode_batch over fixed-shape row chunks, async-queued; returns
    (outs u8[nb, W], out_lens i32[nb]) fetched in order."""
    nb = work.shape[0]
    CH = _FRAME_CHUNK_ROWS
    parts = []
    for i in range(0, nb, CH):
        w = work[i: i + CH]
        l = lens[i: i + CH]
        rows = w.shape[0]
        target = CH if nb > CH else _chunk_rows_bucket(rows)
        if rows < target:
            w = np.concatenate(
                [w, np.zeros((target - rows, w.shape[1]), w.dtype)])
            l = np.concatenate([l, np.zeros(target - rows, np.int32)])
        o, ol = encode_batch(jnp.asarray(w), jnp.asarray(l), hist_len,
                             hist_start)
        parts.append((jnp.asarray(o).astype(jnp.uint8), ol, rows))
    outs = np.concatenate([np.asarray(o)[:r] for o, _, r in parts])
    out_lens = np.concatenate([np.asarray(ol)[:r] for _, ol, r in parts])
    return outs, out_lens


def _host_assemble(raw, outs, out_lens, lens, nblocks, bs,
                   config: FrameConfig, dict_id) -> np.ndarray:
    """Stitch the frame on host from (already fetched, u8) kernel outputs:
    header, per-block size words, stored fallback, EndMark, checksums."""
    n = len(raw)
    frame = np.empty(19 + n + (n // 255) + (16 + 8) * nblocks + 8,
                     dtype=np.uint8)
    header = _frame_header_bytes(config, n, dict_id)
    frame[: len(header)] = header
    pos = len(header)

    if n > 0:
        for i in range(nblocks):
            bsize = int(lens[i])
            comp_len = int(out_lens[i])
            if 0 < comp_len < bsize:
                write_u32le(frame, pos, comp_len)
                pos += 4
                frame[pos: pos + comp_len] = outs[i, :comp_len]
                pos += comp_len
                data_start = pos - comp_len
            else:
                write_u32le(frame, pos, bsize | UNCOMPRESSED_FLAG)
                pos += 4
                frame[pos: pos + bsize] = raw[i * bs: i * bs + bsize]
                pos += bsize
                data_start = pos - bsize
            if config.block_checksums:
                write_u32le(frame, pos, xxhash32(frame[data_start:pos], 0))
                pos += 4

    write_u32le(frame, pos, 0)
    pos += 4
    if config.content_checksum:
        write_u32le(frame, pos, xxhash32(raw, 0))
        pos += 4
    return frame[:pos]


def parse_block_index(buf: np.ndarray, verify_checksum: bool = True):
    """Host scan of a frame's block table.

    Returns (header, blocks, tail_pos) where blocks is a list of
    (data_offset, size, is_stored) and header is a dict of parsed fields.
    The scan touches only the 4-byte size words — O(nblocks), not O(n).

    Every declared block size is bounds-checked against the buffer and the
    EndMark must be present: a truncated or corrupt frame raises
    "LZ4: Malformed Input" here instead of zero-padding rows into the device
    decoders (which would emit clipped wrong output). The header-checksum
    byte is verified unless *verify_checksum* is False.
    """
    n = len(buf)
    if n < 7 or read_u32le(buf, 0) != MAGIC_NUMBER:
        raise ValueError("LZ4: Invalid Magic Number")
    pos = 4
    flg = int(buf[pos]); pos += 1
    if (flg & FLG_VERSION_MASK) >> 6 != LZ4_VERSION:
        raise ValueError("LZ4: Unsupported Version")
    bd = int(buf[pos]); pos += 1
    header = {
        "independent": bool(flg & 0x20),
        "block_checksums": bool(flg & FLG_BLOCK_CHECKSUM),
        "content_size": None,
        "content_checksum": bool(flg & FLG_CONTENT_CHECKSUM),
        "dict_id": None,
        "block_max": {4: 65536, 5: 262144, 6: 1048576, 7: 4194304}.get(
            (bd >> 4) & 0x07, 4194304),
    }
    if flg & FLG_CONTENT_SIZE:
        if pos + 8 > n:
            raise ValueError("LZ4: Malformed Input")
        header["content_size"] = read_u32le(buf, pos) | (
            read_u32le(buf, pos + 4) << 32)
        pos += 8
    if flg & FLG_DICT_ID:
        if pos + 4 > n:
            raise ValueError("LZ4: Malformed Input")
        header["dict_id"] = read_u32le(buf, pos)
        pos += 4
    if pos >= n:
        raise ValueError("LZ4: Malformed Input")
    if verify_checksum:
        expect_hc = (xxhash32(buf[4:pos], 0) >> 8) & 0xFF
        if int(buf[pos]) != expect_hc:
            raise ValueError("LZ4: Header Checksum Error")
    pos += 1  # header checksum

    blocks = []
    saw_end = False
    while pos + 4 <= n:
        word = read_u32le(buf, pos)
        pos += 4
        if word == 0:
            saw_end = True
            break
        size = word & BLOCK_SIZE_MASK
        # Spec: "Block Size shall not exceed Block Maximum Size". Enforcing
        # it here also bounds the device decoders' comp-row allocation
        # against hostile size words.
        if size > header["block_max"]:
            raise ValueError("LZ4: Malformed Input")
        need = size + (4 if header["block_checksums"] else 0)
        if pos + need > n:
            raise ValueError("LZ4: Malformed Input")
        blocks.append((pos, size, bool(word & UNCOMPRESSED_FLAG)))
        pos += need
    if not saw_end:
        raise ValueError("LZ4: Malformed Input")
    return header, blocks, pos


def device_decompress_frame(data, verify_checksum: bool = True,
                            decode_batch=None,
                            engine: str = "xla",
                            dictionary=None,
                            split_sharded=None) -> np.ndarray:
    """Decompress an LZ4 frame with batched device block decode.

    engine: "xla" (two-phase data-parallel kernel, ops/decode_xla; linked
    frames as one jitted scan, ops/linked_xla; malformed input decodes to
    unspecified bytes) or "split" (every block parsed on the host, so
    malformed input raises the host tier's error taxonomy; independent
    blocks up to REGION_KERNEL_MAX_BLOCK then decode with the region
    kernel, ops/gpu_decode, one program per block; larger blocks and
    linked frames with the XLA kernels). "pallas" is the same route as
    "split". *split_sharded* (buf, blocks, header, window) -> plaintext
    runs the region kernel over a device mesh (parallel/sharding.py).

    A frame built with a dictionary (FLG dictID set) REQUIRES *dictionary*
    and verifies its xxh32 id — matching the stream decoder's strictness
    (lz4Decode.js:165-179); the history window feeds the device kernels'
    hist inputs so back-references into the dictionary resolve exactly.
    """
    if engine not in DECODE_ENGINES:
        raise ValueError(f"unknown decode engine {engine!r}; supported: "
                         f"{', '.join(DECODE_ENGINES)}")
    buf = ensure_buffer(data)
    header, blocks, tail = parse_block_index(buf, verify_checksum)
    window = _check_frame(buf, header, blocks, dictionary, verify_checksum)
    bs = header["block_max"]

    if not blocks:
        result = np.empty(0, dtype=np.uint8)
    elif engine != "xla" and region_kernel_fits(header):
        if split_sharded is not None:
            result = split_sharded(buf, blocks, header, window)
        else:
            out, total = decode_frame_body(buf, blocks, bs,
                                           header["independent"], window)
            result = np.asarray(out)[:total]
    else:
        if engine != "xla":
            _validate_blocks(buf, blocks, header, window)
        if header["independent"]:
            result = _decode_independent(buf, blocks, bs, decode_batch,
                                         window)
        else:
            result = _decode_linked(buf, blocks, bs, window)
    _verify_content(buf, header, tail, result, verify_checksum)
    return result


# Largest block the split route decodes with the region kernel (one program
# per block). Measured end to end on an H100 (PERF.md): the kernel wins at
# 64 KB and 256 KB blocks on both corpora and at 1 MB on the mixed one; at
# 4 MB a frame has too few blocks to fill the card and the XLA decode wins,
# as it does for a linked frame (a single region).
REGION_KERNEL_MAX_BLOCK = 1 << 20


def region_kernel_fits(header) -> bool:
    """Whether the split route decodes this frame with the region kernel
    (else: host validation + the XLA decode)."""
    return header["independent"] and \
        header["block_max"] <= REGION_KERNEL_MAX_BLOCK


def _validate_blocks(buf, blocks, header, window):
    """The split route's malformed-input guarantee where it decodes with
    the XLA kernels (which do not diagnose bad input): parse every block
    on the host and raise the host tier's error taxonomy."""
    plan_regions(buf, blocks, header["block_max"], header["independent"],
                 0 if window is None else len(window))


def _check_frame(buf, header, blocks, dictionary, verify_checksum):
    """Dictionary-id and block-checksum checks shared by the frame decoders;
    returns the dictionary's history window (or None)."""
    window, dict_id = _dict_window(dictionary)
    if header["dict_id"] is not None:
        if window is None:
            raise ValueError("LZ4: Frame requires a Dictionary")
        if dict_id != header["dict_id"]:
            raise ValueError("LZ4: Dictionary ID Mismatch")
    if verify_checksum and header["block_checksums"]:
        for off, size, _ in blocks:
            stored = read_u32le(buf, off + size)
            if stored != xxhash32(buf[off: off + size], 0):
                raise ValueError("LZ4: Block Checksum Error")
    return window


def _verify_content(buf, header, tail, out, verify_checksum):
    if header["content_checksum"] and verify_checksum:
        if tail + 4 > len(buf):
            raise ValueError("LZ4: Malformed Input")
        if read_u32le(buf, tail) != xxhash32(out, 0):
            raise ValueError("LZ4: Content Checksum Error")


def _bucket_pow2(n: int, floor: int = 4096) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _decode_independent(buf, blocks, bs, decode_batch=None,
                        window=None) -> np.ndarray:
    nb = len(blocks)
    # Phase A of the decode kernel scales with the padded compressed width;
    # bucket it to the batch's actual maximum instead of the worst-case
    # bound (typically 3-4x smaller on compressible data).
    max_comp = max((size for _, size, stored in blocks if not stored),
                   default=1)
    m_cap = min(_bucket_pow2(max_comp), block_bound(bs))
    comp = np.zeros((nb, m_cap), dtype=np.uint8)
    lens = np.zeros(nb, dtype=np.int32)
    stored_rows = {}
    for i, (off, size, stored) in enumerate(blocks):
        if stored:
            stored_rows[i] = buf[off: off + size]
        else:
            comp[i, :size] = buf[off: off + size]
            lens[i] = size
    if window is not None:
        hist = np.zeros((nb, WINDOW_SIZE), dtype=np.uint8)
        hist[:, WINDOW_SIZE - len(window):] = window  # right-aligned
        d_hist = jnp.asarray(hist)
    else:
        # all-zero history: materialized on device, never transferred
        d_hist = jnp.zeros((nb, WINDOW_SIZE), jnp.uint8)
    if decode_batch is None:
        def decode_batch(c, l, h):
            return decode_blocks_batch(c, l, h, bs)
    outs, out_lens = decode_batch(jnp.asarray(comp), jnp.asarray(lens),
                                  d_hist)

    if not stored_rows:
        # Fast path: drop row padding on device, one contiguous result.
        from ..ops.assemble_xla import concat_blocks
        flat, total = concat_blocks(jnp.asarray(outs), jnp.asarray(out_lens),
                                    nb * bs)
        return np.asarray(flat[: int(total)].astype(jnp.uint8))

    outs = np.asarray(jnp.asarray(outs).astype(jnp.uint8))
    out_lens = np.asarray(out_lens)
    parts = []
    for i in range(nb):
        if i in stored_rows:
            parts.append(stored_rows[i])
        else:
            parts.append(outs[i, : int(out_lens[i])])
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


def _rows_bucket(nb: int) -> int:
    b = 4
    while b < nb:
        b <<= 1
    return b


def _compress_linked(data, config: FrameConfig,
                     use_fingerprints: bool, dictionary=None,
                     encode_batch=None,
                     assemble: str = "host") -> np.ndarray:
    """Linked-frame device encode — DATA-PARALLEL, not a serial scan.

    The linked chain's serialism is an encoder-side illusion: block i's 64 KB
    window is the last 64 KB of *plaintext* before it, which is known from
    the input up front. Each block therefore encodes independently with its
    own history slice — the same per-block kernel inputs the round-1 lax.scan
    produced serially (byte-identical frames), but batched/shardable across
    chips (SURVEY §2.6 "tail-window" parallelization; the chain being
    parallelized is lz4Encode.js:262-295). Only DECODE of linked frames is
    truly sequential (each block's output feeds the next window).
    """
    if config.block_checksums:
        # Device assembly does not interleave block checksums; the host
        # frame layer covers that configuration.
        from ..frame import compress_frame
        return compress_frame(data, dictionary, config)

    raw = ensure_buffer(data)
    n = len(raw)
    bs = config.resolved_block_size
    work, lens, nblocks = _blocks_to_batch(raw, bs)

    window, dict_id = _dict_window(dictionary)
    dict_len = len(window) if window is not None else 0

    # Per-row history: row i sees the last 64 KB of plaintext before its
    # block (dictionary tail for row 0, right-aligned).
    W = WINDOW_SIZE
    hist = np.zeros((nblocks, W), np.uint8)
    for i in range(nblocks):
        avail = min(i * bs, W)
        if avail > 0:
            hist[i, W - avail:] = raw[i * bs - avail: i * bs]
        room = W - avail
        take = min(dict_len, room)
        if take > 0:
            hist[i, room - take: room] = window[dict_len - take:]
    work_h = np.concatenate([hist, work], axis=1)
    # First valid history index per row (everything below is zero padding).
    valid = np.minimum(np.arange(nblocks, dtype=np.int64) * bs + dict_len, W)
    hist_start = (W - valid).astype(np.int32)

    if encode_batch is None:
        outs, out_lens = encode_blocks_batch(
            jnp.asarray(work_h), jnp.asarray(lens), W, use_fingerprints,
            jnp.asarray(hist_start))
    else:
        outs, out_lens = encode_batch(work_h, lens, W, hist_start)

    lcfg = config.with_(block_independence=False)
    if assemble == "device":
        from ..ops.assemble_xla import assemble_blocks
        cap = nblocks * (4 + bs) + 4
        body, body_total = assemble_blocks(
            jnp.asarray(outs[:nblocks]), jnp.asarray(out_lens[:nblocks]),
            jnp.asarray(work[:nblocks]), jnp.asarray(lens[:nblocks]), cap)
        body_np = np.asarray(body[: int(body_total)].astype(jnp.uint8))
        header = _frame_header_bytes(lcfg, n, dict_id)
        parts = [header, body_np]
        if config.content_checksum:
            ck = np.empty(4, np.uint8)
            write_u32le(ck, 0, xxhash32(raw, 0))
            parts.append(ck)
        return np.concatenate(parts)
    outs_np = np.asarray(jnp.asarray(outs[:nblocks]).astype(jnp.uint8))
    out_lens_np = np.asarray(out_lens[:nblocks])
    return _host_assemble(raw, outs_np, out_lens_np, lens[:nblocks],
                          nblocks, bs, lcfg, dict_id)


def _decode_linked(buf, blocks, bs, window=None) -> np.ndarray:
    """Linked-frame device decode: one jitted scan carrying the window."""
    from ..ops.linked_xla import decode_linked_scan

    nb = len(blocks)
    max_comp = max((size for _, size, _ in blocks), default=1)
    m_cap = min(_bucket_pow2(max_comp), block_bound(bs))
    nbp = _rows_bucket(nb)
    comp = np.zeros((nbp, m_cap), np.uint8)
    lens = np.zeros(nbp, np.int32)
    stored = np.zeros(nbp, np.int32)
    for i, (off, size, st) in enumerate(blocks):
        comp[i, :size] = buf[off: off + size]
        lens[i] = size
        stored[i] = 1 if st else 0

    init_window = np.zeros(WINDOW_SIZE, np.uint8)
    init_filled = 0
    if window is not None:
        init_filled = len(window)
        init_window[WINDOW_SIZE - init_filled:] = window

    outs, out_lens = decode_linked_scan(
        jnp.asarray(comp), jnp.asarray(lens), jnp.asarray(stored),
        jnp.asarray(init_window), jnp.int32(init_filled), bs)

    from ..ops.assemble_xla import concat_blocks
    flat, total = concat_blocks(outs[:nb], out_lens[:nb], nb * bs)
    return np.asarray(flat[: int(total)].astype(jnp.uint8))


# ---------------------------------------------------------------------------
# Multi-frame pipelining: queue every frame's device work before the first
# fetch, so the host half of frame k overlaps the device half of frame k+1.
# ---------------------------------------------------------------------------

def device_compress_frames(datas, config: FrameConfig = DEFAULT_CONFIG,
                           dictionary=None, engine: str = "split"):
    """Encode N payloads into N frames with device dispatches pipelined:
    every frame's chain dispatches are queued before the first host
    select/serialize. Configurations the chain-direct path does not
    pipeline (linked frames, block checksums, engine="xla") encode frame
    by frame through device_compress_frame."""
    datas = list(datas)
    if not (engine == "split" and config.block_independence
            and not config.block_checksums):
        return [device_compress_frame(d, config, dictionary=dictionary,
                                      engine=engine) for d in datas]
    from ..ops.hybrid_encode import hybrid_max_bs
    if config.resolved_block_size > hybrid_max_bs():
        from .bigblock import compress_frames_big
        return compress_frames_big(datas, config, dictionary)
    states = [_compress_independent_split(d, config, dictionary, defer=True)
              for d in datas]
    return [_split_encode_fetch(s) for s in states]


def device_decompress_frames(frames, verify_checksum: bool = True,
                             dictionary=None, engine: str = "split"):
    """Decode N frames with device dispatches pipelined: frame k+1's host
    record parse overlaps frame k's region kernel; all fetches come last.
    Frames the region kernel does not take (engine="xla", linked frames,
    blocks over REGION_KERNEL_MAX_BLOCK) decode in place through
    device_decompress_frame."""
    if engine == "xla":
        return [device_decompress_frame(f, verify_checksum,
                                        dictionary=dictionary, engine=engine)
                for f in frames]
    if engine not in DECODE_ENGINES:
        raise ValueError(f"unknown decode engine {engine!r}; supported: "
                         f"{', '.join(DECODE_ENGINES)}")
    frames = list(frames)
    results, pend = [None] * len(frames), []
    for i, f in enumerate(frames):
        buf = ensure_buffer(f)
        header, blocks, tail = parse_block_index(buf, verify_checksum)
        if not (blocks and region_kernel_fits(header)):
            results[i] = device_decompress_frame(
                buf, verify_checksum, dictionary=dictionary, engine=engine)
            continue
        window = _check_frame(buf, header, blocks, dictionary,
                              verify_checksum)
        out, total = decode_frame_body(buf, blocks, header["block_max"],
                                       True, window)
        pend.append((i, buf, header, tail, out, total))
    for i, buf, header, tail, out, total in pend:
        results[i] = np.asarray(out)[:total]
        _verify_content(buf, header, tail, results[i], verify_checksum)
    return results
