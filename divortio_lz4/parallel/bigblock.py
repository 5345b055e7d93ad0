"""Device encode for LARGE blocks (256 KB / 1 MB / 4 MB).

The chain-direct encoder is a 64 KB machine: its dist chains hold payload
positions as u16 (ops/hybrid_encode.py `hybrid_max_bs`). The reference's
DEFAULT config is 4 MB blocks
(/root/reference/src/buffer/bufferCompress.js:100). This module serves big
blocks with the same engine by exploiting the format's own locality bound:
**LZ4 match offsets never exceed 64 KB**, so any position's encode context
is the previous 64 KB of plaintext, wherever the block boundaries are.

``compress_frame_big`` splits every block into 64 KB segments; each segment
encodes independently with its preceding 64 KB of plaintext as a history
row (the linked-mode trick of parallel/device.py `_compress_linked`,
applied INSIDE a block — fully data-parallel, batched, shardable). Segments
run the chain-direct engine — device u16 dist chains
(ops/hybrid_encode.build_dist_chains) + the native host
select/extend/serialize with splice meta (lz4t_chain_serialize16m). The
per-segment sequence streams are then spliced into one spec-exact block
stream on host: a segment's trailing-literal run merges into the next
segment's first sequence (their literal bytes are contiguous plaintext), so
only one token/length header is rewritten per boundary. Boundary cost:
matches cannot SPAN a segment boundary and each segment pays the
MF_LIMIT/LAST_LITERALS end rules (~17 bytes per 64 KB worst case); the
splice re-extends boundary matches to win most of it back.

Big-block decode needs no special path: the region decode kernel
(ops/gpu_decode) decodes any block size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import FrameConfig
from ..constants import WINDOW_SIZE, UNCOMPRESSED_FLAG
from ..utils import ensure_buffer, write_u32le
from ..xxh import xxhash32

SEG = WINDOW_SIZE            # encode segment size (the u16 chain ceiling)


# --------------------------------------------------------------------------
# Encode: 64 KB segment rows + host splice
# --------------------------------------------------------------------------

def _segment_rows(raw: np.ndarray, bs: int, window: Optional[np.ndarray],
                  linked: bool):
    """[64 KB history | 64 KB payload] rows for every segment of every block.

    Independent blocks clip history at the block start (dictionary window
    fills the remainder); linked blocks see prior-block plaintext too —
    identical context to what a single continuous encoder would use.
    Returns (work u8[nrows, W+SEG], lens i32, hist_start i32,
    seg_rows: list of per-block [row indices]).
    """
    W = WINDOW_SIZE
    n = len(raw)
    dict_len = len(window) if window is not None else 0
    nblocks = max(1, -(-n // bs))
    seg_rows = []
    rows = []
    lens = []
    hist_start = []
    for b in range(nblocks):
        bstart = b * bs
        bend = min(bstart + bs, n)
        nseg = max(1, -(-(bend - bstart) // SEG))
        rlist = []
        for j in range(nseg):
            sstart = bstart + j * SEG
            send = min(sstart + SEG, bend)
            row = np.zeros(W + SEG, np.uint8)
            row[W: W + (send - sstart)] = raw[sstart:send]
            floor = 0 if linked else bstart
            avail = min(sstart - floor, W)
            if avail > 0:
                row[W - avail: W] = raw[sstart - avail: sstart]
            room = W - avail
            take = min(dict_len, room)
            if take > 0:
                row[room - take: room] = window[dict_len - take:]
            rows.append(row)
            lens.append(send - sstart)
            hist_start.append(room - take)
            rlist.append(len(rows) - 1)
        seg_rows.append(rlist)
    return (np.stack(rows), np.array(lens, np.int32),
            np.array(hist_start, np.int32), seg_rows)


def _dispatch_segments(work: np.ndarray, lens: np.ndarray,
                       hist_start: np.ndarray):
    """Queue the chain-kernel dispatches for segment rows (async).
    Returns [(row_base, real_rows, chains_device)] — the dispatch half of
    _encode_segments, split out so the multi-frame path can queue EVERY
    frame's chains before the first fetch."""
    import jax.numpy as jnp

    from ..ops.hybrid_encode import build_dist_chains

    CH = 32
    nrows = work.shape[0]
    pend = []
    for i in range(0, nrows, CH):
        w = work[i: i + CH]
        l = lens[i: i + CH]
        hs = hist_start[i: i + CH]
        r = w.shape[0]
        target = CH if nrows > CH else -(-r // 8) * 8
        if r < target:
            w = np.concatenate(
                [w, np.zeros((target - r, w.shape[1]), w.dtype)])
            l = np.concatenate([l, np.zeros(target - r, np.int32)])
            hs = np.concatenate([hs, np.zeros(target - r, np.int32)])
        ch = build_dist_chains(jnp.asarray(w.astype(np.int32)),
                               jnp.asarray(l), WINDOW_SIZE,
                               jnp.asarray(hs))
        pend.append((i, r, ch))
    return pend


def _encode_segments(work: np.ndarray, lens: np.ndarray,
                     hist_start: np.ndarray, pend=None):
    """Chain-direct encode of segment rows: device scored chains
    (build_dist_chains, u16 dist wire) + native host
    select/extend/serialize — the same engine as the 64 KB frame path; the
    host tail overlaps the next chunk's device work. Returns
    (outs u8[nrows, OW], out_lens i64, meta i64[nrows, 4]) with
    the splice meta lanes: trailing-token position, trailing literal
    count, last-match-sequence stream offset, last-match output anchor
    (lz4t_chain_serialize16m)."""
    from ..constants import block_bound
    from ..ops.split_encode import chain_select_serialize_meta

    nrows, rowlen = work.shape
    # queue every chunk's chain dispatch before fetching any (fetch of
    # chunk k overlaps chunks k+1.. on device); the multi-frame path
    # passes pre-queued *pend* instead
    if pend is None:
        pend = _dispatch_segments(work, lens, hist_start)
    # serializer reads 8-byte words past hist+src: pad rows once
    wk = np.zeros((nrows, rowlen + 8), np.uint8)
    wk[:, :rowlen] = work
    OW = block_bound(SEG) + 16
    outs = np.zeros((nrows, OW), np.uint8)
    out_lens = np.zeros(nrows, np.int64)
    metas = np.zeros((nrows, 4), np.int64)

    from ..utils.pool import host_pool

    ex = host_pool()
    for i, r, ch in pend:
        ch_np = np.asarray(ch)  # syncs this chunk; later chunks keep going

        def _ser_one(k, base=i, chains=ch_np):
            s, meta = chain_select_serialize_meta(
                wk[k], WINDOW_SIZE, int(lens[k]), chains[k - base])
            outs[k, : len(s)] = s
            out_lens[k] = len(s)
            metas[k] = meta

        list(ex.map(_ser_one, range(i, i + r)))
    return outs, out_lens, metas


def _seq_header(lit_len: int, low_nibble: int) -> np.ndarray:
    """Token byte + 0xFF-run literal-length extension."""
    b = [(min(lit_len, 15) << 4) | low_nibble]
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            b.append(255)
            rem -= 255
        b.append(rem)
    return np.array(b, np.uint8)


def _parse_litlen(stream: np.ndarray, p: int = 0):
    """(literal length, header byte count) of the sequence at *p*."""
    tok = int(stream[p])
    lit = tok >> 4
    q = p + 1
    if lit == 15:
        while True:
            v = int(stream[q]); q += 1; lit += v
            if v != 255:
                break
    return lit, q - p


def _parse_seq(stream: np.ndarray, p: int):
    """Parse one full (match-carrying) sequence at byte offset *p*.

    Returns dict(lit, hdr, off, mlen, end): literal count, token+lit-ext
    byte count, match offset, match length, offset past the sequence."""
    lit, hdr = _parse_litlen(stream, p)
    q = p + hdr + lit
    off = int(stream[q]) | (int(stream[q + 1]) << 8)
    q += 2
    tok = int(stream[p])
    ml = tok & 15
    if ml == 15:
        while True:
            v = int(stream[q]); q += 1; ml += v
            if v != 255:
                break
    return {"lit": lit, "hdr": hdr, "off": off, "mlen": ml + 4, "end": q}


def _emit_seq(lit_bytes: np.ndarray, off: int, mlen: int) -> np.ndarray:
    """Serialize one full sequence (token, lit ext, literals, offset,
    match ext)."""
    head = _seq_header(len(lit_bytes), min(mlen - 4, 15))
    tail = [np.array([off & 0xFF, (off >> 8) & 0xFF], np.uint8)]
    if mlen - 4 >= 15:
        rem = mlen - 4 - 15
        mx = []
        while rem >= 255:
            mx.append(255)
            rem -= 255
        mx.append(rem)
        tail.append(np.array(mx, np.uint8))
    return np.concatenate([head, lit_bytes] + tail)


def _ext_len(raw: np.ndarray, start: int, dist: int, limit: int) -> int:
    """How far plaintext continues to match itself at -dist from *start*."""
    if limit <= 0:
        return 0
    a = raw[start: start + limit]
    b = raw[start - dist: start - dist + len(a)]
    neq = np.nonzero(a != b)[0]
    return int(neq[0]) if len(neq) else len(a)


def _absorb_prefix(stream, take_total: int, seg_g: int, raw: np.ndarray):
    """Absorb up to *take_total* output bytes from a segment stream's front
    (whole sequences; literal runs cut anywhere; matches cut from the front
    down to mlen >= 4 — dist is start-relative, so a front cut is free).
    Returns (absorbed, skip, rebuilt_first_or_None)."""
    e2 = 0
    p = 0
    rebuild = None
    while e2 < take_total:
        fs = _parse_seq(stream, p)
        cover = fs["lit"] + fs["mlen"]
        if e2 + cover <= take_total:
            e2 += cover
            p = fs["end"]
            continue
        r = take_total - e2
        if r <= fs["lit"]:
            lit2 = fs["lit"] - r
            ls = seg_g + e2 + r
            rebuild = _emit_seq(raw[ls: ls + lit2], fs["off"], fs["mlen"])
        else:
            q = r - fs["lit"]
            if fs["mlen"] - q < 4:
                q = fs["mlen"] - 4
                if q <= 0:
                    break
                r = fs["lit"] + q
            rebuild = _emit_seq(raw[seg_g:seg_g], fs["off"], fs["mlen"] - q)
        e2 += r
        p = fs["end"]
        break
    return e2, p, rebuild


def _splice_block(raw: np.ndarray, bstart: int, bend: int, streams, metas,
                  seg_sizes, src_floor: int) -> np.ndarray:
    """Join per-segment sequence streams into ONE block stream.

    Two boundary repairs make the result match what a continuous encoder
    would emit (measured: without them, segmentation costs ~25 B per 64 KB
    boundary and loses the <=-reference ratio gate on highly compressible
    corpora):

    1. **Trailing-literal merge**: a segment's trailing-literal run (>= 5
       bytes by the LAST_LITERALS rule, or the whole segment when it found
       no match) merges into the next segment's first sequence — the two
       literal runs are contiguous plaintext, so only one token/length
       header is rewritten.
    2. **Boundary match extension**: each segment's FINAL match stopped at
       an artificial match limit, so it is re-extended over the boundary by
       direct plaintext comparison, absorbing first the trailing literals
       and then the next segment's leading output (whole sequences;
       partial literal runs and front-cut matches are free rewrites). The
       block-level spec rules stay intact: extension never reaches past
       block_end - 5, and the final 12-byte no-match zone belongs to the
       block's last segment, which keeps its own end rules.
    """
    parts = []
    pending = 0        # trailing literals awaiting a merge
    pend_start = 0     # their global plaintext start
    open_ext = None    # {budget, fidx, lit_bytes, off, mlen} — an extended
    #                    final match that may keep absorbing forward

    def emit_final(f):
        return _emit_seq(f["lit_bytes"], f["off"], f["mlen"])

    for j, stream in enumerate(streams):
        ssz = int(seg_sizes[j])
        if ssz == 0:
            continue
        tp, tl, lsd, lanchor = (int(x) for x in metas[j])
        seg_g = bstart + j * SEG
        body_start = 0
        rebuild_first = None
        final_fields = None

        if open_ext is not None:
            if tp == 0:
                take = min(open_ext["budget"], ssz)
                open_ext["mlen"] += take
                open_ext["budget"] -= take
                if take == ssz:
                    continue  # whole literal segment swallowed; stay open
                parts[open_ext["fidx"]] = emit_final(open_ext)
                open_ext = None
                pending = ssz - take
                pend_start = seg_g + take
                continue
            final = _parse_seq(stream, lsd)
            budget = open_ext["budget"]
            fcover = final["lit"] + final["mlen"]
            if budget < lanchor:
                # (a) stop among the early sequences
                e2, body_start, rebuild_first = _absorb_prefix(
                    stream, budget, seg_g, raw)
                open_ext["mlen"] += e2
            elif budget < lanchor + fcover:
                # (b) stop inside the final sequence: cut its literal run
                # anywhere / its match from the front (dist is relative —
                # a front cut is free down to mlen >= 4)
                r = budget - lanchor
                if r <= final["lit"]:
                    ls = seg_g + lanchor + r
                    final_fields = {
                        "lit_bytes": raw[ls: ls + final["lit"] - r],
                        "off": final["off"], "mlen": final["mlen"]}
                    absorbed = budget
                else:
                    q = min(r - final["lit"], final["mlen"] - 4)
                    final_fields = {
                        "lit_bytes": raw[seg_g:seg_g],
                        "off": final["off"], "mlen": final["mlen"] - q}
                    absorbed = lanchor + final["lit"] + q
                open_ext["mlen"] += absorbed
                body_start = lsd  # early sequences fully absorbed
            else:
                # (c) swallow the final sequence whole, then eat into the
                # trailing literals; stay open past an exhausted segment
                rem = budget - lanchor - fcover
                e_tl = min(rem, tl)
                open_ext["mlen"] += lanchor + fcover + e_tl
                open_ext["budget"] = rem - e_tl
                if e_tl == tl and open_ext["budget"] > 0:
                    continue
                parts[open_ext["fidx"]] = emit_final(open_ext)
                open_ext = None
                pending = tl - e_tl
                pend_start = seg_g + ssz - pending
                continue
            parts[open_ext["fidx"]] = emit_final(open_ext)
            open_ext = None

        if tp == 0:
            # All-literal segment: extend (or start) the pending run.
            if pending == 0:
                pend_start = seg_g
            pending += ssz
            continue

        if final_fields is None:
            final = _parse_seq(stream, lsd)
            final_fields = {
                "lit_bytes": raw[seg_g + lanchor:
                                 seg_g + lanchor + final["lit"]],
                "off": final["off"], "mlen": final["mlen"],
            }
        if pending > 0:
            lit1, hdr = _parse_litlen(stream)
            merged = pending + lit1
            if lsd == 0:
                final_fields["lit_bytes"] = raw[pend_start:
                                                pend_start + merged]
            else:
                parts.append(_seq_header(merged, int(stream[0]) & 0x0F))
                parts.append(raw[pend_start: pend_start + merged])
                parts.append(stream[hdr + lit1: lsd])
        else:
            if rebuild_first is not None:
                parts.append(rebuild_first)
            parts.append(stream[body_start:lsd])
        parts.append(emit_final(final_fields))
        fidx = len(parts) - 1

        pending = tl
        pend_start = seg_g + ssz - tl
        match_end = pend_start
        if match_end - final_fields["off"] >= src_floor:
            e = _ext_len(raw, match_end, final_fields["off"],
                         (bend - 5) - match_end)
            e_pend = min(e, pending)
            if e_pend > 0:
                final_fields["mlen"] += e_pend
                pending -= e_pend
                pend_start += e_pend
                parts[fidx] = emit_final(final_fields)
            if pending == 0 and e > e_pend:
                open_ext = dict(final_fields, budget=e - e_pend, fidx=fidx)

    if open_ext is not None:
        parts[open_ext["fidx"]] = emit_final(open_ext)
    parts.append(_seq_header(pending, 0))
    parts.append(raw[pend_start: pend_start + pending])
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


def compress_frame_big(data,
                       config: FrameConfig,
                       dictionary=None, defer: bool = False):
    """Device-compress a frame whose block size exceeds the hybrid
    encoder's 64 KB ceiling (segment + splice; see module docstring).

    Supports independent and linked frames, dictionaries, block checksums,
    stored fallback — the full `device_compress_frame` contract at
    256 KB / 1 MB / 4 MB block sizes.

    defer=True returns an opaque state after QUEUEING the chain-kernel
    dispatches (async, no sync paid); finish with
    ``_finish_frame_big(state)``."""
    from .device import _dict_window

    raw = ensure_buffer(data)
    n = len(raw)
    bs = config.resolved_block_size
    assert bs > SEG and bs % SEG == 0, bs
    window, dict_id = _dict_window(dictionary)
    linked = not config.block_independence

    work, lens, hist_start, seg_rows = _segment_rows(raw, bs, window, linked)
    pend = _dispatch_segments(work, lens, hist_start)
    if defer:
        return (raw, n, bs, config, dict_id, linked, seg_rows, work, lens,
                hist_start, pend)
    return _finish_frame_big(
        (raw, n, bs, config, dict_id, linked, seg_rows, work, lens,
         hist_start, pend))


def _finish_frame_big(state) -> np.ndarray:
    """Serialize/splice/assemble half of compress_frame_big."""
    from .device import _frame_header_bytes

    (raw, n, bs, config, dict_id, linked, seg_rows, work, lens,
     hist_start, pend) = state
    outs, out_lens, metas = _encode_segments(work, lens, hist_start,
                                             pend=pend)

    comps = []
    for b, rlist in enumerate(seg_rows):
        bstart = b * bs
        bend = min(bstart + bs, n)
        comp = _splice_block(
            raw, bstart, bend,
            [outs[r][: int(out_lens[r])] for r in rlist],
            [metas[r] for r in rlist],
            [lens[r] for r in rlist],
            src_floor=0 if linked else bstart)
        comps.append(comp)

    # --- Frame assembly (header / size words / stored fallback / EndMark) ---
    frame = np.empty(19 + n + (n // 255) + (16 + 8) * len(comps) + 8,
                     np.uint8)
    header = _frame_header_bytes(config, n, dict_id)
    frame[: len(header)] = header
    pos = len(header)
    if n > 0:
        for b, comp in enumerate(comps):
            bstart = b * bs
            bsize = min(bs, n - bstart)
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
                frame[pos: pos + bsize] = raw[bstart: bstart + bsize]
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


def compress_frames_big(datas, config: FrameConfig,
                        dictionary=None) -> list:
    """Multi-frame pipelined big-block encode: queue EVERY frame's
    chain-kernel dispatches before the first fetch, then
    serialize/splice/assemble frame by frame while later chains compute."""
    states = [compress_frame_big(d, config, dictionary, defer=True)
              for d in datas]
    return [_finish_frame_big(s) for s in states]
