"""Region decode: host-parsed records, one Pallas (Triton) program per region.

The LZ4 sequence parse is serial byte work and stays on the host: the
native parser (``lz4t_parse_records2``) turns every block into *records*
of at most 128 output bytes each. A record is a literal slice copied from
the compressed bytes, then a match copy from earlier output whose source
never overlaps the record's own destination. Records tile a block's output
in order, so each record's destination is the running sum of the lengths
before it.

The device walks the records. One program decodes one *region* — an
independent block, or a whole linked frame — in record order:

- one masked 128-lane load of the literal slice, one masked load of the
  match source (from the region's output, or from the history window for
  back-references before the region start), one masked 128-lane store;
- a barrier between records, because a record may read bytes the previous
  record wrote.

Regions are independent (an independent block's window resets; a linked
frame is a single region), so programs run in any order and the card fills
with as many regions as the batch holds. Every address is clamped inside
its buffer, so hostile records cannot read or write out of bounds.

Reference semantics: /root/reference/src/block/blockDecompress.js:55-272.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import WINDOW_SIZE
from .route import kernel_interpret

W = WINDOW_SIZE
SPAN = 128  # output bytes a record covers at most (one 128-lane copy)


# ---------------------------------------------------------------------------
# Host: record parse
# ---------------------------------------------------------------------------

def _parse_records2_py(src: np.ndarray, out_cap: int, dict_len: int = 0):
    """Pure-Python fallback for lz4t_parse_records2 (same record contract).

    Returns (recs u32[n, 2], out_len); a record is
    (src, off | ll<<16 | ml<<24)."""
    cb = src.tolist()
    n = len(cb)
    p = o = 0
    recs = []

    def emit(s, off, ll, ml):
        recs.append((s, (off | (ll << 16) | (ml << 24)) & 0xFFFFFFFF))

    while p < n:
        tok = cb[p]; p += 1
        ll = tok >> 4
        if ll == 15:
            while True:
                if p >= n:
                    raise ValueError("LZ4: Malformed Input")
                v = cb[p]; p += 1; ll += v
                if v != 255:
                    break
        if o + ll > out_cap:
            raise ValueError("LZ4: Output Buffer Too Small")
        if p + ll > n:
            raise ValueError("LZ4: Malformed Input")
        lp = p
        o += ll; p += ll
        if p >= n:
            while ll > 0:
                take = min(ll, SPAN)
                emit(lp, 1, take, 0)
                lp += take; ll -= take
            break
        if p + 2 > n:
            raise ValueError("LZ4: Malformed Input")
        off = cb[p] | (cb[p + 1] << 8)
        p += 2
        if off == 0:
            raise ValueError("LZ4: Invalid Offset 0")
        if off > o + dict_len:
            raise ValueError("LZ4: Dictionary Offset Out of Bounds")
        ml = tok & 15
        if ml == 15:
            while True:
                if p >= n:
                    raise ValueError("LZ4: Malformed Input")
                v = cb[p]; p += 1; ml += v
                if v != 255:
                    break
        ml += 4
        if o + ml > out_cap:
            raise ValueError("LZ4: Output Buffer Too Small")
        o += ml
        if ll + ml <= SPAN and off >= ll + ml:
            emit(lp, off, ll, ml)          # one combined record
            continue
        if off >= SPAN:
            while ll > SPAN:
                emit(lp, 1, SPAN, 0)
                lp += SPAN; ll -= SPAN
            take = min(ml, SPAN - ll)
            emit(lp, off, ll, take)        # literal tail absorbs match head
            ml -= take
            while ml > 0:
                take = min(ml, SPAN)
                emit(0, off, 0, take)
                ml -= take
            continue
        while ll > 0:                      # overlap: literals, then doubling
            take = min(ll, SPAN)
            emit(lp, 1, take, 0)
            lp += take; ll -= take
        d = off
        while d < SPAN and ml > 0:
            take = min(ml, d)
            emit(0, d, 0, take)
            ml -= take; d *= 2
        while ml > 0:
            take = min(ml, SPAN)
            emit(0, d, 0, take)
            ml -= take
    return (np.array(recs, np.uint32).reshape(-1, 2) if recs
            else np.empty((0, 2), np.uint32)), o


def parse_records_wire(src: np.ndarray, out_cap: int, dict_len: int = 0):
    """Parse one block's compressed bytes into records (native fast path,
    Python fallback). Returns (recs u32[nrec, 2], out_len)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    try:
        from ..native import parse_records2_native
    except Exception:
        parse_records2_native = None
    if parse_records2_native is not None:
        return parse_records2_native(src, out_cap, dict_len)
    return _parse_records2_py(src, out_cap, dict_len)


def stored_wire_records(size: int) -> np.ndarray:
    """Pure-literal records for a stored block: its bytes are the
    plaintext, copied through in 128-byte slices."""
    if size == 0:
        return np.empty((0, 2), np.uint32)
    n = -(-size // SPAN)
    r = np.empty((n, 2), np.uint32)
    r[:, 0] = np.arange(n, dtype=np.uint32) * SPAN
    take = np.full(n, SPAN, np.uint32)
    take[-1] = size - SPAN * (n - 1)
    r[:, 1] = 1 | (take << 16)
    return r


class Plan(NamedTuple):
    """Device inputs for one dispatch of the region kernel.

    wire: u8 bytes every record's literal slice indexes into.
    recs: i32[n, 2] records (src, off | ll<<16 | ml<<24) with src an
      offset into *wire*; a region's records tile its output in order.
    meta: i32[R, 4] per region (first record, record count, output start,
      output length).
    total: plaintext bytes (regions are laid out back to back)."""
    wire: np.ndarray
    recs: np.ndarray
    meta: np.ndarray
    total: int


def plan_regions(buf: np.ndarray, blocks, block_max: int,
                 independent: bool = True, dict_len: int = 0) -> Plan:
    """Parse *blocks* (offset, size, stored) of *buf* into one dispatch's
    records: one region per block when *independent*, else one region for
    the whole linked chain, whose back-references reach earlier blocks.
    Every region sees *dict_len* bytes of history before its start.
    Raises the host tier's error taxonomy on malformed blocks."""
    buf = np.asarray(buf, np.uint8)
    blocks = list(blocks)
    lo = min((off for off, _, _ in blocks), default=0)
    hi = max((off + size for off, size, _ in blocks), default=0)
    assert hi - lo < 2 ** 31, "split the dispatch"
    wire = buf[lo:hi]
    offs = np.array([off - lo for off, _, _ in blocks], np.int64)
    sizes = np.array([size for _, size, _ in blocks], np.int64)
    stored = np.array([st for _, _, st in blocks], np.uint8)
    try:
        from ..native import parse_records2_batch_native
    except Exception:
        parse_records2_batch_native = None
    if parse_records2_batch_native is not None:
        recs, counts, lens = parse_records2_batch_native(
            wire, offs, sizes, stored, block_max, dict_len, independent)
    else:
        parts, lens, hist = [], [], dict_len
        for off, size, st in zip(offs, sizes, stored):
            if st:
                r, ol = stored_wire_records(int(size)), int(size)
            else:
                r, ol = parse_records_wire(wire[off: off + size],
                                           block_max, hist)
            r[:, 0] += off
            parts.append(r)
            lens.append(ol)
            if not independent:
                hist += ol
        counts = np.array([len(r) for r in parts], np.int64)
        lens = np.array(lens, np.int64)
        recs = (np.concatenate(parts) if parts
                else np.empty((0, 2), np.uint32))
    if not independent and len(blocks):
        counts, lens = counts.sum(keepdims=True), lens.sum(keepdims=True)
    total = int(lens.sum())
    assert total < 2 ** 31, "split the dispatch"
    meta = np.stack([np.cumsum(counts) - counts, counts,
                     np.cumsum(lens) - lens, lens], 1).astype(np.int32)
    return Plan(wire, recs.view(np.int32), meta.reshape(-1, 4), total)


# ---------------------------------------------------------------------------
# Device: the region kernel
# ---------------------------------------------------------------------------

def _make_kernel(interpret: bool):
    def kernel(meta_ref, recs_ref, wire_ref, hist_ref, out_ref):
        r = pl.program_id(0)
        rec0 = meta_ref[r, 0]
        nrec = meta_ref[r, 1]
        start = meta_ref[r, 2]
        olen = meta_ref[r, 3]
        t = jnp.arange(SPAN, dtype=jnp.int32)
        wmax = wire_ref.shape[0] - 1
        hmax = hist_ref.shape[0] - 1
        omax = out_ref.shape[0] - 1

        def body(i, dst):
            # records tile the region in order: dst is the running sum
            k = rec0 + i
            src = recs_ref[k, 0]
            w1 = recs_ref[k, 1]
            dst = jnp.clip(dst, 0, olen)
            off = jnp.maximum(w1 & 0xFFFF, 1)
            ll = jax.lax.shift_right_logical(w1, 16) & 0xFF
            ml = jax.lax.shift_right_logical(w1, 24)
            tot = jnp.clip(ll + ml, 0, jnp.minimum(SPAN, olen - dst))
            lit = plgpu.load(wire_ref.at[jnp.clip(src + t, 0, wmax)],
                             mask=t < ll, other=0)
            # match byte t comes from region position q: earlier output
            # (q >= 0) or the history window right-aligned before it
            q = dst - off + t
            is_match = (t >= ll) & (t < tot)
            from_out = plgpu.load(out_ref.at[jnp.clip(start + q, 0, omax)],
                                  mask=is_match & (q >= 0), other=0)
            from_hist = plgpu.load(hist_ref.at[jnp.clip(W + q, 0, hmax)],
                                   mask=is_match & (q < 0), other=0)
            val = jnp.where(t < ll, lit, jnp.where(q < 0, from_hist,
                                                   from_out))
            plgpu.store(out_ref.at[jnp.clip(start + dst + t, 0, omax)], val,
                        mask=t < tot)
            if not interpret:
                # the next record may read these bytes; the interpreter
                # runs records in order (and has no barrier rule)
                plgpu.debug_barrier()
            return dst + tot

        jax.lax.fori_loop(0, nrec, body, jnp.int32(0))

    return kernel


def _region_call(meta, recs, wire, hist, out_len: int, interpret: bool):
    return pl.pallas_call(
        _make_kernel(interpret),
        grid=(meta.shape[0],),
        out_shape=jax.ShapeDtypeStruct((out_len,), jnp.uint8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lz4_region_decode",
    )(meta, recs, wire, hist)


region_kernel = jax.jit(_region_call, static_argnames=("out_len",
                                                       "interpret"))


def decode_regions(meta: jax.Array, recs: jax.Array, wire: jax.Array,
                   hist: jax.Array, out_len: int) -> jax.Array:
    """Run the region kernel on the route this platform takes (ops/route):
    meta i32[R, 4], recs i32[n, 2], wire u8[m], hist u8[W] (the history
    window, right-aligned). Returns u8[out_len], regions back to back from
    offset 0."""
    return region_kernel(meta, recs, wire, hist, out_len=out_len,
                         interpret=kernel_interpret())


def _bucket(n: int, floor: int = 1024) -> int:
    """Smallest m * 2**e >= n with 8 <= m < 16: at most 1/8 padding, and
    few distinct shapes for the compile cache."""
    n = max(n, floor)
    e = max(n.bit_length() - 4, 0)
    m = -(-n // (1 << e))
    return m << e


def _pad(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return np.ascontiguousarray(a)
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def padded_inputs(plan: Plan, window=None):
    """Bucket-padded host arrays (meta, recs, wire, hist) and out_len for
    ``decode_regions``. Pad regions have no records; pad bytes are never
    read by a real record. The output keeps SPAN bytes past the plaintext,
    so a record's 128 store lanes never clamp onto one address (the
    interpreter's masked store writes the lanes it masks off)."""
    hist = np.zeros(W, np.uint8)
    if window is not None and len(window):
        hist[W - len(window):] = window[-W:]
    return (_pad(plan.meta, _bucket(len(plan.meta), 8)),
            _pad(plan.recs, _bucket(len(plan.recs))),
            _pad(plan.wire, _bucket(len(plan.wire))),
            hist, _bucket(plan.total + SPAN))


def dispatch(plan: Plan, window=None) -> jax.Array:
    """Queue one kernel call for *plan* (async). The first plan.total bytes
    of the result are the plaintext."""
    meta, recs, wire, hist, out_len = padded_inputs(plan, window)
    return decode_regions(jnp.asarray(meta), jnp.asarray(recs),
                          jnp.asarray(wire), jnp.asarray(hist), out_len)


def decode_frame_body(buf: np.ndarray, blocks, block_max: int,
                      independent: bool, window=None):
    """Queue the decode of a frame body (blocks from parse_block_index):
    one region per independent block, or one region for a linked frame.
    Returns (device output, plaintext length)."""
    dict_len = len(window) if window is not None else 0
    plan = plan_regions(buf, blocks, block_max, independent, dict_len)
    return dispatch(plan, window), plan.total


def decode_blocks(comps, block_size: int):
    """Decode independent compressed blocks in one dispatch; returns the
    plaintext of each, in order."""
    sizes = [len(c) for c in comps]
    buf = (np.concatenate([np.asarray(c, np.uint8) for c in comps])
           if comps else np.empty(0, np.uint8))
    offs = np.cumsum(sizes) - np.array(sizes, np.int64)
    plan = plan_regions(
        buf, [(int(o), s, False) for o, s in zip(offs, sizes)], block_size)
    out = np.asarray(dispatch(plan))
    return [out[s: s + n] for s, n in zip(plan.meta[:, 2], plan.meta[:, 3])]
