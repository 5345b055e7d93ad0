"""Chain-direct encode: device candidate chains + host selection/serialize.

The division of labor follows what each side is good at:

- **Device (XLA): the exhaustive candidate search.** ``build_dist_chains``
  (ops/hybrid_encode.py) finds, for EVERY payload position, the best
  previous identical-word occurrence — one fused lexicographic sort with
  prefix-fingerprint scoring payloads — and ships it as a u16 match
  distance per position (0 = none): 2 B/position to the host. This is the
  reference's hash-table match finder (blockCompress.js:53-71) made exact
  and data-parallel; it is where the encode work lives.

- **Host (native C): greedy selection + exact extension + serialization.**
  ``lz4t_chain_serialize16`` finds each next match by scanning the dist
  array for the next nonzero (memchr-class), then exact-extends and
  serializes at memcpy-class speed — O(sequences + positions-scanned)
  work over the fetched chain. The greedy selection is inherently
  sequential cheap work, done during the serialization the host must do
  anyway.

Reference semantics: /root/reference/src/block/blockCompress.js:31-232.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, block_bound
from .hybrid_encode import build_dist_chains, hybrid_max_bs

__all__ = ["encode_blocks_chain", "chain_select_serialize",
           "encode_block_split_host", "hybrid_max_bs"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def encode_blocks_chain(work: np.ndarray, lens: np.ndarray, block_size: int,
                        hist_len: int = 0, hist_start=0,
                        exact: bool = False):
    """Build candidate chains for a batch of blocks on device.

    Args:
      work: u8/i32[nb, hist_len + block_size] ([history | payload] rows).
      lens: i32[nb] payload sizes.
      block_size: static payload capacity (% 1024 == 0, <= hybrid_max_bs()).
      hist_len: static history width (0 or WINDOW_SIZE).
      exact: use exact-word sort buckets instead of the default hashed
        sort diet (~1/3 fewer sorted bytes; collisions filtered by the
        serializer's 4-byte verify — see hybrid_encode._cand_row).

    Returns chains as a DEVICE array u16[nb, block_size] (match distance
    per payload position, 0 = none) — fetch once and feed rows to
    ``chain_select_serialize``.
    """
    nb, NW = work.shape
    assert NW == hist_len + block_size and block_size % 1024 == 0
    assert block_size <= hybrid_max_bs()
    hs = jnp.broadcast_to(jnp.asarray(hist_start, jnp.int32), (nb,))
    return build_dist_chains(jnp.asarray(work).astype(jnp.int32),
                             jnp.asarray(lens), hist_len, hs,
                             hashed=not exact)


def chain_select_serialize(work: np.ndarray, hist_len: int, src_len: int,
                           chain: np.ndarray) -> np.ndarray:
    """Greedy-select/extend/serialize one block from its u16 dist chain
    (``build_dist_chains``).

    *work* = [history | payload] bytes with >= 8 bytes of readable slack
    after hist_len + src_len (callers pad; the native extension compares
    8-byte words). Returns the block's wire bytes."""
    out = np.empty(block_bound(src_len) + 16, np.uint8)
    work = np.ascontiguousarray(work, dtype=np.uint8)
    dist16 = np.ascontiguousarray(chain, dtype=np.uint16)
    try:
        from ..native import chain_serialize16_native
    except Exception:
        chain_serialize16_native = None
    if chain_serialize16_native is not None:
        n = chain_serialize16_native(work, hist_len, src_len, dist16, out)
        return out[:n]
    return _chain_serialize16_py(work, hist_len, src_len, dist16)


def _stream_meta(stream: np.ndarray) -> np.ndarray:
    """Splice meta lanes recovered by walking a finished block stream
    (pure-Python fallback when the native serializer is absent):
    [trailing-token pos, trailing lit count, last-match stream offset or
    -1, last-match payload anchor or -1] — lz4t_chain_serialize16m's
    contract."""
    p, n, anchor = 0, len(stream), 0
    last_d, last_anchor = -1, -1
    if n == 0:
        return np.array([0, 0, -1, -1], np.int64)
    while True:
        tok = int(stream[p])
        q = p + 1
        lit = tok >> 4
        if lit == 15:
            while True:
                b = int(stream[q])
                q += 1
                lit += b
                if b != 255:
                    break
        q += lit
        if q >= n:  # trailing literal-only token
            return np.array([p, lit, last_d, last_anchor], np.int64)
        last_d, last_anchor = p, anchor
        anchor += lit
        q += 2
        ml = tok & 0xF
        if ml == 15:
            while True:
                b = int(stream[q])
                q += 1
                ml += b
                if b != 255:
                    break
        anchor += ml + MIN_MATCH
        p = q


def chain_select_serialize_meta(work: np.ndarray, hist_len: int,
                                src_len: int, chain: np.ndarray):
    """chain_select_serialize (u16 dist chains only) + the big-block
    splicer's meta lanes. Returns (stream u8, meta i64[4])."""
    out = np.empty(block_bound(src_len) + 16, np.uint8)
    work = np.ascontiguousarray(work, dtype=np.uint8)
    dist16 = np.ascontiguousarray(chain, dtype=np.uint16)
    try:
        from ..native import chain_serialize16_meta_native
    except Exception:
        chain_serialize16_meta_native = None
    if chain_serialize16_meta_native is not None:
        n, meta = chain_serialize16_meta_native(work, hist_len, src_len,
                                                dist16, out)
        return out[:n], meta
    s = _chain_serialize16_py(work, hist_len, src_len, dist16)
    return s, _stream_meta(s)


def _chain_serialize16_py(work: np.ndarray, hist_len: int, src_len: int,
                          dist16: np.ndarray) -> np.ndarray:
    """Pure-Python fallback for lz4t_chain_serialize16 (scan-based next
    match with 4-byte collision verify)."""
    mf_limit = src_len - MF_LIMIT
    match_limit = src_len - LAST_LITERALS
    pay = work[hist_len:]
    parts = []
    o = 0
    if src_len > 0 and mf_limit > 0:
        nz = np.nonzero(dist16[:mf_limit])[0]
        zi = 0
        m = 0
        while True:
            # next matchable position >= m
            zi += int(np.searchsorted(nz[zi:], m))
            if zi >= len(nz):
                break
            m = int(nz[zi])
            dist = int(dist16[m])
            # hashed-chain collision guard: reject candidates whose first
            # MIN_MATCH bytes differ (never fires on exact chains)
            ha = hist_len + m
            if (work[ha: ha + MIN_MATCH].tobytes()
                    != work[ha - dist: ha - dist + MIN_MATCH].tobytes()):
                m += 1
                continue
            lim = match_limit - m
            a = pay[m: m + lim]
            b = work[hist_len + m - dist: hist_len + m - dist + lim]
            neq = np.nonzero(a != b)[0]
            ln = int(neq[0]) if len(neq) else lim
            ln = max(ln, MIN_MATCH)
            lit = m - o
            mcode = ln - MIN_MATCH
            head = [min(lit, 15) << 4 | min(mcode, 15)]
            if lit >= 15:
                rem = lit - 15
                while rem >= 255:
                    head.append(255)
                    rem -= 255
                head.append(rem)
            parts.append(np.array(head, np.uint8))
            parts.append(pay[o: o + lit])
            tail = [dist & 0xFF, dist >> 8]
            if mcode >= 15:
                rem = mcode - 15
                while rem >= 255:
                    tail.append(255)
                    rem -= 255
                tail.append(rem)
            parts.append(np.array(tail, np.uint8))
            o = m + ln
            m = o
    lit = src_len - o
    head = [min(lit, 15) << 4]
    if lit >= 15:
        rem = lit - 15
        while rem >= 255:
            head.append(255)
            rem -= 255
        head.append(rem)
    parts.append(np.array(head, np.uint8))
    parts.append(pay[o: o + lit])
    return np.concatenate(parts)


def encode_block_split_host(data: np.ndarray, block_size: int | None = None,
                            exact: bool = False) -> np.ndarray:
    """Host convenience wrapper (one block in, wire bytes out), for tests.
    ``exact=True`` uses exact-word chains; the default is the production
    hashed sort diet."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.empty(0, np.uint8)
    if block_size is None:
        block_size = max(_round_up(n, 1024), 1024)
    work = np.zeros((1, block_size), np.int32)
    work[0, :n] = data
    chains = np.asarray(encode_blocks_chain(
        work, np.array([n], np.int32), block_size, exact=exact))
    padded = np.zeros(block_size + 8, np.uint8)
    padded[:n] = data
    return chain_select_serialize(padded, 0, n, chains[0])
