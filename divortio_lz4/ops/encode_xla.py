"""LZ4 block encode — vectorized match finding + greedy parse (JAX/XLA).

The reference encoder is a byte-serial greedy hash-table scan
(/root/reference/src/block/blockCompress.js:31-232). This kernel re-derives a
decode-compatible greedy parse as data-parallel passes (SURVEY §7 / north
star): every position is a candidate, matches are exact, and the serial parse
chain is resolved by pointer doubling — the data-parallel shape of the
problem.

Pipeline (all fixed-shape jnp, one jit):

1. Window words. W[i] = LE32 at i (4 shifted adds).
2. Candidates by sorting. Sort (W, position) lexicographically; the nearest
   previous position with an IDENTICAL 4-byte word is the sort predecessor.
   Replaces the reference's 16K hash table + 4-byte verify: exhaustive (finds
   every repeat, no collisions, no skip heuristic) and sort is one fused XLA
   op. Window validity = distance < 64K checked at use.
3. Exact match lengths via fingerprint LCE. Two independent 32-bit
   polynomial rolling hashes (cumulative sums of s[j]·B^-j wrapping mod 2^32)
   give O(1) range-equality tests; binary search (log2(n) rounds, 4 gathers
   each) yields the longest common extension, clamped to the LZ4 tail rules
   (match may not cross src_end-5; candidates only at i <= src_end-12).
   The first 16 bytes are additionally verified with direct word compares,
   so a fingerprint collision can only overextend a match past 16 equal
   bytes — probability ~2^-64 per pair; see ``favor_exact`` to disable
   fingerprints entirely (caps matches at 16 bytes, guaranteed exact).
4. Greedy parse by pointer doubling. next[i] = i+len[i] (match) or i+1
   (literal); the emitted sequences are the orbit of the block start,
   materialized in log2(n) gather+scatter rounds.
5. Serialization by zone scatter. Per-sequence byte layouts (token, 0xFF-run
   lengths, literals, offset) are prefix-summed into output offsets; zone
   starts are scattered into the output byte space and forward-filled
   (cummax), then one vector pass computes every output byte. Worst-case
   bound n + n/255 + 16 (constants.block_bound).

Output is decode-compatible LZ4 (consumed bit-exactly by every decoder tier
here, the reference, and the C lz4 CLI) at a ratio ≤ the reference's (more
matches found: exhaustive candidates, exact lengths, no skip-stride misses).
It is not byte-identical to the reference encoder — the format does not
require it and the reference's stride heuristic is hostile to vectorization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, WINDOW_SIZE, block_bound

_U32 = jnp.uint32

# Two independent odd polynomial bases (random odd 32-bit constants) and
# their modular inverses mod 2^32.
_B1 = 0x9E3779B1
_B2 = 0x85EBCA77
_B1_INV = pow(_B1, -1, 1 << 32)
_B2_INV = pow(_B2, -1, 1 << 32)


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _shift_up(x: jax.Array, k: int, fill=0):
    """out[i] = x[i+k] as a contiguous slice+pad, not a gather."""
    if k == 0:
        return x
    return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])


def _pows(base: int, n: int) -> jax.Array:
    """[base^0, base^1, ..., base^(n-1)] mod 2^32 via binary exponentiation."""
    e = jnp.arange(n, dtype=_U32)
    acc = jnp.ones(n, dtype=_U32)
    sq = jnp.uint32(base)
    for k in range(_ceil_log2(n) + 1):
        bit = (e >> k) & 1
        acc = jnp.where(bit == 1, acc * sq, acc)
        sq = sq * sq
    return acc


@functools.partial(jax.jit, static_argnames=("hist_len", "use_fingerprints"))
def encode_block(work: jax.Array, src_len: jax.Array, hist_len: int = 0,
                 use_fingerprints: bool = True,
                 hist_start: jax.Array | int = 0):
    """Encode one LZ4 block.

    Args:
      work: int32[N] bytes = [history (hist_len) | payload], N static. The
        payload region is [hist_len, hist_len + src_len); bytes past src_len
        must be zero-padded (they never affect emitted sequences).
      src_len: scalar int32 — actual payload length (<= N - hist_len).
      hist_len: static history prefix length (0 for independent blocks).
      use_fingerprints: enable unbounded exact-whp match extension; when
        False matches cap at 16 bytes (direct-verified only).
      hist_start: first VALID index of the history region (history may be
        left-padded with zeros up to hist_len); candidates below it are
        poisoned so no match can reach past the real dictionary.

    Returns:
      (out, out_len): int32[block_bound(N - hist_len)] LZ4 block bytes and
      the scalar byte count.
    """
    N = work.shape[0]
    work = work.astype(jnp.int32)  # uint8 rows OK: widening runs on device
    cap = N - hist_len          # static payload capacity
    W_OUT = block_bound(cap)    # static output bound
    idx = jnp.arange(N, dtype=jnp.int32)
    take = functools.partial(jnp.take, mode="clip")

    s_end = hist_len + src_len                 # dynamic payload end
    mf_limit = s_end - MF_LIMIT
    match_limit = s_end - LAST_LITERALS

    # ---- 1. window words ----
    b = work
    w = (b + (_shift_up(b, 1) << 8) + (_shift_up(b, 2) << 16)
         + (_shift_up(b, 3) << 24)).astype(_U32)
    # Positions whose 4-byte window would cross s_end are invalid; an extra
    # leading sort key keeps them out of every candidate group without
    # colliding with real 0xFFFFFFFF words.
    invalid = ((idx + MIN_MATCH > s_end) | (idx < hist_start)
               ).astype(jnp.int32)

    # ---- 2. candidates: nearest previous identical word via sort ----
    sbad, sw, si = jax.lax.sort(
        (invalid, w, idx.astype(jnp.int32)), num_keys=3)
    same_as_prev = jnp.concatenate(
        [jnp.zeros(1, bool),
         (sw[1:] == sw[:-1]) & (sbad[1:] == 0) & (sbad[:-1] == 0)])
    prev_in_sort = jnp.concatenate([jnp.zeros(1, jnp.int32), si[:-1]])
    cand_sorted = jnp.where(same_as_prev, prev_in_sort, -1)
    # Unsort via a second sort (si is a permutation) — see
    # hybrid_encode._cand_row.
    cand = jax.lax.sort((si.astype(_U32), cand_sorted), num_keys=1)[1]

    dist = idx - cand
    has_cand = (cand >= 0) & (dist < WINDOW_SIZE) & (idx >= hist_len) \
        & (idx < mf_limit)

    # ---- 3. exact match lengths ----
    a = idx                      # match position
    c = jnp.maximum(cand, 0)     # candidate position (clipped for gathers)

    # Direct verification of the first 16 bytes, 4 words at a time. The
    # a-side reads are fixed shifts; only the candidate side gathers.
    def words_eq(off):
        return _shift_up(w, off) == take(w, c + off)

    eq4 = words_eq(4)
    eq8 = words_eq(8)
    eq12 = words_eq(12)
    # Exact length within [4, 20) from word compares + byte refinement at the
    # first differing word.
    first_bad_word = jnp.where(~eq4, 4, jnp.where(~eq8, 8,
                               jnp.where(~eq12, 12, 16)))
    xor_w = take(w, a + first_bad_word) ^ take(w, c + first_bad_word)
    byte_eq = jnp.where(
        xor_w == 0, 4,
        jnp.where((xor_w & 0xFF) != 0, 0,
                  jnp.where((xor_w & 0xFF00) != 0, 1,
                            jnp.where((xor_w & 0xFF0000) != 0, 2, 3))))
    direct_len = first_bad_word + byte_eq  # in [4, 20]

    if use_fingerprints:
        # Fingerprint LCE binary search over positions that cleared 16
        # direct-verified bytes. ONE 32-bit rolling hash drives the search
        # (2 gathers/round); the result is then verified with an exact
        # 4-byte end-window compare — a search-time collision over-extends
        # the candidate length, the end bytes then mismatch, and the lane
        # falls back to its direct length. A silent error needs a hash
        # collision AND a coincidental end-window match (~2^-60 per block).
        inv1 = _pows(_B1_INV, N + 1)
        pw1 = _pows(_B1, N + 1)
        bu = b.astype(_U32)
        c1 = jnp.concatenate([jnp.zeros(1, _U32),
                              jnp.cumsum(bu * inv1[:N], dtype=_U32)])

        # CAP must stay N: sub-N compaction truncates MEDIUM (20-100B)
        # matches wherever the needy set overflows, measurably hurting the
        # ratio gate (inheritance below only rescues run-like data, whose
        # lengths decay by exactly 1 per position). Early-exit still
        # collapses the search when long matches are absent.
        CAP = N
        need = has_cand & (direct_len >= 16)
        slot_raw = jnp.cumsum(need.astype(jnp.int32)) - need.astype(jnp.int32)
        in_set = need & (slot_raw < CAP)
        slot = jnp.where(in_set, slot_raw, CAP)  # CAP row = scatter drop

        ca = jnp.zeros(CAP + 1, jnp.int32).at[slot].set(a, mode="drop")[:CAP]
        cc = jnp.zeros(CAP + 1, jnp.int32).at[slot].set(c, mode="drop")[:CAP]

        pw1_a = take(pw1, ca)
        pw1_c = take(pw1, cc)
        c1_a = take(c1, ca)
        c1_c = take(c1, cc)

        def range_eq(length):
            """Prefix fingerprint equality of work[ca:+len) vs work[cc:+len)."""
            f1a = (take(c1, ca + length) - c1_a) * pw1_a
            f1c = (take(c1, cc + length) - c1_c) * pw1_c
            return f1a == f1c

        # Binary search on the largest equal prefix in [16, max_ext]; stops
        # as soon as every lane converges (all-short-matches blocks finish
        # in a couple of rounds).
        max_ext = jnp.maximum(match_limit - ca, 0)
        used = jnp.arange(CAP, dtype=jnp.int32) < jnp.sum(
            in_set.astype(jnp.int32))
        lo0 = jnp.full(CAP, 16, jnp.int32)
        hi0 = jnp.where(used, jnp.maximum(max_ext + 1, lo0), lo0)

        def bs_cond(st):
            lo, hi, rounds = st
            return jnp.any(hi > lo + 1) & (rounds < _ceil_log2(cap) + 2)

        def bs_round(st):
            lo, hi, rounds = st
            mid = jnp.clip((lo + hi) >> 1, lo, jnp.maximum(hi - 1, lo))
            ok = range_eq(mid) & (mid > lo)
            return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid),
                    rounds + 1)

        lo, _, _ = jax.lax.while_loop(bs_cond, bs_round,
                                      (lo0, hi0, jnp.int32(0)))
        # Exact end verification: the last 4 bytes of the claimed common
        # prefix must match for real. On failure the search was poisoned by
        # a collision — fall back to the direct-verified 16..20 bytes.
        end_ok = take(w, ca + lo - 4) == take(w, cc + lo - 4)
        lo = jnp.where(end_ok | (lo <= 16), lo, 16)
        fp_full = take(lo, jnp.clip(slot_raw, 0, CAP - 1))
        own_len = jnp.where(in_set, jnp.maximum(fp_full, 16), direct_len)

        # Match INHERITANCE: if position j < i was LCE-extended to length
        # L_j at offset d_j, then position i has a guaranteed match of
        # length L_j - (i-j) at the SAME offset (a substring of j's match).
        # This restores full-length matches for positions the compaction
        # skipped — including every position inside long runs — without any
        # additional search. (L and d of the previous extended position are
        # fetched via one cummax + two gathers.)
        pis = jax.lax.cummax(jnp.where(in_set, idx, -1), axis=0)
        pis_c = jnp.clip(pis, 0, N - 1)
        inh_len = take(own_len, pis_c) - (idx - pis_c)
        inh_d = take(dist, pis_c)
        inh_ok = ((pis >= 0) & (inh_len >= MIN_MATCH)
                  & (idx >= hist_len) & (idx < mf_limit))

        use_inh = inh_ok & (inh_len > jnp.where(has_cand, own_len, 0))
        raw_len = jnp.where(use_inh, inh_len, own_len)
        dist = jnp.where(use_inh, inh_d, dist)
        has_match = has_cand | use_inh
    else:
        raw_len = direct_len
        has_match = has_cand

    mlen = jnp.minimum(raw_len, jnp.maximum(match_limit - a, 0))
    good = has_match & (mlen >= MIN_MATCH)
    mlen = jnp.where(good, mlen, 0)

    # ---- 4. greedy parse via anchor-chain doubling ----
    # An anchor is a sequence start (its literal run + the following match).
    # nm[i] = nearest match position >= i (reverse cummin): the chain
    # next_anchor = nm[a] + mlen[nm[a]] hops once per SEQUENCE, so pointer
    # doubling needs ~log2(#sequences) rounds — not log2(path length) as a
    # unit-step literal walk would.
    nm = jax.lax.cummin(jnp.where(good, idx, N), axis=0, reverse=True)
    nm_c = jnp.minimum(nm, N - 1)
    m_len_at = take(mlen, nm_c)
    terminal = nm >= N  # no further match: tail literals to s_end
    nxt = jnp.where(terminal, idx, nm_c + m_len_at)
    nxt = jnp.minimum(nxt, N - 1)
    nxt = jnp.where(idx >= s_end, idx, nxt)

    reach0 = ((idx == hist_len) & (src_len > 0)).astype(jnp.int32)

    def orbit_cond(st):
        _, _, changed, rounds = st
        return changed & (rounds < _ceil_log2(N) + 1)

    def orbit_round(st):
        reach, jump, _, rounds = st
        prop = jnp.zeros(N, jnp.int32).at[jump].max(reach, mode="drop")
        new_reach = jnp.maximum(reach, prop)
        changed = jnp.sum(new_reach) > jnp.sum(reach)
        return new_reach, take(jump, jump), changed, rounds + 1

    reach, _, _, _ = jax.lax.while_loop(
        orbit_cond, orbit_round, (reach0, nxt, jnp.bool_(True), jnp.int32(0)))
    anchor = (reach > 0) & (idx >= hist_len) & (idx < s_end)
    emit_match = anchor & (~terminal)   # anchors with a following match
    emit_tail = anchor & terminal       # exactly one: the final literal run

    # ---- 5. serialization ----
    # Per emitted sequence (anchored at a): literals work[a: nm[a]), then
    # the match at nm[a].
    lit_before = jnp.where(emit_match, nm_c - idx, 0)
    mcode_at = jnp.where(emit_match, m_len_at - MIN_MATCH, 0)
    offs = jnp.where(emit_match, take(dist, nm_c), 0)
    tail_lit = jnp.sum(jnp.where(emit_tail, s_end - idx, 0))
    last_end = jnp.sum(jnp.where(emit_tail, idx, 0))  # tail literal source

    # Per-sequence encoded sizes.
    def ext_bytes(v):
        return jnp.where(v < 15, 0, 1 + jnp.maximum(v - 15, 0) // 255)

    lcode = lit_before
    mcode = mcode_at
    seq_size = jnp.where(
        emit_match,
        1 + ext_bytes(lcode) + lcode + 2 + ext_bytes(mcode),
        0)
    seq_start = jnp.cumsum(seq_size) - seq_size
    body = jnp.sum(seq_size)
    # Tail sequence: token + ext + literals.
    tail_size = 1 + ext_bytes(tail_lit) + tail_lit
    out_len = jnp.where(src_len > 0, body + tail_size, 0)

    # Zone scatter into the output byte space.
    jW = jnp.arange(W_OUT, dtype=jnp.int32)
    drop = W_OUT

    tok_pos = jnp.where(emit_match, seq_start, drop)
    litx_pos = jnp.where(emit_match & (lcode >= 15), seq_start + 1, drop)
    lits_pos = jnp.where(emit_match & (lcode > 0),
                         seq_start + 1 + ext_bytes(lcode), drop)
    off_pos = jnp.where(emit_match,
                        seq_start + 1 + ext_bytes(lcode) + lcode, drop)
    mx_pos = jnp.where(emit_match & (mcode >= 15),
                       seq_start + 1 + ext_bytes(lcode) + lcode + 2, drop)

    token_val = (jnp.minimum(lcode, 15) << 4) | jnp.minimum(mcode, 15)

    # Tail zones (scalars → scatter via 1-element updates).
    tail_tok = body
    tail_litx = body + 1
    tail_lits = body + 1 + ext_bytes(tail_lit)
    tail_tokval = jnp.minimum(tail_lit, 15) << 4

    # Zone tag + per-zone payload packed into ONE i32 per byte position:
    # pack = tag<<28 | payload. tag codes: 1 token (payload=token byte),
    # 2 lit-ext / 5 match-ext (payload = extbytes<<8 | remainder),
    # 3 literals (payload = source start), 4 offset (payload = offset).
    def ext_payload(code):
        return (ext_bytes(code) << 8) | (jnp.maximum(code - 15, 0) % 255)

    pk = (jnp.zeros(W_OUT, jnp.int32)
          .at[tok_pos].set((1 << 28) | token_val, mode="drop")
          .at[litx_pos].set((2 << 28) | ext_payload(lcode), mode="drop")
          .at[lits_pos].set((3 << 28) | idx, mode="drop")
          .at[off_pos].set((4 << 28) | offs, mode="drop")
          .at[mx_pos].set((5 << 28) | ext_payload(mcode), mode="drop")
          .at[jnp.where(src_len > 0, tail_tok, drop)].set(
              (1 << 28) | tail_tokval, mode="drop")
          .at[jnp.where(tail_lit >= 15, tail_litx, drop)].set(
              (2 << 28) | ext_payload(tail_lit), mode="drop")
          .at[jnp.where(tail_lit > 0, tail_lits, drop)].set(
              (3 << 28) | last_end, mode="drop"))

    marker = jnp.where(pk > 0, jW, -1)
    fill = jnp.clip(jax.lax.cummax(marker, axis=0), 0, W_OUT - 1)
    pk_f = jnp.take(pk, fill)
    tag_f = pk_f >> 28
    a_f = pk_f & ((1 << 28) - 1)
    rel = jW - fill  # offset within the zone

    ext_val = jnp.where(rel < (a_f >> 8) - 1, 255, a_f & 0xFF)
    lit_val = take(work, a_f + rel)                        # literal gather
    off_val = jnp.where(rel == 0, a_f & 0xFF, (a_f >> 8) & 0xFF)

    out = jnp.where(tag_f == 1, a_f,
          jnp.where(tag_f == 2, ext_val,
          jnp.where(tag_f == 3, lit_val,
          jnp.where(tag_f == 4, off_val,
          jnp.where(tag_f == 5, ext_val, 0)))))
    out = jnp.where(jW < out_len, out, 0)
    return out, out_len


encode_blocks_batch = jax.jit(
    jax.vmap(encode_block, in_axes=(0, 0, None, None, 0)),
    static_argnames=("hist_len", "use_fingerprints"),
)


def _bucket(n: int, floor: int = 1024) -> int:
    """Round up to a power of two so jit compile caches stay warm."""
    b = floor
    while b < n:
        b <<= 1
    return b


def encode_block_host(data: np.ndarray, history: np.ndarray | None = None,
                      use_fingerprints: bool = True) -> np.ndarray:
    """Convenience host wrapper: numpy bytes in → LZ4 block bytes out.

    Pads the payload to a power-of-two bucket (src_len stays dynamic) so
    repeated calls at nearby sizes reuse the compiled kernel. History is
    padded to the full 64 KB window for the same reason.
    """
    real_hist = (np.asarray(history, dtype=np.uint8)[-WINDOW_SIZE:]
                 if history is not None else np.zeros(0, dtype=np.uint8))
    hist_len = WINDOW_SIZE if len(real_hist) > 0 else 0
    hist_start = hist_len - len(real_hist)  # first valid (non-pad) index
    n = len(data)
    cap = _bucket(n)
    work = np.zeros(hist_len + cap, dtype=np.uint8)
    if hist_len:
        work[hist_start:hist_len] = real_hist  # right-aligned in the window
    work[hist_len: hist_len + n] = data
    out, out_len = encode_block(jnp.asarray(work.astype(np.int32)),
                                jnp.int32(n), hist_len, use_fingerprints,
                                jnp.int32(hist_start))
    return np.asarray(out[: int(out_len)], dtype=np.int64).astype(np.uint8)
