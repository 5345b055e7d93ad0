"""Device candidate search for the chain-direct encoder (ops/split_encode).

For every position of a block, the best previous occurrence of the same
4-byte window, found by one lexicographic sort with prefix-fingerprint
scores carried through it — the reference's hash-table match finder
(/root/reference/src/block/blockCompress.js:53-63) made exact and
data-parallel. The host then greedy-selects, exactly extends and
serializes (lz4t_chain_serialize16).

Greedy semantics match blockCompress.js: matches start below
src_len - MF_LIMIT, end below src_len - LAST_LITERALS, minimum length 4,
offsets < 64 KB; history rows ([dict window | payload], hist_len static)
give dictionary and linked-mode frames for free. Output is
decode-compatible LZ4 at a ratio <= the reference encoder's on every corpus
measured (the adversarial ratio gates in tests/ pin the known traps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import MF_LIMIT, MIN_MATCH, WINDOW_SIZE


def _cand_row(work: jax.Array, src_len: jax.Array, hist_len: int,
              hist_start: jax.Array, hashed: bool = False):
    """Shared candidate search (the sort phase): for every position, the
    scored best previous same-word occurrence. Returns (valid bool[N],
    dist i32[N]) over [history | payload] positions — _dist_row slices
    the payload range.

    Two key layouts:

    - ``hashed=False``: 3 sorted operands
      ``(word, bad|interior|idx|fp13, scoreAB)`` with num_keys=2 — EXACT
      word buckets, so a selected candidate's first MIN_MATCH bytes are
      equal by construction.

    - ``hashed=True`` (the production sort diet): the
      word is HASHED into the single sort key
      ``hash << (ibits+2) | bad | interior | idx`` and the scoring tiers
      pack into ONE u32 payload — 2 sorted operands, num_keys=1, ~8
      sorted bytes/position instead of 12. This is the data-parallel form
      of the reference's 16K hash table WITH its collision exposure
      (blockCompress.js:13-17,64-66): a different word can share a bucket,
      so candidates are claims, not guarantees — the host serializer
      verifies 4 bytes and skips false candidates
      (lz4t_chain_serialize16). An extra 8-bit word-check in the payload
      keeps the false-claim rate ~2^-22 per pred, so incompressible data
      doesn't flood the host scan. Bucket counts: 64 KB independent
      blocks get 2^14 buckets (the reference's own geometry), history
      rows 2^13.
    """
    N = work.shape[0]
    assert N <= (1 << 17), "idx2 packs positions in 17 bits"
    idx = jnp.arange(N, dtype=jnp.int32)
    s_end = hist_len + src_len
    mf_limit = s_end - MF_LIMIT

    b = work
    w = (b + (jnp.concatenate([b[1:], jnp.zeros(1, b.dtype)]) << 8)
         + (jnp.concatenate([b[2:], jnp.zeros(2, b.dtype)]) << 16)
         + (jnp.concatenate([b[3:], jnp.zeros(3, b.dtype)]) << 24)
         ).astype(jnp.uint32)
    invalid = (idx + MIN_MATCH > s_end) | (idx < hist_start)

    # Prefix-fingerprint scoring: h_d[p] hashes the WHOLE range [p, p+d)
    # (polynomial rolling hash, the encode_xla.py LCE machinery), so a
    # candidate's sampled LCE is the longest d with equal fingerprints —
    # contiguous coverage, no blind spots (word samples at sparse offsets
    # missed single-byte mutations between samples; measured on the
    # period-53 trap corpus). Carried through the sort, never gathered.
    # Equality with the zero padding past s_end only affects scores of
    # tail positions the walk clamps anyway.
    from .encode_xla import _B1, _B1_INV, _pows
    inv1 = _pows(_B1_INV, N + 1)
    pw1 = _pows(_B1, N + 1)
    c1 = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                          jnp.cumsum(b.astype(jnp.uint32) * inv1[:N],
                                     dtype=jnp.uint32)])

    def _range_hash(d):
        hi = jnp.concatenate([c1[d:], jnp.zeros(max(d - 1, 0), jnp.uint32)])
        return (hi[:N] - c1[:N]) * pw1[:N]

    # Each tier hash-combines two prefix ranges (d/2 and d) — coarse tiers
    # (16/64/256) still discriminate the period-53 mutation trap: the
    # winning source's first divergence sits a full tier further out.
    def _tier(d):
        return _range_hash(d // 2) * jnp.uint32(0x9E3779B1) + _range_hash(d)

    t16, t64, t256 = _tier(16), _tier(64), _tier(256)

    # Run-interior positions (word repeats within 4 bytes) are POISON
    # sources for anything but in-run anchors: their extensions die at the
    # run boundary, while the run START's extension propagates through the
    # whole periodic region — measured 55x worse ratio on period-53 data
    # with nearest-any candidates (docs/DESIGN.md). The idx2 interior bit
    # hides them from non-interior receivers while keeping them nearest-
    # ordered for in-run anchors (any in-run distance extends to the run
    # end, so nearest wins there).
    interior = jnp.zeros(N, bool)
    for p in (1, 2, 3, 4):
        interior = interior.at[p:].set(interior[p:] | (w[p:] == w[:-p]))

    def shifted(a, k, fill=0):
        return jnp.concatenate(
            [jnp.full(k, fill, a.dtype), a[:-k]])

    # Which sort-predecessors to score: the nearest previous occurrence is
    # NOT always the best source — on mutated-periodic data the reference's
    # stale 16K table lands on mutation-phase-aligned sources whose matches
    # extend THROUGH the mutations (measured 1.34x worse than the reference
    # with nearest-only on period-53 + mutation-every-200 corpora — the
    # adversarial ratio gate in tests/test_hybrid_encode.py pins this).
    PREDS = (1, 2, 3, 4, 6, 8)
    best_key = jnp.full(N, -1, jnp.int32)
    best_cand = jnp.full(N, -1, jnp.int32)

    if hashed:
        ibits = (N - 1).bit_length()
        hbits = 30 - ibits
        mask = jnp.uint32((1 << ibits) - 1)
        wc8 = (w * jnp.uint32(0x85EBCA77)) >> 24           # word check
        fp16 = (t16 * jnp.uint32(0x9E3779B1)) >> 23        # 9-bit tier 16
        fp64 = (t64 * jnp.uint32(0x85EBCA77)) >> 24        # 8-bit tier 64
        fp256 = (t256 * jnp.uint32(0xC2B2AE3D)) >> 25      # 7-bit tier 256
        pay = (wc8 << 24) | (fp16 << 15) | (fp64 << 7) | fp256
        h = (w * jnp.uint32(0x9E3779B1)) >> (32 - hbits)
        key = ((h << (ibits + 2))
               | jnp.where(invalid,
                           jnp.uint32(1) << (ibits + 1), jnp.uint32(0))
               | jnp.where(interior, jnp.uint32(1) << ibits, jnp.uint32(0))
               | idx.astype(jnp.uint32))

        skey, spay = jax.lax.sort((key, pay), num_keys=1)
        si = (skey & mask).astype(jnp.int32)
        for k in PREDS:
            pkey = shifted(skey, k, fill=0xFFFFFFFF)
            ppay = shifted(spay, k)
            pi = (pkey & mask).astype(jnp.int32)
            pgood = ((pkey >> (ibits + 1)) & 1) == 0
            bucket = (pkey >> (ibits + 2)) == (skey >> (ibits + 2))
            wc_eq = (ppay >> 24) == (spay >> 24)
            dist = si - pi
            ok = pgood & bucket & wc_eq & (dist > 0) & (dist < WINDOW_SIZE)
            # approximate LCE: longest run of equal fingerprint tiers
            m16 = ok & (((ppay >> 15) & 0x1FF) == ((spay >> 15) & 0x1FF))
            m64 = m16 & (((ppay >> 7) & 0xFF) == ((spay >> 7) & 0xFF))
            m256 = m64 & ((ppay & 0x7F) == (spay & 0x7F))
            sc = (4 + jnp.where(m16, 16, 0) + jnp.where(m64, 64, 0)
                  + jnp.where(m256, 256, 0))
            keysc = jnp.where(ok, sc * 16 + (15 - k), -1)
            better = keysc > best_key
            best_key = jnp.where(better, keysc, best_key)
            best_cand = jnp.where(better, pi, best_cand)
    else:
        fp13 = (t16 * jnp.uint32(0x85EBCA77)) >> 19         # 13-bit tier 16
        sAB = (t64 & jnp.uint32(0xFFFF0000)) | (t256 >> 16)  # 16+16 payload
        idx2 = (jnp.where(invalid, jnp.uint32(1) << 31, jnp.uint32(0))
                | jnp.where(interior, jnp.uint32(1) << 30, jnp.uint32(0))
                | (idx.astype(jnp.uint32) << 13) | fp13)

        sw, si2, ssAB = jax.lax.sort((w, idx2, sAB), num_keys=2)
        si = ((si2 >> 13) & jnp.uint32(0x1FFFF)).astype(jnp.int32)
        for k in PREDS:
            # Shift fill has the bad bit set: slots before the first k
            # entries can never take a padding candidate.
            pi2 = shifted(si2, k, fill=0xFFFFFFFF)
            pw = shifted(sw, k)
            pi = ((pi2 >> 13) & jnp.uint32(0x1FFFF)).astype(jnp.int32)
            pgood = pi2 < (jnp.uint32(1) << 31)
            dist = si - pi
            ok = pgood & (pw == sw) & (dist > 0) & (dist < WINDOW_SIZE)
            # approximate LCE: longest run of equal fingerprint tiers
            m16 = (pi2 & jnp.uint32(0x1FFF)) == (si2 & jnp.uint32(0x1FFF))
            psAB = shifted(ssAB, k)
            m64 = m16 & ((psAB >> 16) == (ssAB >> 16))
            m256 = m64 & ((psAB & jnp.uint32(0xFFFF))
                          == (ssAB & jnp.uint32(0xFFFF)))
            sc = (4 + jnp.where(m16, 16, 0) + jnp.where(m64, 64, 0)
                  + jnp.where(m256, 256, 0))
            key = jnp.where(ok, sc * 16 + (15 - k), -1)
            better = key > best_key
            best_key = jnp.where(better, key, best_key)
            best_cand = jnp.where(better, pi, best_cand)
    # Unsort via a second sort: si is a permutation of 0..N-1, so sorting
    # on si restores position order (a scatter .at[si].set is the
    # alternative; which is faster on the GPU is not measured).
    recv_ok = (idx >= hist_len) & (idx < mf_limit)
    if N <= (1 << 16):
        # si and dist both fit 16 bits (the preds loop enforces
        # 0 < dist < WINDOW_SIZE): pack them into ONE sorted operand.
        dist_s = jnp.where(best_cand >= 0, (si - best_cand), 0)
        packed = (si.astype(jnp.uint32) << 16) | dist_s.astype(jnp.uint32)
        dist = (jax.lax.sort(packed) & jnp.uint32(0xFFFF)) \
            .astype(jnp.int32)
        return (dist > 0) & recv_ok, dist
    cand = jax.lax.sort((si.astype(jnp.uint32), best_cand), num_keys=1)[1]
    valid = (cand >= 0) & (idx - cand < WINDOW_SIZE) & recv_ok
    return valid, idx - cand


def _dist_row(work: jax.Array, src_len: jax.Array, hist_len: int,
              hist_start: jax.Array, hashed: bool = False) -> jax.Array:
    """u16 per-position match distance for one block row (0 = no match).

    The host serializer (lz4t_chain_serialize16) finds the next
    matchable position by scanning for the next nonzero distance — an
    SIMD-friendly memchr-class pass — so the fetch ships 2 bytes per
    position. With
    ``hashed`` the sort runs the dieted single-key layout and entries are
    CLAIMS the serializer verifies (see ``_cand_row``)."""
    valid, dist = _cand_row(work, src_len, hist_len, hist_start, hashed)
    return jnp.where(valid[hist_len:], dist[hist_len:], 0).astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("hist_len", "hashed"))
def build_dist_chains(work: jax.Array, lens: jax.Array, hist_len: int,
                      hist_start: jax.Array,
                      hashed: bool = True) -> jax.Array:
    """Vmapped u16 dist-only chains: i32[nb, N] work -> u16[nb, cap].

    The chain-direct (split) encode's wire format; the host serializer
    scans for the next nonzero distance (lz4t_chain_serialize16). Default
    ``hashed=True`` runs the sort diet (2 sorted operands, hashed buckets
    — see ``_cand_row``); entries are claims the serializer's 4-byte
    verify filters. ``hashed=False`` gives exact-word chains."""
    hs = jnp.broadcast_to(jnp.asarray(hist_start, jnp.int32),
                          (work.shape[0],))
    return jax.vmap(
        functools.partial(_dist_row, hashed=hashed),
        in_axes=(0, 0, None, 0))(work, lens, hist_len, hs)


def hybrid_max_bs() -> int:
    """Largest block size the chain encoder takes directly: chains hold
    payload positions as u16, so payloads stay within 64 KB (the largest
    LZ4 block-size tier below 256 KB). Larger blocks are encoded as 64 KB
    segments (parallel/bigblock.py)."""
    return WINDOW_SIZE
