"""LZ4 block decode — two-phase, fully vectorized (JAX/XLA).

The reference decoder is a byte-serial sequence interpreter
(/root/reference/src/block/blockDecompress.js:55-272). An accelerator has
wide vector units and no fast scalar byte loop, so this kernel re-derives the
SAME wire semantics as data-parallel passes (SURVEY §7 Phase 1, "two-phase
decode"):

Phase A — token-graph parse.
  For EVERY input byte position i, speculatively compute "if a sequence
  started here": literal length (with 0xFF-run extension), offset, match
  length, and the position of the next sequence. 0xFF-run lengths come from
  one reverse cumulative-min pass. The true sequence starts are the orbit of
  position 0 under the next() map, materialized by pointer doubling
  (log2(M) rounds of gather+scatter) — no data-dependent loop.

Phase B — source-chasing copy.
  Each output byte's provenance is either a literal (input index) or a match
  back-pointer (output index j-offset, possibly negative into the history
  window). Back-pointer chains (overlaps, RLE) are resolved by pointer
  doubling in log2(B) gather rounds, then one final gather materializes the
  bytes. This replaces the reference's overlap-aware copy loops
  (blockDecompress.js:204-268) with O(log) vector passes.

Exactness: bit-exact output for any valid LZ4 block, including dictionary
back-references and matches spanning history into output. Invalid input is
NOT diagnosed on device (indices clip); validate frames on host or via
checksums before device decode.

Shapes are static: comp padded to M, history right-aligned in a 64 KB
buffer, output padded to B. Batch via jax.vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import WINDOW_SIZE


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _shift_up(x: jax.Array, k: int, fill=0):
    """x shifted so out[i] = x[i+k] — a contiguous slice+pad, NOT a gather.

    XLA lowers jnp.take(x, arange+k) to a general gather; this form is a
    copy.
    """
    if k == 0:
        return x
    return jnp.concatenate(
        [x[k:], jnp.full((k,), fill, x.dtype)])


@functools.partial(jax.jit, static_argnames=("out_cap",))
def decode_block(comp: jax.Array, comp_len: jax.Array, hist: jax.Array,
                 out_cap: int):
    """Decode one LZ4 block.

    Args:
      comp: int32[M] compressed bytes (0..255), padded arbitrarily past
        comp_len. M is static.
      comp_len: scalar int32, actual compressed size.
      hist: int32[WINDOW_SIZE] history window, RIGHT-aligned (hist[-k] is the
        byte k back from the block start); zeros when no history.
      out_cap: static output capacity (the frame's block size).

    Returns:
      (out, out_len): int32[out_cap] decoded bytes and the scalar count.
    """
    M = comp.shape[0]
    comp = comp.astype(jnp.int32)  # uint8 OK: widening runs on device
    hist = hist.astype(jnp.int32)
    B = out_cap
    idx = jnp.arange(M, dtype=jnp.int32)

    take = functools.partial(jnp.take, mode="clip")

    # ---- Phase A: speculative per-position sequence parse ----
    # Run-length of consecutive 0xFF bytes starting at each position, via the
    # next-non-0xFF index (reverse cumulative min).
    non_ff_pos = jnp.where(comp != 255, idx, M)
    next_non_ff = jax.lax.cummin(non_ff_pos, axis=0, reverse=True)
    r255 = next_non_ff - idx  # #consecutive 0xFF at idx

    tok = comp
    lit_nib = tok >> 4
    match_nib = tok & 0x0F

    r_l = _shift_up(r255, 1)
    has_lit_ext = lit_nib == 15
    ext_l = jnp.where(has_lit_ext, r_l + 1, 0)
    lit_len = lit_nib + jnp.where(
        has_lit_ext, 255 * r_l + take(comp, idx + 1 + r_l), 0)
    lit_start = idx + 1 + ext_l
    after_lit = lit_start + lit_len
    terminal = after_lit >= comp_len

    # Offsets are 2-byte LE; pre-combining into u16 lanes halves the gather.
    comp16 = comp + (_shift_up(comp, 1) << 8)
    offset = take(comp16, after_lit)
    mes = after_lit + 2
    r_m = take(r255, mes)
    has_m_ext = match_nib == 15
    ext_m = jnp.where(has_m_ext, r_m + 1, 0)
    match_len = 4 + match_nib + jnp.where(
        has_m_ext, 255 * r_m + take(comp, mes + r_m), 0)

    nxt = jnp.where(terminal, idx, mes + ext_m)
    nxt = jnp.clip(nxt, 0, M - 1)
    nxt = jnp.where(idx >= comp_len, idx, nxt)

    # Orbit of position 0 under nxt(): pointer doubling with reachability
    # scatter. After round k, reach = positions reachable in < 2^k steps.
    # A while_loop stops as soon as a round adds nothing new — the typical
    # sequence chain is much shorter than M, so this converges in
    # ~log2(#sequences) rounds rather than the worst-case log2(M).
    reach0 = ((idx == 0) & (comp_len > 0)).astype(jnp.int32)

    def orbit_cond(st):
        _, _, changed, rounds = st
        return changed & (rounds < _ceil_log2(M) + 1)

    def orbit_round(st):
        reach, jump, _, rounds = st
        prop = jnp.zeros(M, jnp.int32).at[jump].max(reach, mode="drop")
        new_reach = jnp.maximum(reach, prop)
        changed = jnp.sum(new_reach) > jnp.sum(reach)
        jump = take(jump, jump)
        return new_reach, jump, changed, rounds + 1

    reach, _, _, _ = jax.lax.while_loop(
        orbit_cond, orbit_round,
        (reach0, nxt, jnp.bool_(True), jnp.int32(0)))
    is_seq = (reach > 0) & (idx < comp_len)

    out_adv = jnp.where(
        is_seq, lit_len + jnp.where(terminal, 0, match_len), 0)
    out_pos = jnp.cumsum(out_adv) - out_adv  # exclusive prefix
    out_len = jnp.sum(out_adv)

    # ---- Phase B: provenance map over output bytes ----
    jB = jnp.arange(B, dtype=jnp.int32)
    drop = B  # out-of-range scatter target (mode="drop")

    lit_zone = jnp.where(is_seq & (lit_len > 0), out_pos, drop)
    mat_zone = jnp.where(is_seq & (~terminal), out_pos + lit_len, drop)

    # Zone tag and per-zone constant packed into ONE scatter + ONE fill
    # gather: pack = tag<<28 | (cval + 2^26); cval spans (-B, M] ⊂ ±2^25.
    BIAS = 1 << 26
    pack = (jnp.zeros(B, jnp.int32)
            .at[lit_zone].set((1 << 28) | (lit_start - out_pos + BIAS),
                              mode="drop")
            .at[mat_zone].set((2 << 28) | (BIAS - offset), mode="drop"))

    marker = jnp.where(pack > 0, jB, -1)
    fill = jax.lax.cummax(marker, axis=0)
    fill_c = jnp.clip(fill, 0, B - 1)
    pack_f = take(pack, fill_c)
    tag_f = pack_f >> 28
    c_f = (pack_f & ((1 << 28) - 1)) - BIAS

    # Back-pointer graph: literals are fixpoints; match bytes point j-offset
    # (negative = history). hist is right-aligned so index = WINDOW + g.
    g = jnp.where(tag_f == 1, jB, jB + c_f)

    # Chase to fixpoint: a byte is resolved when it maps to a literal
    # (g2 == g) or into history (g < 0). Converges in log2(max chain depth)
    # rounds — typically 3-6, worst _ceil_log2(B).
    def chase_cond(st):
        g, changed, rounds = st
        return changed & (rounds < _ceil_log2(B) + 1)

    def chase_round(st):
        g, _, rounds = st
        g2 = take(g, jnp.clip(g, 0, B - 1))
        g_new = jnp.where(g < 0, g, g2)
        return g_new, jnp.any(g_new != g), rounds + 1

    g, _, _ = jax.lax.while_loop(
        chase_cond, chase_round, (g, jnp.bool_(True), jnp.int32(0)))

    # Input index of each output byte's originating literal.
    lit_in_idx = jB + c_f  # valid only where tag_f == 1
    src_in = take(lit_in_idx, jnp.clip(g, 0, B - 1))
    from_hist = take(hist, jnp.clip(WINDOW_SIZE + g, 0, WINDOW_SIZE - 1))
    out = jnp.where(g >= 0, take(comp, src_in), from_hist)
    out = jnp.where(jB < out_len, out, 0)
    return out, out_len


# Batched variant: decode many independent blocks at once.
decode_blocks_batch = jax.jit(
    jax.vmap(decode_block, in_axes=(0, 0, 0, None)),
    static_argnames=("out_cap",),
)


def _bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def decode_block_host(comp_bytes: np.ndarray, out_cap: int,
                      history: np.ndarray | None = None) -> np.ndarray:
    """Convenience host wrapper: numpy bytes in → numpy bytes out.

    Pads the compressed input to a power-of-two bucket (comp_len stays
    dynamic) so repeated calls reuse the compiled kernel.
    """
    m = len(comp_bytes)
    comp = np.zeros(_bucket(m), dtype=np.int32)
    comp[:m] = comp_bytes
    hist = np.zeros(WINDOW_SIZE, dtype=np.int32)
    if history is not None and len(history) > 0:
        h = history[-WINDOW_SIZE:]
        hist[WINDOW_SIZE - len(h):] = h
    out, out_len = decode_block(jnp.asarray(comp), jnp.int32(m),
                                jnp.asarray(hist), out_cap)
    return np.asarray(out[: int(out_len)], dtype=np.int64).astype(np.uint8)
