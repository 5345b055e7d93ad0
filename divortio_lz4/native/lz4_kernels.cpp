// Native host kernels for divortio_lz4.
//
// C++ implementations of the LZ4 block codec and xxHash32 with the exact
// semantics of the Python oracle (ops/block_ref.py), which in turn matches
// the reference encoder's greedy parse + acceleration heuristic
// (/root/reference/src/block/blockCompress.js) so compressed output is
// byte-identical across tiers. These are the production HOST path — staging,
// CLI-grade interop, and the data loader for the device path; device compute
// is JAX/XLA/Pallas.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash32
// ---------------------------------------------------------------------------

static const uint32_t P1 = 2654435761u;
static const uint32_t P2 = 2246822519u;
static const uint32_t P3 = 3266489917u;
static const uint32_t P4 = 668265263u;
static const uint32_t P5 = 374761393u;

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t xxh_round(uint32_t acc, uint32_t lane) {
  acc += lane * P2;
  return rotl32(acc, 13) * P1;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/ARM LE)
  return v;
}

uint32_t lz4t_xxhash32(const uint8_t* buf, int64_t len, uint32_t seed) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  uint32_t h32;
  if (len >= 16) {
    const uint8_t* limit = end - 16;
    uint32_t v1 = seed + P1 + P2;
    uint32_t v2 = seed + P2;
    uint32_t v3 = seed;
    uint32_t v4 = seed - P1;
    do {
      v1 = xxh_round(v1, read32(p));
      v2 = xxh_round(v2, read32(p + 4));
      v3 = xxh_round(v3, read32(p + 8));
      v4 = xxh_round(v4, read32(p + 12));
      p += 16;
    } while (p <= limit);
    h32 = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h32 = seed + P5;
  }
  h32 += (uint32_t)len;
  while (p + 4 <= end) {
    h32 += read32(p) * P3;
    h32 = rotl32(h32, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h32 += (*p) * P5;
    h32 = rotl32(h32, 11) * P1;
    p += 1;
  }
  h32 ^= h32 >> 15;
  h32 *= P2;
  h32 ^= h32 >> 13;
  h32 *= P3;
  h32 ^= h32 >> 16;
  return h32;
}

// Bulk stripe processing for the streaming hasher: consumes nwords/4 full
// stripes, updating v[0..3] in place.
void lz4t_xxh32_round4(uint32_t* v, const uint32_t* words, int64_t nwords) {
  uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  int64_t n = (nwords / 4) * 4;
  for (int64_t i = 0; i < n; i += 4) {
    v1 = xxh_round(v1, words[i]);
    v2 = xxh_round(v2, words[i + 1]);
    v3 = xxh_round(v3, words[i + 2]);
    v4 = xxh_round(v4, words[i + 3]);
  }
  v[0] = v1; v[1] = v2; v[2] = v3; v[3] = v4;
}

// ---------------------------------------------------------------------------
// LZ4 block compress
// ---------------------------------------------------------------------------

static const int MIN_MATCH = 4;
static const int LAST_LITERALS = 5;
static const int MF_LIMIT = 12;
static const int HASH_SHIFT = 18;
static const uint32_t HASH_MASK = 16383;
static const uint32_t HASH_MULT = 2654435761u;
static const int SKIP_TRIGGER = 6;

static inline uint32_t lz4_hash(uint32_t seq) {
  return (seq * HASH_MULT) >> HASH_SHIFT & HASH_MASK;
}

// Insert positions [0, limit-4] of buf into table (stored as pos+1).
// Dictionary warm-up with the ONE true hash (the reference's warm-up uses a
// mismatched Jenkins hash, bufferCompress.js:194-201 — fixed here).
void lz4t_warm_table(int32_t* table, const uint8_t* buf, int64_t limit) {
  for (int64_t i = 0; i + MIN_MATCH <= limit; i++) {
    table[lz4_hash(read32(buf + i))] = (int32_t)(i + 1);
  }
}

// Greedy LZ4 block compress core. Semantics: blockCompress.js:31-232 (hash
// table stores pos+1; acceleration stride grows every 64 misses; forward-only
// extension to src_end-5; token + 0xFF-run lengths; 2-byte LE offset; tail
// literals) — byte-identical output across WILD settings.
//
// WILD=true copies literal runs as unconditional 16-byte chunks (up to 15
// bytes of spill past the run, overwritten by the following sequence) —
// callers must guarantee >= 16 bytes of dst slack beyond the block bound.
// The public raw ABI (lz4t_compress_block) uses WILD=false: exact copies,
// no slack contract on user-provided buffers.
static inline int64_t compress_block_core(const uint8_t* __restrict src,
                                          uint8_t* __restrict dst,
                                          int64_t src_start, int64_t src_len,
                                          int32_t* __restrict table,
                                          int64_t dst_off, const int WILD) {
  int64_t s = src_start;
  const int64_t s_end = src_start + src_len;
  const int64_t mf_limit = s_end - MF_LIMIT;
  const int64_t match_limit = s_end - LAST_LITERALS;
  int64_t d = dst_off;
  int64_t anchor = s;
  int search_count = (1 << SKIP_TRIGGER) + 3;

  while (s < mf_limit) {
    uint32_t seq = read32(src + s);
    uint32_t h = lz4_hash(seq);
    int64_t m = (int64_t)table[h] - 1;
    table[h] = (int32_t)(s + 1);

    if (m < 0 || s == m || (s - m) >= 65536 || read32(src + m) != seq) {
      s += search_count++ >> SKIP_TRIGGER;
      continue;
    }
    search_count = (1 << SKIP_TRIGGER) + 3;

    // Literal run since the anchor.
    int64_t lit_len = s - anchor;
    int64_t token_pos = d++;
    if (lit_len >= 15) {
      dst[token_pos] = 0xF0;
      int64_t l = lit_len - 15;
      while (l >= 255) { dst[d++] = 255; l -= 255; }
      dst[d++] = (uint8_t)l;
    } else {
      dst[token_pos] = (uint8_t)(lit_len << 4);
    }
    if (lit_len > 0) {
      if (WILD) {
        uint8_t* dp = dst + d;
        const uint8_t* sp2 = src + anchor;
        int64_t l = lit_len;
        do { std::memcpy(dp, sp2, 16); dp += 16; sp2 += 16; l -= 16;
        } while (l > 0);
      } else {
        std::memcpy(dst + d, src + anchor, (size_t)lit_len);
      }
      d += lit_len;
    }

    // Extend the match forward.
    int64_t sp = s + MIN_MATCH;
    int64_t mp = m + MIN_MATCH;
    // Word-at-a-time fast path, then byte tail.
    while (sp + 8 <= match_limit) {
      uint64_t a, b;
      std::memcpy(&a, src + sp, 8);
      std::memcpy(&b, src + mp, 8);
      uint64_t diff = a ^ b;
      if (diff) {
        sp += __builtin_ctzll(diff) >> 3;
        goto match_done;
      }
      sp += 8;
      mp += 8;
    }
    while (sp < match_limit && src[sp] == src[mp]) { sp++; mp++; }
  match_done:;
    {
      int64_t match_len = sp - s;
      int64_t offset = s - m;
      dst[d++] = (uint8_t)(offset & 0xFF);
      dst[d++] = (uint8_t)((offset >> 8) & 0xFF);
      int64_t code = match_len - MIN_MATCH;
      if (code >= 15) {
        dst[token_pos] |= 0x0F;
        int64_t l = code - 15;
        while (l >= 255) { dst[d++] = 255; l -= 255; }
        dst[d++] = (uint8_t)l;
      } else {
        dst[token_pos] |= (uint8_t)code;
      }
      s = sp;
      anchor = sp;
    }
  }

  // Trailing literal run.
  {
    int64_t lit_len = s_end - anchor;
    int64_t token_pos = d++;
    if (lit_len >= 15) {
      dst[token_pos] = 0xF0;
      int64_t l = lit_len - 15;
      while (l >= 255) { dst[d++] = 255; l -= 255; }
      dst[d++] = (uint8_t)l;
    } else {
      dst[token_pos] = (uint8_t)(lit_len << 4);
    }
    if (lit_len > 0) {
      std::memcpy(dst + d, src + anchor, (size_t)lit_len);
      d += lit_len;
    }
  }
  return d - dst_off;
}

int64_t lz4t_compress_block(const uint8_t* src, uint8_t* dst,
                            int64_t src_start, int64_t src_len,
                            int32_t* table, int64_t dst_off) {
  return compress_block_core(src, dst, src_start, src_len, table, dst_off,
                             0);
}

// Compress a whole frame BODY — every block loop iteration of the frame
// layer (size word, block, stored fallback, optional block checksum, table
// clear, EndMark) in ONE native call; the Python frame layer contributes
// only the ~20-byte header and optional trailing content checksum. This is
// the host-tier "runtime" analog of the reference's per-call JS loop
// (bufferCompress.js:209-245) without per-block interpreter overhead.
//
// src spans [0, total_end); compression starts at input_start (a nonzero
// start is the dictionary prefix of a linked frame — warm the table first
// via lz4t_warm_table). dst must provide the full worst-case frame-body
// bound: sum over blocks of (4 + block_bound + 4) + 4, plus 16 wild-copy
// slack. Returns bytes written at dst+dst_off.
int64_t lz4t_compress_frame_body(const uint8_t* __restrict src,
                                 int64_t input_start, int64_t total_end,
                                 uint8_t* __restrict dst, int64_t dst_off,
                                 int64_t block_size,
                                 int32_t* __restrict table,
                                 int32_t independent,
                                 int32_t block_checksums) {
  int64_t pos = dst_off;
  int64_t src_pos = input_start;
  while (src_pos < total_end) {
    int64_t end = src_pos + block_size;
    if (end > total_end) end = total_end;
    int64_t bsize = end - src_pos;
    int64_t size_pos = pos;
    pos += 4;
    int64_t comp = compress_block_core(src, dst, src_pos, bsize, table,
                                       pos, 1);
    if (comp > 0 && comp < bsize) {
      uint32_t w = (uint32_t)comp;
      std::memcpy(dst + size_pos, &w, 4);
      pos += comp;
    } else {
      uint32_t w = (uint32_t)bsize | 0x80000000u;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, src + src_pos, (size_t)bsize);
      pos += bsize;
    }
    if (block_checksums) {
      uint32_t ck = lz4t_xxhash32(dst + size_pos + 4,
                                  pos - (size_pos + 4), 0);
      std::memcpy(dst + pos, &ck, 4);
      pos += 4;
    }
    if (independent) std::memset(table, 0, (HASH_MASK + 1) * sizeof(int32_t));
    src_pos = end;
  }
  uint32_t zero = 0;
  std::memcpy(dst + pos, &zero, 4);  // EndMark
  pos += 4;
  return pos - dst_off;
}

// Thread-parallel variant for INDEPENDENT frames: blocks are compressed
// concurrently into per-block scratch (the format's primary parallel axis,
// the same one the device tier shards over devices), then stitched serially into
// the exact same wire layout/bytes as the serial path. Block 0 uses the
// caller's (possibly dictionary-warmed) table; later blocks start from a
// cleared table — identical to the serial per-block clear semantics.
int64_t lz4t_compress_frame_body_mt(const uint8_t* __restrict src,
                                    int64_t input_start, int64_t total_end,
                                    uint8_t* __restrict dst, int64_t dst_off,
                                    int64_t block_size,
                                    int32_t* __restrict table,
                                    int32_t block_checksums,
                                    int32_t nthreads) {
  const int64_t n = total_end - input_start;
  const int64_t nblocks = n > 0 ? (n + block_size - 1) / block_size : 0;
  if (nthreads < 2 || nblocks < 2) {
    return lz4t_compress_frame_body(src, input_start, total_end, dst,
                                    dst_off, block_size, table, 1,
                                    block_checksums);
  }
  if (nthreads > nblocks) nthreads = (int32_t)nblocks;

  // Per-block scratch at a fixed stride (worst-case bound + wild slack).
  const int64_t stride = block_size + block_size / 255 + 16 + 16;
  uint8_t* scratch = (uint8_t*)std::malloc((size_t)(nblocks * stride));
  int64_t* comp_sizes = (int64_t*)std::malloc(nblocks * sizeof(int64_t));
  if (!scratch || !comp_sizes) {
    std::free(scratch); std::free(comp_sizes);
    return lz4t_compress_frame_body(src, input_start, total_end, dst,
                                    dst_off, block_size, table, 1,
                                    block_checksums);
  }

  auto worker = [&](int t) {
    std::vector<int32_t> local(HASH_MASK + 1);
    for (int64_t b = t; b < nblocks; b += nthreads) {
      int64_t s0 = input_start + b * block_size;
      int64_t end = s0 + block_size;
      if (end > total_end) end = total_end;
      int32_t* tb;
      if (b == 0) {
        tb = table;  // dictionary-warmed state, exactly as the serial path
      } else {
        std::memset(local.data(), 0, (HASH_MASK + 1) * sizeof(int32_t));
        tb = local.data();
      }
      comp_sizes[b] = compress_block_core(src, scratch + b * stride, s0,
                                          end - s0, tb, 0, 1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  // Serial stitch into the spec wire layout.
  int64_t pos = dst_off;
  for (int64_t b = 0; b < nblocks; b++) {
    int64_t s0 = input_start + b * block_size;
    int64_t end = s0 + block_size;
    if (end > total_end) end = total_end;
    int64_t bsize = end - s0;
    int64_t comp = comp_sizes[b];
    int64_t size_pos = pos;
    pos += 4;
    if (comp > 0 && comp < bsize) {
      uint32_t w = (uint32_t)comp;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, scratch + b * stride, (size_t)comp);
      pos += comp;
    } else {
      uint32_t w = (uint32_t)bsize | 0x80000000u;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, src + s0, (size_t)bsize);
      pos += bsize;
    }
    if (block_checksums) {
      uint32_t ck = lz4t_xxhash32(dst + size_pos + 4,
                                  pos - (size_pos + 4), 0);
      std::memcpy(dst + pos, &ck, 4);
      pos += 4;
    }
  }
  uint32_t zero = 0;
  std::memcpy(dst + pos, &zero, 4);  // EndMark
  pos += 4;
  std::free(scratch);
  std::free(comp_sizes);
  return pos - dst_off;
}

// ---------------------------------------------------------------------------
// LZ4 block decompress
// ---------------------------------------------------------------------------

// Error codes (translated to typed Python exceptions by the ctypes wrapper).
static const int64_t ERR_OUTPUT_SMALL = -1;   // "Output Buffer Too Small"
static const int64_t ERR_MALFORMED = -2;      // "Malformed Input"
static const int64_t ERR_OFFSET0 = -3;        // "Invalid Offset 0"
static const int64_t ERR_DICT_OOB = -4;       // "Dictionary Offset Out of Bounds"
static const int64_t ERR_BLOCK_CK = -5;       // "Block Checksum Error"

// Sequence interpreter with dictionary back-references
// (blockDecompress.js:55-272). dst_cap is the full output buffer length;
// back-references below index 0 read the dictionary from its END; a match
// may span dictionary into output.
int64_t lz4t_decompress_block(const uint8_t* src, int64_t src_off,
                              int64_t src_len, uint8_t* dst, int64_t dst_cap,
                              int64_t dst_off, const uint8_t* dict,
                              int64_t dict_len) {
  int64_t p = src_off;
  const int64_t end = src_off + src_len;
  int64_t o = dst_off;

  // Wild-copy fast path: unconditional 16-byte chunk copies may write up to
  // 15 bytes past the copy's logical end; legal while both cursors stay
  // WILD_MARGIN clear of their buffers' ends (later sequences overwrite the
  // spill). The tail of the block falls back to exact copies.
  const int64_t WILD_MARGIN = 32;
  const int64_t wild_end = end - WILD_MARGIN;
  const int64_t wild_cap = dst_cap - WILD_MARGIN;

  while (p < end) {
    uint32_t token = src[p++];
    int64_t lit_len = token >> 4;

    // --- literals ---
    if (lit_len == 15) {
      uint32_t b;
      do {
        if (p >= end) return ERR_MALFORMED;
        b = src[p++];
        lit_len += b;
      } while (b == 255);
    }
    if (o + lit_len > dst_cap) return ERR_OUTPUT_SMALL;
    if (p + lit_len > end) return ERR_MALFORMED;
    if (lit_len <= 16 && p + 16 <= end && o + 16 <= wild_cap) {
      std::memcpy(dst + o, src + p, 16);  // wild 16B covers <=16 literals
    } else if (lit_len) {
      std::memcpy(dst + o, src + p, (size_t)lit_len);
    }
    o += lit_len;
    p += lit_len;
    if (p >= end) break;

    // --- offset + match length ---
    if (p + 2 > end) return ERR_MALFORMED;
    int64_t offset = src[p] | (src[p + 1] << 8);
    p += 2;
    if (offset == 0) return ERR_OFFSET0;

    int64_t match_len = token & 0x0F;
    if (match_len == 15) {
      uint32_t b;
      do {
        if (p >= end) return ERR_MALFORMED;
        b = src[p++];
        match_len += b;
      } while (b == 255);
    }
    match_len += MIN_MATCH;
    if (o + match_len > dst_cap) return ERR_OUTPUT_SMALL;

    int64_t cs = o - offset;
    if (cs < 0) {
      // Dictionary back-reference, dict indexed from its end.
      int64_t from_dict = -cs;
      int64_t dict_start = dict_len - from_dict;
      int64_t take = from_dict < match_len ? from_dict : match_len;
      if (dict_start < 0 || dict_start + take > dict_len) return ERR_DICT_OOB;
      std::memcpy(dst + o, dict + dict_start, (size_t)take);
      o += take;
      int64_t remaining = match_len - take;
      int64_t rp = o - offset;
      while (remaining--) dst[o++] = dst[rp++];
    } else if (offset >= match_len) {
      // Non-overlapping: one wild 16B copy covers the common short match;
      // long matches take a single memcpy.
      if (match_len <= 16 && offset >= 16 && o + 16 <= wild_cap) {
        std::memcpy(dst + o, dst + cs, 16);
      } else {
        std::memcpy(dst + o, dst + cs, (size_t)match_len);
      }
      o += match_len;
    } else if (offset >= 16) {
      // Overlapping, offset>=16: wild 16B-chunk copy propagates correctly
      // (each chunk's source bytes are written by prior chunks); period-
      // doubling fallback near the buffer end (memmove would NOT propagate).
      if (o + match_len + 16 <= wild_cap) {
        int64_t dp = o, sp = cs;
        int64_t stop = o + match_len;
        do {
          std::memcpy(dst + dp, dst + sp, 16);
          dp += 16;
          sp += 16;
        } while (dp < stop);
      } else {
        int64_t remaining = match_len;
        int64_t avail = offset;
        int64_t dp = o;
        while (remaining > 0) {
          int64_t c = avail < remaining ? avail : remaining;
          std::memcpy(dst + dp, dst + cs, (size_t)c);
          dp += c;
          remaining -= c;
          avail += c;
        }
      }
      o += match_len;
    } else if (offset == 1) {
      // RLE.
      std::memset(dst + o, dst[cs], (size_t)match_len);
      o += match_len;
    } else {
      // Short-offset overlap (2..15): period-doubling copy — O(log)
      // non-overlapping memcpys instead of a byte loop (the reference's
      // blockDecompress.js uses unrolled byte loops here, :219-268).
      int64_t remaining = match_len;
      int64_t avail = offset;
      int64_t dp = o;
      while (remaining > 0) {
        int64_t c = avail < remaining ? avail : remaining;
        std::memcpy(dst + dp, dst + cs, (size_t)c);
        dp += c;
        remaining -= c;
        avail += c;
      }
      o += match_len;
    }
  }
  return o - dst_off;
}

// Decode a whole frame BODY (direct-write strategy) in one native call —
// the block loop of the frame layer: size words, stored blocks, optional
// block-checksum verification, spec window semantics, EndMark. Mirrors
// frame.py's loop exactly (same error taxonomy/order). Returns plaintext
// bytes written to result, or a negative error code; *wire_end_out receives
// the wire position just past the last consumed word (for the trailing
// content-checksum read on the Python side).
//
// Window semantics: independent blocks reference the dictionary ONLY (the
// window resets per block — lz4frame semantics); linked blocks reference
// prior output (and the dictionary below output start).
int64_t lz4t_decompress_frame_body(const uint8_t* __restrict buf,
                                   int64_t pos, int64_t n,
                                   uint8_t* __restrict result,
                                   int64_t result_cap,
                                   const uint8_t* dict, int64_t dict_len,
                                   int32_t independent,
                                   int32_t block_checksums,
                                   int32_t verify,
                                   int64_t* wire_end_out) {
  int64_t result_pos = 0;
  while (pos < n) {
    if (pos + 4 > n) return ERR_MALFORMED;
    uint32_t word;
    std::memcpy(&word, buf + pos, 4);
    pos += 4;
    if (word == 0) break;  // EndMark
    int64_t bsize = word & 0x7FFFFFFF;
    int stored = (word & 0x80000000u) != 0;
    if (pos + bsize > n) return ERR_MALFORMED;

    if (block_checksums) {
      if (pos + bsize + 4 > n) return ERR_MALFORMED;
      if (verify) {
        uint32_t stored_ck;
        std::memcpy(&stored_ck, buf + pos + bsize, 4);
        if (stored_ck != lz4t_xxhash32(buf + pos, bsize, 0))
          return ERR_BLOCK_CK;
      }
    }

    if (stored) {
      if (result_pos + bsize > result_cap) return ERR_OUTPUT_SMALL;
      std::memcpy(result + result_pos, buf + pos, (size_t)bsize);
      result_pos += bsize;
    } else if (independent) {
      int64_t rc = lz4t_decompress_block(buf, pos, bsize,
                                         result + result_pos,
                                         result_cap - result_pos, 0,
                                         dict, dict_len);
      if (rc < 0) return rc;
      result_pos += rc;
    } else {
      int64_t rc = lz4t_decompress_block(buf, pos, bsize, result, result_cap,
                                         result_pos, dict, dict_len);
      if (rc < 0) return rc;
      result_pos += rc;
    }
    pos += bsize;
    if (block_checksums) pos += 4;
  }
  *wire_end_out = pos;
  return result_pos;
}

// Thread-parallel direct-write decode for INDEPENDENT frames: a serial
// O(nblocks) block-table scan, concurrent per-block decode into scratch
// (each block's window is the dictionary only — spec semantics), then a
// serial stitch. Bytes identical to the serial path. block_max is the BD
// header's block maximum (the spec cap on a block's decoded size); a block
// exceeding it falls back to the serial path.
int64_t lz4t_decompress_frame_body_mt(const uint8_t* __restrict buf,
                                      int64_t pos, int64_t n,
                                      uint8_t* __restrict result,
                                      int64_t result_cap,
                                      const uint8_t* dict, int64_t dict_len,
                                      int64_t block_max,
                                      int32_t block_checksums,
                                      int32_t verify,
                                      int32_t nthreads,
                                      int64_t* wire_end_out) {
  // Serial block-table scan.
  std::vector<int64_t> offs, sizes;
  std::vector<uint8_t> stored_v;
  int64_t scan = pos;
  while (scan < n) {
    if (scan + 4 > n) return ERR_MALFORMED;
    uint32_t word;
    std::memcpy(&word, buf + scan, 4);
    scan += 4;
    if (word == 0) break;
    int64_t bsize = word & 0x7FFFFFFF;
    if (scan + bsize + (block_checksums ? 4 : 0) > n) return ERR_MALFORMED;
    offs.push_back(scan);
    sizes.push_back(bsize);
    stored_v.push_back((word & 0x80000000u) != 0);
    scan += bsize + (block_checksums ? 4 : 0);
  }
  const int64_t nblocks = (int64_t)offs.size();
  if (nthreads < 2 || nblocks < 2) {
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }
  if (nthreads > nblocks) nthreads = (int32_t)nblocks;

  uint8_t* scratch = (uint8_t*)std::malloc((size_t)(nblocks * block_max));
  int64_t* dec_sizes = (int64_t*)std::malloc(nblocks * sizeof(int64_t));
  if (!scratch || !dec_sizes) {
    std::free(scratch); std::free(dec_sizes);
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }

  std::vector<int64_t> errs(nthreads, 0);
  auto worker = [&](int t) {
    for (int64_t b = t; b < nblocks; b += nthreads) {
      if (block_checksums && verify) {
        uint32_t stored_ck;
        std::memcpy(&stored_ck, buf + offs[b] + sizes[b], 4);
        if (stored_ck != lz4t_xxhash32(buf + offs[b], sizes[b], 0)) {
          errs[t] = ERR_BLOCK_CK;
          return;
        }
      }
      if (stored_v[b]) {
        dec_sizes[b] = sizes[b];  // stitched straight from buf
        if (sizes[b] > block_max) { errs[t] = ERR_OUTPUT_SMALL; return; }
        continue;
      }
      int64_t rc = lz4t_decompress_block(buf, offs[b], sizes[b],
                                         scratch + b * block_max, block_max,
                                         0, dict, dict_len);
      if (rc < 0) { errs[t] = rc; return; }
      dec_sizes[b] = rc;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  int64_t err = 0;
  for (int t = 0; t < nthreads; t++) if (errs[t] < 0) err = errs[t];
  if (err == ERR_OUTPUT_SMALL) {
    // A block larger than the BD block maximum: out-of-spec but the serial
    // path tolerates it when the result buffer has room — retry serially.
    std::free(scratch); std::free(dec_sizes);
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }
  if (err < 0) { std::free(scratch); std::free(dec_sizes); return err; }

  int64_t result_pos = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    if (result_pos + dec_sizes[b] > result_cap) {
      std::free(scratch); std::free(dec_sizes);
      return ERR_OUTPUT_SMALL;
    }
    const uint8_t* srcp = stored_v[b] ? buf + offs[b]
                                      : scratch + b * block_max;
    std::memcpy(result + result_pos, srcp, (size_t)dec_sizes[b]);
    result_pos += dec_sizes[b];
  }
  std::free(scratch);
  std::free(dec_sizes);
  *wire_end_out = scan;
  return result_pos;
}

// Record parser for the region decode kernel (ops/gpu_decode.py). No
// literal image is built: literal bytes stay in the compressed stream (the
// "wire image" the kernel receives), so the device transfer ships 1x
// compressed bytes. Each record covers up to 128 CONTIGUOUS output bytes —
// a slice of a literal run copied from the wire plus (optionally) a match
// copy from prior output:
//
//   recs[2k]   = src  (wire byte offset of the literal slice)
//   recs[2k+1] = offset | ll<<16 | ml<<24      (ll, ml <= 128, ll+ml <= 128)
//
// The record's output start (dst) is NOT stored: records tile the output
// exactly in order, so dst = running sum of (ll+ml), which the kernel
// carries as it walks the records.
//
// RECORD CONTRACT (one 128-lane copy per record):
//   * a record's match source [dst+ll-offset, dst+ll-offset+ml) must be
//     fully written when it executes => offset >= ll+ml for combined
//     records; far matches (offset >= 128) split into <= 128-byte chunks
//     whose first chunk absorbs the literal tail; overlap matches
//     (offset < 128) emit literal records then a log-doubling chain
//     (off, 2*off, ... — each chunk's source complete when it runs).
//
// Validation matches lz4t_decompress_block (same error taxonomy). Returns
// the record count, or a negative error code; *out_len_out = decoded size.
int64_t lz4t_parse_records2(const uint8_t* src, int64_t src_len,
                            int64_t out_cap, uint32_t* recs, int64_t rec_cap,
                            int64_t dict_len, int64_t* out_len_out) {
  int64_t p = 0, o = 0, nrec = 0;
  while (p < src_len) {
    uint32_t token = src[p++];
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        lit_len += b;
      } while (b == 255);
    }
    if (o + lit_len > out_cap) return ERR_OUTPUT_SMALL;
    if (p + lit_len > src_len) return ERR_MALFORMED;
    int64_t lp = p;  // literal slice's wire position
    o += lit_len;
    p += lit_len;
    if (p >= src_len) {
      // trailing-literals sequence: pure literal records
      while (lit_len > 0) {
        int64_t take = lit_len < 128 ? lit_len : 128;
        if (nrec >= rec_cap) return -6;
        recs[2 * nrec] = (uint32_t)lp;
        recs[2 * nrec + 1] = 1u | ((uint32_t)take << 16);
        nrec++;
        lp += take;
        lit_len -= take;
      }
      break;
    }

    if (p + 2 > src_len) return ERR_MALFORMED;
    int64_t offset = src[p] | (src[p + 1] << 8);
    p += 2;
    if (offset == 0) return ERR_OFFSET0;
    if (offset > o + dict_len) return ERR_DICT_OOB;

    int64_t match_len = token & 0x0F;
    if (match_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        match_len += b;
      } while (b == 255);
    }
    match_len += MIN_MATCH;
    if (o + match_len > out_cap) return ERR_OUTPUT_SMALL;
    o += match_len;

    int64_t ll = lit_len, ml = match_len;
    if (nrec + (ll >> 7) + (ml >> 7) + 10 > rec_cap) return -6;
    if (ll + ml <= 128 && offset >= ll + ml) {
      // the common case: one combined record per sequence
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] =
          (uint32_t)offset | ((uint32_t)ll << 16) | ((uint32_t)ml << 24);
      nrec++;
      continue;
    }
    if (offset >= 128) {
      // literal chunks; the last (<= 128 B) absorbs the match head —
      // offset >= 128 >= ll'+take keeps the source fully prior
      while (ll > 128) {
        recs[2 * nrec] = (uint32_t)lp;
        recs[2 * nrec + 1] = 1u | (128u << 16);
        nrec++;
        lp += 128;
        ll -= 128;
      }
      int64_t take = ml < 128 - ll ? ml : 128 - ll;
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] =
          (uint32_t)offset | ((uint32_t)ll << 16) | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
      while (ml > 0) {
        take = ml < 128 ? ml : 128;
        recs[2 * nrec] = 0;
        recs[2 * nrec + 1] = (uint32_t)offset | ((uint32_t)take << 24);
        nrec++;
        ml -= take;
      }
      continue;
    }
    // overlap match (offset < 128): literal records, then a doubling chain
    while (ll > 0) {
      int64_t take = ll < 128 ? ll : 128;
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] = 1u | ((uint32_t)take << 16);
      nrec++;
      lp += take;
      ll -= take;
    }
    int64_t off = offset;
    while (off < 128 && ml > 0) {
      int64_t take = ml < off ? ml : off;
      recs[2 * nrec] = 0;
      recs[2 * nrec + 1] = (uint32_t)off | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
      off <<= 1;
    }
    while (ml > 0) {
      int64_t take = ml < 128 ? ml : 128;
      recs[2 * nrec] = 0;
      recs[2 * nrec + 1] = (uint32_t)off | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
    }
  }
  *out_len_out = o;
  return nrec;
}

// lz4t_parse_records2 over many blocks of one buffer in one call. Block b
// is buf[offs[b], offs[b] + sizes[b]), stored blocks become pure-literal
// records; every record's src is rebased to buf. Independent blocks parse
// on up to nthreads threads, each seeing dict_len bytes of history; a
// linked chain (independent == 0) parses in order, block b seeing
// dict_len plus the output of the blocks before it. The records of all
// blocks, in block order, land in one malloc'd array (*recs_out, freed
// with lz4t_free); counts[b] and out_lens[b] receive each block's record
// count and decoded size. Returns the total record count, or the error
// code of the first failing block in block order.
int64_t lz4t_parse_records2_batch(const uint8_t* buf, int64_t nblocks,
                                  const int64_t* offs, const int64_t* sizes,
                                  const uint8_t* stored, int64_t out_cap,
                                  int64_t dict_len, int32_t independent,
                                  int32_t nthreads, uint32_t** recs_out,
                                  int64_t* counts, int64_t* out_lens) {
  *recs_out = nullptr;
  if (nblocks <= 0) return 0;
  if (!independent || nthreads < 1) nthreads = 1;
  if (nthreads > nblocks) nthreads = (int32_t)nblocks;
  struct Part {
    uint32_t* recs = nullptr;
    int64_t used = 0, cap = 0;
  };
  std::vector<Part> parts(nthreads);
  std::vector<int64_t> errs(nblocks, 0), where(nblocks, 0);
  auto parse_block = [&](Part& pt, int64_t b, int64_t hist) -> int64_t {
    const int64_t n = sizes[b];
    int64_t need = stored[b] ? (n + 127) / 128
        : std::min((n / 3 + 1) * 9 + out_cap / 128, out_cap) + 8;
    if (pt.used + need > pt.cap) {
      int64_t cap = std::max(pt.cap * 2, pt.used + need);
      uint32_t* r = (uint32_t*)std::realloc(pt.recs, cap * 8);
      if (!r) return ERR_OUTPUT_SMALL;
      pt.recs = r;
      pt.cap = cap;
    }
    uint32_t* r = pt.recs + 2 * pt.used;
    int64_t nrec;
    if (stored[b]) {
      if (n > out_cap) return ERR_OUTPUT_SMALL;
      nrec = need;
      for (int64_t k = 0; k < nrec; ++k) {
        int64_t take = std::min<int64_t>(128, n - 128 * k);
        r[2 * k] = (uint32_t)(128 * k);
        r[2 * k + 1] = 1u | ((uint32_t)take << 16);
      }
      out_lens[b] = n;
    } else {
      nrec = lz4t_parse_records2(buf + offs[b], n, out_cap, r, need, hist,
                                 &out_lens[b]);
      if (nrec < 0) return nrec;
    }
    for (int64_t k = 0; k < nrec; ++k) r[2 * k] += (uint32_t)offs[b];
    where[b] = pt.used;
    counts[b] = nrec;
    pt.used += nrec;
    return 0;
  };
  auto worker = [&](int t) {
    int64_t hist = dict_len;
    for (int64_t b = t; b < nblocks; b += nthreads) {
      errs[b] = parse_block(parts[t], b, hist);
      if (errs[b] < 0) return;
      if (!independent) hist += out_lens[b];
    }
  };
  if (nthreads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  int64_t rc = 0, total = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    if (errs[b] < 0) { rc = errs[b]; break; }
    total += counts[b];
  }
  uint32_t* out = nullptr;
  if (rc == 0) {
    out = (uint32_t*)std::malloc(std::max<int64_t>(total, 1) * 8);
    if (!out) rc = ERR_OUTPUT_SMALL;
  }
  if (rc == 0) {
    int64_t pos = 0;
    for (int64_t b = 0; b < nblocks; ++b) {
      std::memcpy(out + 2 * pos, parts[b % nthreads].recs + 2 * where[b],
                  counts[b] * 8);
      pos += counts[b];
    }
    *recs_out = out;
    rc = total;
  }
  for (auto& pt : parts) std::free(pt.recs);
  return rc;
}

void lz4t_free(void* p) { std::free(p); }

// Greedy selection + exact extension + serialization over a device-built
// candidate chain (ops/split_encode.py "chain-direct" encode): the device
// ships ONLY a u16 match distance per payload position (0 = no candidate;
// ops/hybrid_encode.build_dist_chains). The next matchable position is
// found here by scanning for the next nonzero distance (8-byte strides — a
// memchr-class pass over memory the selector walks anyway), then the match
// is exactly extended and emitted at memcpy-class speed.
//
// Sort diet: the production chain phase sorts a HASHED window key
// (ops/hybrid_encode, hashed=True), so a candidate's first 4 bytes are no
// longer equal by construction — a hash collision can claim a false match.
// The 4-byte verify below rejects those (skip to the next nonzero), the
// same verification the reference's collision-prone 16K table does at
// blockCompress.js:64-66. Exact chains never trigger it. Returns bytes
// written.
// Core with optional splice meta (meta[4] = trailing-token position,
// trailing literal count, last-MATCH-sequence stream offset (-1 if none),
// its payload-relative output anchor (-1) — the big-block segment
// splicer's contract, parallel/bigblock.py).
static inline int64_t chain_ser16_core(const uint8_t* work,
                                       int64_t hist_len, int64_t src_len,
                                       const uint16_t* dist16, uint8_t* out,
                                       int64_t* meta) {
  const int64_t mf_limit = src_len - MF_LIMIT;
  const int64_t match_limit = src_len - LAST_LITERALS;
  const uint8_t* pay = work + hist_len;
  int64_t o = 0, d = 0;
  int64_t last_d = -1, last_anchor = -1;
  if (src_len > 0 && mf_limit > 0) {
    int64_t m = 0;
    for (;;) {
      // next matchable position >= m (dist16 has >= src_len entries,
      // zero beyond mf_limit, so the strided reads never pass cap).
      // 32-byte stride first — sparse corpora spend this scan in long
      // zero runs and -march=native lifts the 4-word OR to one vector
      // test — then a ctz jump straight to the first nonzero lane.
      while (m + 16 <= mf_limit) {
        uint64_t v0, v1, v2, v3;
        std::memcpy(&v0, dist16 + m, 8);
        std::memcpy(&v1, dist16 + m + 4, 8);
        std::memcpy(&v2, dist16 + m + 8, 8);
        std::memcpy(&v3, dist16 + m + 12, 8);
        if (v0 | v1 | v2 | v3) {
          if (v0) m += __builtin_ctzll(v0) >> 4;
          else if (v1) m += 4 + (__builtin_ctzll(v1) >> 4);
          else if (v2) m += 8 + (__builtin_ctzll(v2) >> 4);
          else m += 12 + (__builtin_ctzll(v3) >> 4);
          break;
        }
        m += 16;
      }
      while (m + 4 <= mf_limit) {
        uint64_t v;
        std::memcpy(&v, dist16 + m, 8);
        if (v) { m += __builtin_ctzll(v) >> 4; break; }
        m += 4;
      }
      while (m < mf_limit && dist16[m] == 0) m++;
      if (m >= mf_limit) break;
      const int64_t dist = dist16[m];

      // verify the claimed match (hashed-chain collision guard); a false
      // candidate costs one compare and the scan moves on
      {
        uint32_t wa, wb;
        std::memcpy(&wa, pay + m, 4);
        std::memcpy(&wb, pay + m - dist, 4);
        if (wa != wb) { m++; continue; }
      }

      // exact extension (first MIN_MATCH bytes verified above)
      int64_t len = MIN_MATCH;
      const uint8_t* a = pay + m;
      const uint8_t* b = a - dist;
      const int64_t lim = match_limit - m;
      while (len + 8 <= lim) {
        uint64_t x, y;
        std::memcpy(&x, a + len, 8);
        std::memcpy(&y, b + len, 8);
        if (x != y) {
          len += __builtin_ctzll(x ^ y) >> 3;
          goto emit;
        }
        len += 8;
      }
      while (len < lim && a[len] == b[len]) len++;
    emit:;
      last_d = d;
      last_anchor = o;
      int64_t lit = m - o;
      int64_t mcode = len - MIN_MATCH;
      out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4
                           | (mcode < 15 ? mcode : 15));
      if (lit >= 15) {
        int64_t rem = lit - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      std::memcpy(out + d, pay + o, (size_t)lit);
      d += lit;
      out[d++] = (uint8_t)(dist & 0xFF);
      out[d++] = (uint8_t)(dist >> 8);
      if (mcode >= 15) {
        int64_t rem = mcode - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      o = m + len;
      m = o;
    }
  }
  int64_t lit = src_len - o;
  if (meta) {
    meta[0] = d;        // trailing-token position (0 => all-literal)
    meta[1] = lit;      // trailing literal count
    meta[2] = last_d;
    meta[3] = last_anchor;
  }
  out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) {
    int64_t rem = lit - 15;
    while (rem >= 255) { out[d++] = 255; rem -= 255; }
    out[d++] = (uint8_t)rem;
  }
  std::memcpy(out + d, pay + o, (size_t)lit);
  return d + lit;
}

int64_t lz4t_chain_serialize16(const uint8_t* work, int64_t hist_len,
                               int64_t src_len, const uint16_t* dist16,
                               uint8_t* out) {
  return chain_ser16_core(work, hist_len, src_len, dist16, out, nullptr);
}

// Meta-emitting form for the big-block segment splicer.
int64_t lz4t_chain_serialize16m(const uint8_t* work, int64_t hist_len,
                                int64_t src_len, const uint16_t* dist16,
                                uint8_t* out, int64_t* meta) {
  return chain_ser16_core(work, hist_len, src_len, dist16, out, meta);
}

}  // extern "C"
