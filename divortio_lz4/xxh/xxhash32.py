"""xxHash32 — one-shot and streaming.

Spec-conformant xxHash32 (seeded, little-endian). Behavioral parity targets:
/root/reference/src/xxhash32/xxhash32.js (one-shot) and
/root/reference/src/xxhash32/xxhash32Stateful.js (streaming; non-destructive
``digest()`` peek). Known vectors: xxhash32(b"") == 0x02CC5D05,
xxhash32(b"Hello World") == 0xB1FD16EE (tests/xxhash32/xxhash32.test.mjs:13,20).

The hot path is delegated to the native C++ kernel when available
(divortio_lz4.native); this module is the portable fallback and the
state-machine for streaming use.
"""

from __future__ import annotations

import numpy as np

from ..utils import ensure_buffer

PRIME1 = 0x9E3779B1  # 2654435761
PRIME2 = 0x85EBCA77  # 2246822519
PRIME3 = 0xC2B2AE3D  # 3266489917
PRIME4 = 0x27D4EB2F  # 668265263
PRIME5 = 0x165667B1  # 374761393

_M32 = 0xFFFFFFFF

# Populated by divortio_lz4.native at import time (if the shared library
# builds); signature: (np.uint8 array, seed:int) -> int.
_native_oneshot = None
_native_round4 = None  # (v1,v2,v3,v4, np.uint8 stripes) -> (v1,v2,v3,v4)


def _rotl(x: int, r: int) -> int:
    x &= _M32
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + (lane * PRIME2 & _M32)) & _M32
    return (_rotl(acc, 13) * PRIME1) & _M32


def _stripes_py(v1: int, v2: int, v3: int, v4: int, words: np.ndarray):
    """Consume len(words)//4 full 16-byte stripes. words: uint32 LE lanes."""
    n = (len(words) // 4) * 4
    for p in range(0, n, 4):
        v1 = _round(v1, int(words[p]))
        v2 = _round(v2, int(words[p + 1]))
        v3 = _round(v3, int(words[p + 2]))
        v4 = _round(v4, int(words[p + 3]))
    return v1, v2, v3, v4


def _tail(h32: int, buf: np.ndarray, p: int) -> int:
    """Process the <16-byte tail starting at p, then avalanche."""
    n = len(buf)
    while p + 4 <= n:
        lane = int(buf[p]) | (int(buf[p + 1]) << 8) | (int(buf[p + 2]) << 16) | (
            int(buf[p + 3]) << 24)
        h32 = (h32 + (lane * PRIME3 & _M32)) & _M32
        h32 = (_rotl(h32, 17) * PRIME4) & _M32
        p += 4
    while p < n:
        h32 = (h32 + (int(buf[p]) * PRIME5 & _M32)) & _M32
        h32 = (_rotl(h32, 11) * PRIME1) & _M32
        p += 1
    h32 ^= h32 >> 15
    h32 = (h32 * PRIME2) & _M32
    h32 ^= h32 >> 13
    h32 = (h32 * PRIME3) & _M32
    h32 ^= h32 >> 16
    return h32


def xxhash32(data, seed: int = 0) -> int:
    """One-shot xxHash32 of *data* with *seed*; returns unsigned 32-bit int."""
    buf = ensure_buffer(data)
    if _native_oneshot is not None:
        return _native_oneshot(buf, seed)
    return _xxhash32_py(buf, seed)


def _xxhash32_py(buf: np.ndarray, seed: int = 0) -> int:
    seed &= _M32
    n = len(buf)
    if n >= 16:
        nstripes = n // 16
        words = np.frombuffer(buf[: nstripes * 16].tobytes(), dtype="<u4")
        v1 = (seed + PRIME1 + PRIME2) & _M32
        v2 = (seed + PRIME2) & _M32
        v3 = seed
        v4 = (seed - PRIME1) & _M32
        if _native_round4 is not None:
            v1, v2, v3, v4 = _native_round4(v1, v2, v3, v4, words)
        else:
            v1, v2, v3, v4 = _stripes_py(v1, v2, v3, v4, words)
        h32 = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
        p = nstripes * 16
    else:
        h32 = (seed + PRIME5) & _M32
        p = 0
    h32 = (h32 + n) & _M32
    return _tail(h32, buf, p)


class XXHash32:
    """Incremental xxHash32 with a 16-byte carry buffer.

    ``digest()`` is a non-destructive peek — it may be called repeatedly and
    interleaved with further ``update()`` calls
    (tests/xxhash32/xxhash32Stateful.test.mjs:61-79).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed & _M32
        self.reset()

    def reset(self) -> "XXHash32":
        s = self.seed
        self._v1 = (s + PRIME1 + PRIME2) & _M32
        self._v2 = (s + PRIME2) & _M32
        self._v3 = s
        self._v4 = (s - PRIME1) & _M32
        self._total = 0
        self._mem = np.empty(16, dtype=np.uint8)
        self._memsize = 0
        return self

    def update(self, data) -> "XXHash32":
        buf = ensure_buffer(data)
        n = len(buf)
        if n == 0:
            return self
        self._total += n
        pos = 0
        # Fill the carry buffer first.
        if self._memsize > 0:
            take = min(16 - self._memsize, n)
            self._mem[self._memsize: self._memsize + take] = buf[:take]
            self._memsize += take
            pos = take
            if self._memsize < 16:
                return self
            words = np.frombuffer(self._mem.tobytes(), dtype="<u4")
            stripe = (_native_round4 if _native_round4 is not None
                      else _stripes_py)
            self._v1, self._v2, self._v3, self._v4 = stripe(
                self._v1, self._v2, self._v3, self._v4, words)
            self._memsize = 0
        # Bulk stripes. Zero-copy u32 view when the slice allows it —
        # the tobytes() fallback copies the whole segment and measurably
        # dominated checksum-verified streaming decode (profiled).
        nstripes = (n - pos) // 16
        if nstripes > 0:
            seg = buf[pos: pos + nstripes * 16]
            try:
                words = seg.view("<u4")
            except ValueError:  # non-contiguous or oddly-aligned slice
                words = np.frombuffer(seg.tobytes(), dtype="<u4")
            if _native_round4 is not None:
                self._v1, self._v2, self._v3, self._v4 = _native_round4(
                    self._v1, self._v2, self._v3, self._v4, words)
            else:
                self._v1, self._v2, self._v3, self._v4 = _stripes_py(
                    self._v1, self._v2, self._v3, self._v4, words)
            pos += nstripes * 16
        # Stash the remainder.
        rem = n - pos
        if rem > 0:
            self._mem[:rem] = buf[pos:]
            self._memsize = rem
        return self

    def state_dict(self) -> dict:
        """Serializable snapshot (checkpoint/resume for streaming sessions)."""
        return {
            "seed": self.seed, "v": (self._v1, self._v2, self._v3, self._v4),
            "total": self._total,
            "mem": bytes(self._mem[: self._memsize]),
        }

    @classmethod
    def from_state(cls, state: dict) -> "XXHash32":
        h = cls(state["seed"])
        h._v1, h._v2, h._v3, h._v4 = state["v"]
        h._total = state["total"]
        h._memsize = len(state["mem"])
        h._mem[: h._memsize] = np.frombuffer(state["mem"], np.uint8)
        return h

    def digest(self) -> int:
        if self._total >= 16:
            h32 = (_rotl(self._v1, 1) + _rotl(self._v2, 7) +
                   _rotl(self._v3, 12) + _rotl(self._v4, 18)) & _M32
        else:
            h32 = (self.seed + PRIME5) & _M32
        h32 = (h32 + self._total) & _M32
        return _tail(h32, self._mem[: self._memsize], 0)
