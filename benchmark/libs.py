"""Comparator library adapters — the reference's BaseLib tower.

Mirrors /root/reference/benchmark/src/libs/** (BaseLib abstract {name,
library, environment, language, load, compress, decompress} +  registries):
each adapter wraps one codec behind the same two-function surface so the
runner can produce like-for-like comparison tables. Adapters self-gate on
importability — the registry exposes whatever the environment provides
(this image ships zlib/zstandard/bz2/lzma; python-lz4 and snappy activate
automatically where installed, giving the real-LZ4 interop column).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass
class LibAdapter:
    """One comparator codec (shared/baseLib.js:4-46 analog)."""

    name: str
    library: str
    language: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    level: Optional[int] = None


def _try(name: str, build) -> Optional[LibAdapter]:
    try:
        return build()
    except ImportError:
        return None


def _build_registry() -> Dict[str, LibAdapter]:
    adapters: Dict[str, LibAdapter] = {}

    def add(a: Optional[LibAdapter]):
        if a is not None:
            adapters[a.name] = a

    def divortio_lz4():
        import numpy as np

        import divortio_lz4 as lz4
        cfg = lz4.FrameConfig(block_size=4 * 1024 * 1024,
                              block_independence=True)
        return LibAdapter(
            "divortio-lz4", "divortio_lz4", "python+c+++jax",
            lambda b: bytes(lz4.compress(np.frombuffer(b, np.uint8),
                                         config=cfg)),
            lambda b: bytes(lz4.decompress(np.frombuffer(b, np.uint8))))

    def gzip6():
        import zlib
        return LibAdapter("gzip", "zlib", "c",
                          lambda b: zlib.compress(b, 6),
                          zlib.decompress, level=6)

    def zstd3():
        import zstandard
        cc = zstandard.ZstdCompressor(level=3)
        dc = zstandard.ZstdDecompressor()
        return LibAdapter("zstd", "zstandard", "c",
                          cc.compress, dc.decompress, level=3)

    def bz2_9():
        import bz2
        return LibAdapter("bzip2", "bz2", "c",
                          lambda b: bz2.compress(b, 9),
                          bz2.decompress, level=9)

    def lzma6():
        import lzma
        return LibAdapter("xz", "lzma", "c",
                          lambda b: lzma.compress(b, preset=6),
                          lzma.decompress, level=6)

    def lz4_frame():
        # The C-lz4 interop column (activates where python-lz4 exists —
        # the reference benches lz4-napi the same way, benchWorker.js).
        import lz4.frame as lf
        return LibAdapter("c-lz4", "python-lz4", "c",
                          lf.compress, lf.decompress)

    def snappy_():
        import snappy
        return LibAdapter("snappy", "python-snappy", "c",
                          snappy.compress, snappy.decompress)

    add(_try("divortio-lz4", divortio_lz4))
    add(_try("gzip", gzip6))
    add(_try("zstd", zstd3))
    add(_try("bzip2", bz2_9))
    add(_try("xz", lzma6))
    add(_try("c-lz4", lz4_frame))
    add(_try("snappy", snappy_))
    return adapters


_REGISTRY: Optional[Dict[str, LibAdapter]] = None


def registry() -> Dict[str, LibAdapter]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


def run_interop_check() -> dict:
    """Cross-implementation LZ4 interop: our frames decoded by python-lz4
    (C liblz4 bindings) and theirs by us, when the library is present.

    Returns a transcript dict (recorded by `python -m benchmark.interop`);
    falls back to the golden-vector anchor in environments without a second
    LZ4 implementation (this image has none — SURVEY §4).
    """
    import numpy as np

    import divortio_lz4 as lz4t

    payload = bytes(np.random.default_rng(7).integers(
        65, 91, 100_000, dtype=np.uint8)) + b"interop " * 5000
    out: dict = {"payload_bytes": len(payload)}
    try:
        import lz4.frame as lf
    except ImportError:
        lf = None
    if lf is not None:
        ours = bytes(lz4t.compress(np.frombuffer(payload, np.uint8)))
        assert lf.decompress(ours) == payload
        theirs = lf.compress(payload)
        assert bytes(lz4t.decompress(
            np.frombuffer(theirs, np.uint8))) == payload
        out["python_lz4"] = {
            "ours_decoded_by_liblz4": True,
            "liblz4_decoded_by_us": True,
            "our_frame_bytes": len(ours),
            "their_frame_bytes": len(theirs),
        }
    else:
        g = bytes.fromhex(
            "04224D186040820B00008048656c6c6f20576f726c6400000000")
        ok = bytes(lz4t.decompress(np.frombuffer(g, np.uint8))) \
            == b"Hello World"
        out["python_lz4"] = None
        out["golden_vector_anchor"] = ok
    return out
