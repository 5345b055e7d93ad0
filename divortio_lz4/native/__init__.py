"""Native host-kernel loader.

Compiles lz4_kernels.cpp with g++ on first import (cached by source mtime),
binds it via ctypes (no pybind11 in this environment), registers the "native"
backend as the default host path, and accelerates the xxHash32 module.

If the toolchain or platform is unavailable, import fails softly and the
framework runs on the Python oracle backend.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

AVAILABLE = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lz4_kernels.cpp")
_LIB = os.path.join(_HERE, "_lz4_kernels.so")


def _build() -> str:
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    # Build to a temp file then atomically rename, so concurrent importers
    # never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return _LIB


_lib = ctypes.CDLL(_build())

_lib.lz4t_xxhash32.restype = ctypes.c_uint32
_lib.lz4t_xxhash32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_uint32]
_lib.lz4t_xxh32_round4.restype = None
_lib.lz4t_xxh32_round4.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64]
_lib.lz4t_warm_table.restype = None
_lib.lz4t_warm_table.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
_lib.lz4t_compress_block.restype = ctypes.c_int64
_lib.lz4t_compress_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64]
_lib.lz4t_decompress_block.restype = ctypes.c_int64
_lib.lz4t_decompress_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64]
_lib.lz4t_compress_frame_body.restype = ctypes.c_int64
_lib.lz4t_compress_frame_body.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
_lib.lz4t_compress_frame_body_mt.restype = ctypes.c_int64
_lib.lz4t_compress_frame_body_mt.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
_lib.lz4t_decompress_frame_body.restype = ctypes.c_int64
_lib.lz4t_decompress_frame_body.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64)]
_lib.lz4t_decompress_frame_body_mt.restype = ctypes.c_int64
_lib.lz4t_decompress_frame_body_mt.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64)]

_lib.lz4t_parse_records2_batch.restype = ctypes.c_int64
_lib.lz4t_parse_records2_batch.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
    ctypes.c_void_p]
_lib.lz4t_free.restype = None
_lib.lz4t_free.argtypes = [ctypes.c_void_p]

_lib.lz4t_chain_serialize16.restype = ctypes.c_int64
_lib.lz4t_chain_serialize16.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p]

_lib.lz4t_chain_serialize16m.restype = ctypes.c_int64
_lib.lz4t_chain_serialize16m.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]

_ERRORS = {
    -1: "LZ4: Output Buffer Too Small",
    -2: "LZ4: Malformed Input",
    -3: "LZ4: Invalid Offset 0",
    -4: "LZ4: Dictionary Offset Out of Bounds",
    -5: "LZ4: Block Checksum Error",
}


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def xxhash32_native(buf: np.ndarray, seed: int = 0) -> int:
    buf = np.ascontiguousarray(buf)
    return int(_lib.lz4t_xxhash32(_ptr(buf), len(buf), seed & 0xFFFFFFFF))


def xxh32_round4_native(v1, v2, v3, v4, words: np.ndarray):
    v = np.array([v1, v2, v3, v4], dtype=np.uint32)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    _lib.lz4t_xxh32_round4(_ptr(v), _ptr(words), len(words))
    return int(v[0]), int(v[1]), int(v[2]), int(v[3])


def warm_table_native(table: np.ndarray, buf, limit: int) -> None:
    assert table.dtype == np.int32 and table.flags.c_contiguous
    buf = np.ascontiguousarray(buf)
    _lib.lz4t_warm_table(_ptr(table), _ptr(buf), limit)


def compress_block_native(src, dst, src_start: int, src_len: int,
                          hash_table: np.ndarray, dst_off: int) -> int:
    src = np.ascontiguousarray(src)
    assert dst.flags.c_contiguous and hash_table.dtype == np.int32
    return int(_lib.lz4t_compress_block(
        _ptr(src), _ptr(dst), src_start, src_len, _ptr(hash_table), dst_off))


def decompress_block_native(src, src_off: int, src_len: int, dst,
                            dst_off: int, dictionary=None) -> int:
    src = np.ascontiguousarray(src)
    assert dst.flags.c_contiguous
    if dictionary is not None:
        dictionary = np.ascontiguousarray(dictionary)
        dptr, dlen = _ptr(dictionary), len(dictionary)
    else:
        dptr, dlen = None, 0
    rc = int(_lib.lz4t_decompress_block(
        _ptr(src), src_off, src_len, _ptr(dst), len(dst), dst_off, dptr, dlen))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, f"LZ4: native error {rc}"))
    return rc


def _nthreads() -> int:
    env = os.environ.get("LZ4T_THREADS")
    if env is not None:
        return max(1, int(env))
    return min(os.cpu_count() or 1, 16)


def compress_frame_body_native(working: np.ndarray, input_start: int,
                               total_end: int, out: np.ndarray, dst_off: int,
                               block_size: int, table: np.ndarray,
                               independent: bool,
                               block_checksums: bool) -> int:
    """Whole-frame block loop in one native call (see lz4_kernels.cpp).

    Independent frames compress blocks thread-parallel (LZ4T_THREADS
    overrides the thread count; wire bytes identical to the serial path).
    *out* must provide the full frame-body worst-case bound plus 16 bytes of
    wild-copy slack beyond dst_off.
    """
    working = np.ascontiguousarray(working)
    assert out.flags.c_contiguous and table.dtype == np.int32
    if independent:
        return int(_lib.lz4t_compress_frame_body_mt(
            _ptr(working), input_start, total_end, _ptr(out), dst_off,
            block_size, _ptr(table), 1 if block_checksums else 0,
            _nthreads()))
    return int(_lib.lz4t_compress_frame_body(
        _ptr(working), input_start, total_end, _ptr(out), dst_off,
        block_size, _ptr(table), 0, 1 if block_checksums else 0))


def decompress_frame_body_native(buf: np.ndarray, pos: int, n: int,
                                 result: np.ndarray, dictionary,
                                 independent: bool, block_checksums: bool,
                                 verify: bool,
                                 block_max: int = 4194304) -> tuple[int, int]:
    """Whole-frame direct-write decode loop in one native call.

    Independent frames decode blocks thread-parallel. Returns
    (plaintext_bytes, wire_end) where wire_end is the position just past the
    EndMark (for the trailing content-checksum read).
    """
    buf = np.ascontiguousarray(buf)
    assert result.flags.c_contiguous
    if dictionary is not None:
        dictionary = np.ascontiguousarray(dictionary)
        dptr, dlen = _ptr(dictionary), len(dictionary)
    else:
        dptr, dlen = None, 0
    wire_end = ctypes.c_int64(pos)
    # MT decode pays an extra scratch write + stitch copy; decode is close
    # to memory-bandwidth-bound, so it only wins with >= 4 cores (measured:
    # 2 threads REGRESS ~30% on a 2-vCPU host).
    if independent and _nthreads() >= 4:
        rc = int(_lib.lz4t_decompress_frame_body_mt(
            _ptr(buf), pos, n, _ptr(result), len(result), dptr, dlen,
            block_max, 1 if block_checksums else 0,
            1 if verify else 0, _nthreads(), ctypes.byref(wire_end)))
    else:
        rc = int(_lib.lz4t_decompress_frame_body(
            _ptr(buf), pos, n, _ptr(result), len(result), dptr, dlen,
            1 if independent else 0, 1 if block_checksums else 0,
            1 if verify else 0, ctypes.byref(wire_end)))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, f"LZ4: native error {rc}"))
    return rc, int(wire_end.value)


def parse_records2_batch_native(buf: np.ndarray, offs: np.ndarray,
                                sizes: np.ndarray, stored: np.ndarray,
                                out_cap: int, dict_len: int,
                                independent: bool):
    """lz4t_parse_records2 over many blocks of *buf* in one call (see
    lz4t_parse_records2_batch): independent blocks parse on the host's
    threads, a linked chain in order. Returns (recs u32[n, 2] with src
    rebased to *buf*, per-block record counts, per-block decoded sizes);
    raises the host error taxonomy of the first failing block."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    stored = np.ascontiguousarray(stored, dtype=np.uint8)
    nb = len(offs)
    counts = np.zeros(nb, np.int64)
    lens = np.zeros(nb, np.int64)
    out = ctypes.c_void_p()
    rc = int(_lib.lz4t_parse_records2_batch(
        _ptr(buf), nb, _ptr(offs), _ptr(sizes), _ptr(stored), out_cap,
        dict_len, 1 if independent else 0, _nthreads(), ctypes.byref(out),
        _ptr(counts), _ptr(lens)))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, "LZ4: Malformed Input"))
    try:
        recs = np.empty((rc, 2), np.uint32)
        if rc:
            ctypes.memmove(recs.ctypes.data, out.value, rc * 8)
    finally:
        _lib.lz4t_free(out)
    return recs, counts, lens


def parse_records2_native(src: np.ndarray, out_cap: int, dict_len: int = 0):
    """One block through lz4t_parse_records2_batch: (recs u32[n, 2],
    out_len), recs[k] = (src, offset | ll<<16 | ml<<24); the record's
    output position is the running sum of (ll+ml)."""
    recs, _, lens = parse_records2_batch_native(
        src, np.zeros(1, np.int64), np.array([len(src)], np.int64),
        np.zeros(1, np.uint8), out_cap, dict_len, True)
    return recs, int(lens[0])


def chain_serialize16_native(work: np.ndarray, hist_len: int, src_len: int,
                             dist16: np.ndarray, out: np.ndarray) -> int:
    """u16 dist-only chain serializer (see lz4t_chain_serialize16): the
    device ships 2 bytes/position and the next match is found by scanning
    for the next nonzero distance. *work* = [history|payload] and MUST
    carry >= 8 readable bytes past hist_len + src_len (the extension
    compares 8-byte words; wrappers pad). Returns bytes written."""
    assert work.dtype == np.uint8 and work.flags.c_contiguous
    assert dist16.dtype == np.uint16 and dist16.flags.c_contiguous
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    assert len(work) >= hist_len + src_len + 8
    assert len(dist16) >= src_len
    return int(_lib.lz4t_chain_serialize16(
        _ptr(work), hist_len, src_len, _ptr(dist16), _ptr(out)))


def chain_serialize16_meta_native(work: np.ndarray, hist_len: int,
                                  src_len: int, dist16: np.ndarray,
                                  out: np.ndarray):
    """chain_serialize16_native + the big-block splicer's meta lanes
    (trailing-token pos, trailing lit count, last-match stream offset or
    -1, last-match output anchor or -1 — see lz4t_chain_serialize16m).
    Returns (bytes_written, meta i64[4])."""
    assert work.dtype == np.uint8 and work.flags.c_contiguous
    assert dist16.dtype == np.uint16 and dist16.flags.c_contiguous
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    assert len(work) >= hist_len + src_len + 8
    assert len(dist16) >= src_len
    meta = (ctypes.c_int64 * 4)()
    n = int(_lib.lz4t_chain_serialize16m(
        _ptr(work), hist_len, src_len, _ptr(dist16), _ptr(out), meta))
    return n, np.array(meta[:], np.int64)


# --- Registration ---
from ..backends import Backend, register_backend  # noqa: E402

register_backend(Backend(
    "native",
    compress_block=compress_block_native,
    decompress_block=decompress_block_native,
    warm_table=warm_table_native,
    compress_frame_body=compress_frame_body_native,
    decompress_frame_body=decompress_frame_body_native,
), make_default=True)

from ..xxh import xxhash32 as _xxh_module_hook  # noqa: E402
import importlib  # noqa: E402

_xxh_mod = importlib.import_module("divortio_lz4.xxh.xxhash32")
_xxh_mod._native_oneshot = xxhash32_native
_xxh_mod._native_round4 = xxh32_round4_native

AVAILABLE = True
