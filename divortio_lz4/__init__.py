"""divortio_lz4 — an LZ4 Frame/Block codec framework for accelerators.

Brand-new JAX/XLA/Pallas implementation with the full capability surface of
the divortio/divortio-lz4 reference (see SURVEY.md): sync frame codec,
raw block API, stateful streaming, async execution, worker offload, string /
object helpers, xxHash32, dictionaries, linked blocks, checksums — plus a
data-parallel multi-device path the reference can only approximate with a
Web Worker.

API families (mirror of the reference facade, src/lz4.js:27-66):

  Sync        : compress, decompress, compress_raw, decompress_raw
  Streaming   : create_compress_stream, create_decompress_stream,
                LZ4Encoder, LZ4Decoder
  Async       : compress_async, decompress_async,
                create_async_compress_stream, create_async_decompress_stream
  Worker      : LZ4Worker (thread/process offload)
  Type helpers: compress_string, decompress_string,
                compress_object, decompress_object
  Device      : divortio_lz4.parallel (sharded device codec),
                divortio_lz4.ops (XLA/Pallas kernels)
"""

from .config import DEFAULT_CONFIG, FrameConfig
from .frame import compress_frame, decompress_frame
from .raw import compress_raw, decompress_raw
from .types import (
    compress_object,
    compress_string,
    decompress_object,
    decompress_string,
)
from .utils import ensure_buffer
from .xxh import XXHash32, xxhash32
from .backends import available_backends, get_backend

# Try to build/load the native C++ host kernels; fall back silently to the
# Python oracle when the toolchain is unavailable.
try:  # pragma: no cover - exercised implicitly everywhere
    from . import native as _native  # noqa: F401
    NATIVE_AVAILABLE = _native.AVAILABLE
except Exception:  # pragma: no cover
    NATIVE_AVAILABLE = False

# Aliases matching the reference facade naming.
compress = compress_frame
decompress = decompress_frame


def __getattr__(name):
    # Lazy imports for the heavier layers so `import divortio_lz4` stays
    # cheap (streaming/async/worker pull in threading/asyncio; parallel pulls
    # in jax).
    if name in ("LZ4Encoder", "LZ4Decoder", "create_compress_stream",
                "create_decompress_stream", "CompressStream",
                "DecompressStream", "compress_file", "decompress_file"):
        from . import stream
        return getattr(stream, name)
    if name in ("compress_async", "decompress_async",
                "create_async_compress_stream",
                "create_async_decompress_stream", "Scheduler"):
        from . import aio
        return getattr(aio, name)
    if name in ("LZ4Worker",):
        from . import worker
        return getattr(worker, name)
    if name == "parallel":
        from . import parallel
        return parallel
    if name in ("compress_frames", "decompress_frames"):
        # Multi-frame device pipelining: N frames in flight amortize the
        # per-dispatch link latency (parallel/device.py).
        from .parallel.device import (device_compress_frames,
                                      device_decompress_frames)
        return {"compress_frames": device_compress_frames,
                "decompress_frames": device_decompress_frames}[name]
    raise AttributeError(name)


__all__ = [
    "FrameConfig", "DEFAULT_CONFIG",
    "compress", "decompress", "compress_frame", "decompress_frame",
    "compress_raw", "decompress_raw",
    "compress_string", "decompress_string",
    "compress_object", "decompress_object",
    "xxhash32", "XXHash32", "ensure_buffer",
    "available_backends", "get_backend", "NATIVE_AVAILABLE",
]

__version__ = "0.1.0"
