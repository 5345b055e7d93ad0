"""Multi-host orchestration: pod-scale data-parallel frame compression.

BASELINE config 5 / SURVEY §7 Phase 3: each host compresses its contiguous
shard of the corpus on its local devices; compressed shard sizes are
all-gathered across processes; host 0 assembles the frames in corpus
order. Every shard is an independent, self-terminating LZ4 frame, so the
concatenation decodes with any spec decoder — including the reference's
streaming decoder, which handles concatenated frames natively
(/root/reference/src/shared/lz4Decode.js:262-267).

Runs unchanged with one process (degenerates to the single-host path); under
`jax.distributed.initialize` each process takes its process_index-th shard.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from ..config import FrameConfig
from ..utils import ensure_buffer
from .sharding import ShardedCodec, make_mesh


def maybe_distributed_init() -> bool:
    """Initialize the JAX distributed runtime when the standard env is set.

    Returns True when running multi-process. Safe to call repeatedly.
    """
    if jax.process_count() > 1:
        return True
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
        return True
    return False


def shard_bounds(total: int, nshards: int, i: int) -> tuple[int, int]:
    """Contiguous even split of [0, total) into nshards pieces."""
    base = total // nshards
    rem = total % nshards
    start = i * base + min(i, rem)
    return start, start + base + (1 if i < rem else 0)


def split_frames(buf: np.ndarray) -> list[tuple[int, int]]:
    """Split a concatenated-frames stream into [start, end) frame spans.

    O(total blocks) host scan via parse_block_index (size words only);
    skippable frames are skipped. The spans are the unit of cross-process
    decode partitioning.
    """
    from ..constants import SKIPPABLE_MAGIC_MAX, SKIPPABLE_MAGIC_MIN
    from ..utils import read_u32le
    from .device import parse_block_index

    frames: list[tuple[int, int]] = []
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        word = read_u32le(buf, pos)
        if SKIPPABLE_MAGIC_MIN <= word <= SKIPPABLE_MAGIC_MAX:
            if pos + 8 > n:
                raise ValueError("LZ4: Malformed Input")
            pos += 8 + read_u32le(buf, pos + 4)
            continue
        header, _, tail = parse_block_index(buf[pos:])
        end = pos + tail + (4 if header["content_checksum"] else 0)
        frames.append((pos, end))
        pos = end
    return frames


class MultiHostCodec:
    """Pod-scale codec: per-process shard compression + ordered assembly."""

    def __init__(self, config: Optional[FrameConfig] = None,
                 use_fingerprints: bool = True):
        self.nproc = jax.process_count()
        self.pid = jax.process_index()
        # Local mesh over this process's devices only.
        local = make_mesh()
        self.codec = ShardedCodec(local, config, use_fingerprints)

    def compress_corpus(self, data) -> Optional[bytes]:
        """Compress *data* pod-wide; returns the full byte stream on process
        0 (None elsewhere). *data* must be identically available on every
        process (e.g. a shared filesystem read)."""
        raw = ensure_buffer(data)
        start, end = shard_bounds(len(raw), self.nproc, self.pid)
        local_frame = np.asarray(self.codec.compress(raw[start:end]),
                                 dtype=np.uint8)

        if self.nproc == 1:
            return bytes(local_frame)

        # All-gather variable-size shard frames across hosts: first the
        # sizes, then the padded payloads.
        from jax.experimental import multihost_utils as mhu
        sizes = mhu.process_allgather(np.array([len(local_frame)], np.int64))
        sizes = np.asarray(sizes).reshape(-1)
        cap = int(sizes.max())
        padded = np.zeros(cap, np.uint8)
        padded[: len(local_frame)] = local_frame
        gathered = np.asarray(mhu.process_allgather(padded))
        if self.pid != 0:
            return None
        return b"".join(bytes(gathered[i, : int(sizes[i])])
                        for i in range(self.nproc))

    def decompress_corpus(self, stream: bytes) -> Optional[np.ndarray]:
        """Decode a concatenated-frames stream pod-wide on DEVICES.

        Frames are split by an O(nblocks) host scan, partitioned
        contiguously across processes, each process block-decodes its
        shard on its local device mesh (ShardedCodec — blocks sharded over
        devices), and the plaintext shards are all-gathered in corpus
        order. Both directions of the pod path are now device compute —
        the reference's worker offloads both too (lz4.worker.js:30-85).
        """
        buf = ensure_buffer(stream)
        frames = split_frames(buf)
        start, end = shard_bounds(len(frames), self.nproc, self.pid)
        local_parts = [
            np.asarray(self.codec.decompress(np.array(buf[a:b])),
                       dtype=np.uint8)
            for a, b in frames[start:end]]
        local = (np.concatenate(local_parts) if local_parts
                 else np.empty(0, np.uint8))

        if self.nproc == 1:
            return local

        from jax.experimental import multihost_utils as mhu
        sizes = mhu.process_allgather(np.array([len(local)], np.int64))
        sizes = np.asarray(sizes).reshape(-1)
        cap = max(int(sizes.max()), 1)
        padded = np.zeros(cap, np.uint8)
        padded[: len(local)] = local
        gathered = np.asarray(mhu.process_allgather(padded))
        return np.concatenate([gathered[i, : int(sizes[i])]
                               for i in range(self.nproc)])
