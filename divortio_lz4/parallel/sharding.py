"""Multi-chip sharded codec: blocks data-parallel over a device mesh.

The scaling design (SURVEY §2.6 / BASELINE config 5): frame blocks shard
across devices along a 1-D "data" mesh axis via shard_map; each device runs
the batched block kernels on its shard; compressed sizes combine with a
psum; the frame is assembled in block order on the host.

Linked mode shards as well: at ENCODE time block i's 64 KB window is the
plaintext immediately before it — known from the input — so every block
carries its window as a per-row history slice and the serial chain
disappears (no cross-device traffic needed; better than the tail-window
ppermute pipeline sketched in SURVEY §2.6 because there is no step
dependency at all). Linked DECODE is truly sequential (block i's window is
block i-1's OUTPUT) and runs on one device.

On one host this also expresses multi-host SPMD: under
jax.distributed.initialize each process holds its local shard of the global
batch and the same psum crosses hosts (see multihost.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import FrameConfig
from ..ops.decode_xla import decode_block
from ..ops.encode_xla import encode_block
from .device import (_FRAME_CHUNK_ROWS, _compress_independent_split,
                     _compress_linked_split, device_compress_frame,
                     device_decompress_frame)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the first n (default: all) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


class ShardedCodec:
    """Data-parallel frame codec over a device mesh.

    compress/decompress mirror the one-shot frame API but run every block
    kernel sharded across the mesh. Block counts are padded to a multiple of
    the mesh size with empty blocks (dropped at assembly).
    """

    def __init__(self, mesh: Optional[Mesh] = None,
                 config: Optional[FrameConfig] = None,
                 use_fingerprints: bool = True,
                 engine: str = "xla"):
        """engine: "xla" (data-parallel XLA kernels on every device) or
        "best" (chain-direct encode — device candidate chains on every
        device, native host select/serialize — and the region decode kernel
        on every device, ops/gpu_decode)."""
        if engine not in ("xla", "best"):
            raise ValueError(f"unknown engine {engine!r}; supported: "
                             "xla, best")
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.ndev = self.mesh.devices.size
        self.config = (config if config is not None
                       else FrameConfig(block_size=65536,
                                        block_independence=True))
        self.use_fingerprints = use_fingerprints
        self.engine = engine
        self._build()

    def _sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis, *spec))

    def _build(self):
        mesh, axis = self.mesh, self.axis
        bs = self.config.resolved_block_size
        use_fp = self.use_fingerprints

        # Encoders are cached per static history length (0 = plain blocks,
        # WINDOW_SIZE = dictionary-warmed blocks).
        self._enc_cache = {}

        def make_enc(hist_len: int):
            def enc_shard(work, lens, hist_start):
                out, out_len = jax.vmap(
                    lambda w, l, h: encode_block(w, l, hist_len, use_fp, h)
                )(work, lens, hist_start)
                total = jax.lax.psum(jnp.sum(out_len), axis)
                return out, out_len, total

            return jax.jit(shard_map(
                enc_shard, mesh=mesh, check_vma=False,
                in_specs=(P(axis, None), P(axis), P(axis)),
                out_specs=(P(axis, None), P(axis), P()),
            ))

        self._make_enc = make_enc

        def dec_shard(comp, lens, hist):
            out, out_len = jax.vmap(
                lambda c, l, h: decode_block(c, l, h, bs))(comp, lens, hist)
            total = jax.lax.psum(jnp.sum(out_len), axis)
            return out, out_len, total

        self._dec = jax.jit(shard_map(
            dec_shard, mesh=mesh, check_vma=False,
            in_specs=(P(axis, None), P(axis), P(axis, None)),
            out_specs=(P(axis, None), P(axis), P()),
        ))

        # chain builders (best engine) per static history length
        self._chain_cache = {}
        self._region_cache = {}

    # -- padding helpers ----------------------------------------------------

    def _pad_rows(self, arr: np.ndarray) -> np.ndarray:
        nb = arr.shape[0]
        rem = (-nb) % self.ndev
        if rem == 0:
            return arr
        pad = np.zeros((rem,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    # -- public API ---------------------------------------------------------

    def compress(self, data, dictionary=None) -> np.ndarray:
        """Compress to a spec-exact LZ4 frame, blocks sharded over devices.

        Linked frames shard too: block i's 64 KB window is plaintext known
        up front, carried per row as a history slice (device.py
        _compress_linked) — the chain parallelizes with no cross-device
        traffic at encode time.
        """
        from ..ops.hybrid_encode import hybrid_max_bs

        if self.engine == "best":
            if self.config.resolved_block_size > hybrid_max_bs():
                from .bigblock import compress_frame_big
                return compress_frame_big(data, self.config, dictionary)
            rows = _FRAME_CHUNK_ROWS * self.ndev
            if self.config.block_independence:
                return _compress_independent_split(
                    data, self.config, dictionary, chains=self._chains,
                    chunk_rows=rows)
            return _compress_linked_split(data, self.config, dictionary,
                                          chains=self._chains,
                                          chunk_rows=rows)

        def encode_batch(work, lens, hist_len, hist_start):
            nb = work.shape[0]
            work_p = self._pad_rows(np.asarray(work))
            lens_p = self._pad_rows(np.asarray(lens))
            hs = np.broadcast_to(
                np.asarray(hist_start, np.int32), (nb,)).copy()
            # Padding rows carry no valid history.
            hs_p = np.full(work_p.shape[0], hist_len, np.int32)
            hs_p[:nb] = hs
            if hist_len not in self._enc_cache:
                self._enc_cache[hist_len] = self._make_enc(hist_len)
            out, out_len, _ = self._enc_cache[hist_len](
                jax.device_put(work_p, self._sharding(None)),
                jax.device_put(lens_p, self._sharding()),
                jax.device_put(hs_p, self._sharding()))
            return out[:nb], out_len[:nb]
        return device_compress_frame(data, self.config,
                                     self.use_fingerprints, encode_batch,
                                     dictionary)

    def _chains(self, work, lens, bs: int, hist_len: int, hist_start):
        """build_dist_chains over the mesh: rows sharded on the data axis,
        staged from host memory straight to each device's shard."""
        nb = work.shape[0]
        hs = np.broadcast_to(np.asarray(hist_start, np.int32), (nb,))
        work_p = self._pad_rows(np.asarray(work, np.int32))
        lens_p = self._pad_rows(np.asarray(lens, np.int32))
        hs_p = self._pad_rows(np.ascontiguousarray(hs))
        key = (hist_len, work_p.shape)
        if key not in self._chain_cache:
            from ..ops.hybrid_encode import build_dist_chains

            axis = self.axis
            self._chain_cache[key] = jax.jit(shard_map(
                lambda w, l, h: build_dist_chains(w, l, hist_len, h),
                mesh=self.mesh, check_vma=False,
                in_specs=(P(axis, None), P(axis), P(axis)),
                out_specs=P(axis, None)))
        out = self._chain_cache[key](
            jax.device_put(work_p, self._sharding(None)),
            jax.device_put(lens_p, self._sharding()),
            jax.device_put(hs_p, self._sharding()))
        return out[:nb]

    def decompress(self, data, verify_checksum: bool = True,
                   dictionary=None) -> np.ndarray:
        """Decompress a frame, blocks sharded over devices."""
        def decode_batch(comp, lens, hist):
            nb = comp.shape[0]
            out, out_len, _ = self._dec(
                jax.device_put(self._pad_rows(np.asarray(comp)),
                               self._sharding(None)),
                jax.device_put(self._pad_rows(np.asarray(lens)),
                               self._sharding()),
                jax.device_put(self._pad_rows(np.asarray(hist)),
                               self._sharding(None)))
            return out[:nb], out_len[:nb]
        if self.engine == "best":
            # The split route: the region kernel over the mesh, or host
            # validation + this sharded XLA decode for blocks the kernel
            # does not take. Output capacity comes from the FRAME header's
            # block size, not this codec's config.
            return device_decompress_frame(
                data, verify_checksum, decode_batch, engine="split",
                dictionary=dictionary, split_sharded=self._decode_regions)
        return device_decompress_frame(data, verify_checksum, decode_batch,
                                       dictionary=dictionary)

    def stage_decode(self, buf: np.ndarray, blocks, header, window=None):
        """Parse a frame body into per-device region plans and put them on
        the mesh: independent blocks split into contiguous runs of equal
        block count, one run per device; a linked frame is one
        region on the first device. Returns (device arrays (meta, recs,
        wire, hist), per-device plaintext lengths, out_len)."""
        from ..ops.gpu_decode import padded_inputs, plan_regions

        bs = header["block_max"]
        dict_len = len(window) if window is not None else 0
        independent = header["independent"]
        if independent:
            cuts = np.linspace(0, len(blocks), self.ndev + 1).round()
            runs = [blocks[int(a): int(b)] for a, b in zip(cuts, cuts[1:])]
        else:
            runs = [list(blocks)] + [[] for _ in range(self.ndev - 1)]
        plans = [plan_regions(buf, r, bs, independent, dict_len)
                 for r in runs]
        padded = [padded_inputs(p, window) for p in plans]
        # one shape for every shard: the largest bucket of each input
        dims = [max(x[i].shape[0] for x in padded) for i in range(3)]
        out_len = max(x[4] for x in padded)
        stacked = [np.stack([np.pad(x[i], [(0, dims[i] - x[i].shape[0])]
                                    + [(0, 0)] * (x[i].ndim - 1))
                             for x in padded]) for i in range(3)]
        hist = padded[0][3]
        args = (jax.device_put(stacked[0], self._sharding(None, None)),
                jax.device_put(stacked[1], self._sharding(None, None)),
                jax.device_put(stacked[2], self._sharding(None)),
                jax.device_put(hist, NamedSharding(self.mesh, P())))
        return args, [p.total for p in plans], out_len

    def _decode_regions(self, buf, blocks, header, window):
        """The region decode kernel over the mesh: one shard_map dispatch,
        one fetch, per-device outputs concatenated in block order."""
        from ..ops.gpu_decode import _region_call
        from ..ops.route import kernel_interpret

        args, totals, out_len = self.stage_decode(buf, blocks, header,
                                                  window)
        key = (tuple(a.shape for a in args), out_len)
        if key not in self._region_cache:
            interpret = kernel_interpret(
                self.mesh.devices.flat[0].platform)
            axis = self.axis
            self._region_cache[key] = jax.jit(shard_map(
                lambda m, r, w, h: _region_call(
                    m[0], r[0], w[0], h, out_len, interpret)[None],
                mesh=self.mesh, check_vma=False,
                in_specs=(P(axis, None, None), P(axis, None, None),
                          P(axis, None), P()),
                out_specs=P(axis, None)))
        out = np.asarray(self._region_cache[key](*args))
        return np.concatenate([out[d, :t] for d, t in enumerate(totals)])
