"""Batched decode of independent blocks through the region kernel
(ops/gpu_decode), single-device and sharded over a mesh, on mixed-density
corpora, plus hostile-record containment."""

import jax.numpy as jnp
import numpy as np

import divortio_lz4 as lz4
from divortio_lz4.config import FrameConfig
from divortio_lz4.frame import decompress_frame
from divortio_lz4.ops.gpu_decode import (
    Plan, decode_blocks, decode_regions, padded_inputs, plan_regions)
from divortio_lz4.parallel.device import parse_block_index


def _mixed_blocks(bs=16384, nb=20, seed=3):
    """Sparse JSON + mid/dense random-alphabet rows (2-3 density tiers
    under the padded planner; the compact path runs them all at one
    ways)."""
    rng = np.random.default_rng(seed)
    rec = b'{"id":%d,"name":"user","tags":["a","b"],"ok":true}\n'
    blocks = []
    for i in range(nb):
        if i % 5 == 3:
            blocks.append(rng.integers(0, 16, bs).astype(np.uint8))
        elif i % 5 == 4:
            blocks.append(rng.integers(0, 4, bs).astype(np.uint8))
        else:
            blocks.append(np.frombuffer(
                ((rec % i) * (bs // len(rec % i) + 1))[:bs], np.uint8))
    return blocks


def test_dispatch_compact_mixed_density_bit_exact():
    bs = 16384
    blocks = _mixed_blocks(bs)
    comps = [np.asarray(lz4.compress_raw(p)) for p in blocks]
    for got, p in zip(decode_blocks(comps, bs), blocks):
        np.testing.assert_array_equal(got, p)


def test_sharded_compact_roundtrip_mixed_density():
    from divortio_lz4.parallel.sharding import ShardedCodec, make_mesh
    plain = np.concatenate(_mixed_blocks(16384, 20))
    for ndev in (2, 8):
        codec = ShardedCodec(make_mesh(ndev),
                             FrameConfig(block_size=16384,
                                         block_independence=True),
                             engine="best")
        frame = codec.compress(plain)
        out = codec.decompress(np.array(frame))
        np.testing.assert_array_equal(np.asarray(out), plain)
        # cross-check against the host decoder
        np.testing.assert_array_equal(decompress_frame(np.array(frame)),
                                      plain)


def test_sharded_compact_dictionary():
    from divortio_lz4.parallel.sharding import ShardedCodec, make_mesh
    plain = np.concatenate(_mixed_blocks(16384, 12, seed=9))
    d = plain[:9000]
    cfg = FrameConfig(block_size=16384, block_independence=True)
    frame = lz4.compress(plain, dictionary=d, config=cfg)
    codec = ShardedCodec(make_mesh(2), cfg, engine="best")
    out = codec.decompress(np.asarray(frame), dictionary=d)
    np.testing.assert_array_equal(np.asarray(out), plain)


def test_stage_sharded_compact_shard_streams_are_local():
    """Each shard's staged records index only its own wire slice and its
    regions only its own output — the invariants the SPMD dispatch relies
    on — and the shards sit on distinct devices."""
    from divortio_lz4.parallel.sharding import ShardedCodec, make_mesh
    bs = 16384
    plain = np.concatenate(_mixed_blocks(bs, 24, seed=5))
    cfg = FrameConfig(block_size=bs, block_independence=True)
    frame = np.asarray(lz4.compress(plain, config=cfg))
    header, blocks, _ = parse_block_index(frame)
    codec = ShardedCodec(make_mesh(4), cfg, engine="best")
    (meta, recs, wire, hist), totals, out_len = codec.stage_decode(
        frame, blocks, header)
    assert sum(totals) == len(plain)
    assert len({s.device for s in wire.addressable_shards}) == 4
    meta, recs, wire = (np.asarray(x) for x in (meta, recs, wire))
    assert meta.shape[0] == recs.shape[0] == wire.shape[0] == 4
    for d in range(4):
        m = meta[d][meta[d][:, 1] > 0]
        assert (m[:, 0] + m[:, 1] <= recs.shape[1]).all()
        assert (m[:, 2] + m[:, 3] <= totals[d]).all()
        used = np.concatenate([np.arange(a, a + n) for a, n in m[:, :2]])
        assert (recs[d][used, 0] < wire.shape[1]).all()


def test_stage_compact_dense_group_respects_smem_budget():
    """Dense 64 KB blocks (~15k records each — the densest class a block
    can hold) decode bit-exact in one dispatch."""
    rng = np.random.default_rng(7)
    bs = 65536
    blocks = [rng.integers(0, 4, bs).astype(np.uint8) for _ in range(4)]
    comps = [np.asarray(lz4.compress_raw(p)) for p in blocks]
    assert all(len(c) < bs for c in comps)
    for got, p in zip(decode_blocks(comps, bs), blocks):
        np.testing.assert_array_equal(got, p)


def test_compact_kernel_hostile_records_stay_bounded():
    """Garbage record words in one region (the attacker controls only wire
    bytes, but the kernel must not trust records either) stay inside that
    region: every field is clamped, and the other region decodes exact."""
    rng = np.random.default_rng(11)
    good = np.asarray(make_blocks_good())
    comp = np.asarray(lz4.compress_raw(good))
    plan = plan_regions(comp, [(0, len(comp), False)], 4096)
    n_bad = 64
    bad = rng.integers(-2**31, 2**31, (n_bad, 2),
                       dtype=np.int64).astype(np.int32)
    recs = np.concatenate([bad, plan.recs])
    meta = np.array([[0, n_bad, 0, 3000],
                     [n_bad, len(plan.recs), 3000, plan.total]], np.int32)
    hostile = Plan(plan.wire, recs, meta, 3000 + plan.total)
    m, r, w, h, out_len = padded_inputs(hostile)
    out = np.asarray(decode_regions(jnp.asarray(m), jnp.asarray(r),
                                    jnp.asarray(w), jnp.asarray(h),
                                    out_len))
    assert out.shape == (out_len,)
    np.testing.assert_array_equal(out[3000: 3000 + plan.total], good)


def make_blocks_good():
    rec = b'{"id":7,"name":"user","tags":["a","b"],"ok":true}\n'
    return np.frombuffer((rec * 80)[:4000], np.uint8)
