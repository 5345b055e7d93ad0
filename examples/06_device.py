"""Device path: batched kernels, sharded mesh codec.

This is the path the reference has no analog for — the block codec runs on
the accelerator, data-parallel over every device in the mesh.

Run on a GPU, or small on the CPU (region kernel in interpret mode):
    DIVORTIO_LZ4_INTERPRET=1 JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 python 06_device.py
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4
from divortio_lz4.parallel import (
    ShardedCodec,
    device_compress_frame,
    device_decompress_frame,
    make_mesh,
)

data = np.frombuffer(b"device-side compression payload " * 8000, np.uint8)
cfg = lz4.FrameConfig(block_size=65536, block_independence=True)

# --- single device: batched block kernels + host frame assembly ---
frame = device_compress_frame(data, cfg)
out = device_decompress_frame(np.array(frame))
assert bytes(out) == bytes(data)
print(f"device frame: {len(data)} -> {len(frame)}")

# Frames interoperate with every host tier:
assert bytes(lz4.decompress(np.array(frame))) == bytes(data)

# --- mesh-sharded: blocks data-parallel across devices ---
codec = ShardedCodec(make_mesh())  # all local devices, 1-D "data" axis
frame2 = codec.compress(data)
out2 = codec.decompress(np.array(frame2))
assert bytes(out2) == bytes(data)
print(f"sharded over {codec.ndev} device(s): {len(frame2)} bytes")

# --- kernel-level access (ops/) ---
from divortio_lz4.ops.decode_xla import decode_block_host
from divortio_lz4.ops.encode_xla import encode_block_host

comp = encode_block_host(data[:4096])
plain = decode_block_host(np.asarray(comp), 4096)
assert bytes(plain) == bytes(data[:4096])
print(f"raw device block: 4096 -> {len(comp)}")
