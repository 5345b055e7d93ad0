"""Block-level codec kernels.

Three tiers, one ABI (fixing the reference's ABI drift, SURVEY §2.9.1):

- ``block_ref``   — scalar Python oracle (exact reference-encoder semantics)
- ``native``      — C++ host kernels (production host path, identical output)
- ``encode_xla`` / ``decode_xla`` — device compute path (JAX/XLA); the
  region decode kernel (Pallas/Triton) is ``gpu_decode``

ABI:
  compress_block(src, dst, src_start, src_len, hash_table, dst_off) -> int
  decompress_block(src, src_off, src_len, dst, dst_off, dictionary) -> int
"""

from .block_ref import compress_block_ref, decompress_block_ref

__all__ = ["compress_block_ref", "decompress_block_ref"]
