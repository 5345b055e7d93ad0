"""File-object (blob-style) streaming: snapshot a file on disk, stream it
through the compressor without loading it whole, pipe to a second file.

Reference counterpart: examples/stream/lz4.stream.node-blob.js — there
`fs.openAsBlob` wraps a disk file as a Blob whose `.stream()` feeds
`LZ4.compressStream()` into a write stream. Python's analog of that
"file object snapshot" is an opened binary file handle read in chunks;
the library's CompressStream/DecompressStream are the TransformStream
analogs, and `pipe()` accepts any chunk iterable.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4


def file_chunks(path, chunk_size=64 * 1024):
    """A Blob.stream()-style chunk iterator over a file on disk."""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return
            yield chunk


with tempfile.TemporaryDirectory() as tmp:
    input_file = os.path.join(tmp, "blob_input.txt")
    compressed_file = os.path.join(tmp, "blob_output.lz4")
    restored_file = os.path.join(tmp, "blob_restored.txt")

    # 1. Setup: a source file on disk (the reference writes 10k lines).
    with open(input_file, "wb") as f:
        f.write(b"Modern file-object streaming... \n" * 10000)
    original_size = os.path.getsize(input_file)
    print(f"Created source file: {input_file} ({original_size} bytes)")

    # 2+3. The stream pipeline: file snapshot -> compressor -> file.
    # No full-file buffer exists at any point; state is O(64 KB window).
    with open(compressed_file, "wb") as dst:
        for out in lz4.CompressStream().pipe(file_chunks(input_file)):
            dst.write(bytes(out))

    compressed_size = os.path.getsize(compressed_file)
    print("Compression complete!")
    print(f"Original:   {original_size} bytes")
    print(f"Compressed: {compressed_size} bytes")
    print(f"Ratio:      {compressed_size / original_size * 100:.2f}%")

    # 4. Stream it back (file -> decompressor -> file) and verify.
    with open(restored_file, "wb") as dst:
        for out in lz4.DecompressStream().pipe(file_chunks(compressed_file)):
            dst.write(bytes(out))
    with open(input_file, "rb") as a, open(restored_file, "rb") as b:
        assert a.read() == b.read(), "round-trip mismatch"
    print("Round-trip verified bit-exact.")
