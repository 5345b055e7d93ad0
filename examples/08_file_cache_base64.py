"""Compressed key-value cache with text-safe encoding.

The analog of the reference's localStorage recipe
(/root/reference/examples/buffer/lz4.buffer.localstorage.js): values are
LZ4-compressed and base64-encoded so they survive any text-only store —
here a JSON file on disk standing in for localStorage; the same functions
work against Redis strings, cookies, environment blobs, or spreadsheet
cells.

Run: python examples/08_file_cache_base64.py
"""

import base64
import json
import tempfile
from pathlib import Path

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4


class CompressedFileCache:
    """A tiny persistent string cache; values stored LZ4+base64."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._data = {}
        if self.path.exists():
            self._data = json.loads(self.path.read_text())

    def set(self, key: str, value: str) -> None:
        comp = lz4.compress_string(value)
        self._data[key] = base64.b64encode(bytes(comp)).decode("ascii")
        self.path.write_text(json.dumps(self._data))

    def get(self, key: str) -> str | None:
        b64 = self._data.get(key)
        if b64 is None:
            return None
        return lz4.decompress_string(
            np.frombuffer(base64.b64decode(b64), np.uint8))


def main():
    with tempfile.TemporaryDirectory() as d:
        cache = CompressedFileCache(Path(d) / "cache.json")
        doc = ("The quick brown fox jumps over the lazy dog. " * 400
               + "Tail that does not repeat: 0123456789.")
        cache.set("article:42", doc)

        raw_len = len(doc.encode())
        stored_len = len(cache._data["article:42"])
        print(f"plain {raw_len} B -> stored (lz4+base64) {stored_len} B "
              f"({stored_len / raw_len:.1%})")

        # fresh instance = reload from disk, like a new browser session
        cache2 = CompressedFileCache(Path(d) / "cache.json")
        assert cache2.get("article:42") == doc
        assert cache2.get("missing") is None
        print("round-trip through the text store: OK")


if __name__ == "__main__":
    main()
