"""String/object type helper tests (parity with tests/types/types.test.mjs)."""

import pytest

from divortio_lz4 import (
    compress_object,
    compress_string,
    decompress_object,
    decompress_string,
)


def test_string_roundtrip():
    s = "The quick brown fox jumps over the lazy dog. " * 40
    assert decompress_string(compress_string(s)) == s


def test_string_roundtrip_emoji():
    s = "Unicode: éèê 你好 \U0001F680\U0001F9E0" * 10
    assert decompress_string(compress_string(s)) == s


def test_object_roundtrip():
    obj = {"users": [{"id": i, "name": f"user{i}", "tags": ["a", "b"]}
                     for i in range(50)],
           "nested": {"deep": {"value": 3.14159, "flag": True, "none": None}}}
    assert decompress_object(compress_object(obj)) == obj


def test_object_array_roundtrip():
    obj = [1, 2.5, "three", None, True, {"k": "v"}]
    assert decompress_object(compress_object(obj)) == obj


def test_unserializable_object_raises():
    with pytest.raises(ValueError, match="JSON"):
        compress_object({"bad": object()})
