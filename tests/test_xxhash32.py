"""xxHash32 unit tests with known vectors.

Vector parity: /root/reference/tests/xxhash32/xxhash32.test.mjs:13-28 and
the streaming equivalence suite xxhash32Stateful.test.mjs:18-79.
"""

import numpy as np
import pytest

from divortio_lz4 import XXHash32, xxhash32


def test_empty_vector():
    assert xxhash32(b"") == 0x02CC5D05


def test_hello_world_vector():
    assert xxhash32(b"Hello World") == 0xB1FD16EE


def test_seed_sensitivity():
    h0 = xxhash32(b"data", 0)
    h1 = xxhash32(b"data", 1)
    h2 = xxhash32(b"data", 0xFFFFFFFF)
    assert h0 != h1 and h1 != h2 and h0 != h2


def test_accepts_many_input_types():
    assert xxhash32("Hello World") == 0xB1FD16EE
    assert xxhash32(np.frombuffer(b"Hello World", dtype=np.uint8)) == 0xB1FD16EE
    assert xxhash32(bytearray(b"Hello World")) == 0xB1FD16EE


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 31, 32, 100, 1000, 4096])
def test_streaming_matches_oneshot_whole(n):
    data = (np.arange(n, dtype=np.int64) * 131 % 251).astype(np.uint8)
    h = XXHash32(7).update(data).digest()
    assert h == xxhash32(data, 7)


def test_streaming_matches_oneshot_split():
    data = np.frombuffer(b"The quick brown fox jumps over the lazy dog" * 9,
                         dtype=np.uint8)
    one = xxhash32(data)
    h = XXHash32()
    third = len(data) // 3
    h.update(data[:third]).update(data[third:2 * third]).update(data[2 * third:])
    assert h.digest() == one


def test_streaming_byte_by_byte():
    data = b"incremental hashing one byte at a time"
    h = XXHash32()
    for i in range(len(data)):
        h.update(data[i:i + 1])
    assert h.digest() == xxhash32(data)


def test_digest_is_nondestructive_peek():
    # xxhash32Stateful.test.mjs:61-79 — digest() between updates must not
    # perturb state.
    data = b"0123456789abcdef0123456789abcdef-tail"
    h = XXHash32()
    h.update(data[:10])
    mid1 = h.digest()
    mid2 = h.digest()
    assert mid1 == mid2 == xxhash32(data[:10])
    h.update(data[10:])
    assert h.digest() == xxhash32(data)


def test_streaming_seeded():
    data = b"seeded streaming equivalence check payload 123456"
    assert XXHash32(12345).update(data).digest() == xxhash32(data, 12345)


def test_reset():
    h = XXHash32()
    h.update(b"garbage")
    h.reset()
    h.update(b"Hello World")
    assert h.digest() == 0xB1FD16EE
