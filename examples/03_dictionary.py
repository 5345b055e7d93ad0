"""Dictionary compression for small correlated payloads.

Reference counterparts: examples/buffer/lz4.buffer.dictionary.js,
examples/stream/lz4.stream.dictionary.js.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

# Typical use: many small messages share structure; a dictionary seeds the
# 64KB window so each message compresses against shared context.
dictionary = np.frombuffer(
    b'{"event":"page_view","session":"0000000000","user":{"id":0,'
    b'"plan":"free","region":"us-east-1"},"props":{"path":"/","ref":""}}',
    np.uint8)

msg = (b'{"event":"page_view","session":"8f3ka02mz1","user":{"id":4217,'
       b'"plan":"free","region":"us-east-1"},"props":{"path":"/pricing",'
       b'"ref":"newsletter"}}')

plain = lz4.compress(msg)
with_dict = lz4.compress(msg, dictionary=dictionary)
print(f"no dict: {len(plain)}B   with dict: {len(with_dict)}B")
assert len(with_dict) < len(plain)

# The frame records xxh32(dict) as its dictID; decoding without the
# dictionary fails, with the right dictionary round-trips.
restored = bytes(lz4.decompress(with_dict, dictionary=dictionary))
assert restored == msg
try:
    lz4.decompress(with_dict)
except ValueError as e:
    print("without dict:", e)

# Streaming decoder verifies the dictID explicitly:
dec = lz4.LZ4Decoder(dictionary=dictionary)
assert b"".join(bytes(c) for c in dec.update(bytes(with_dict))) == msg
print("streaming dict decode ok")
