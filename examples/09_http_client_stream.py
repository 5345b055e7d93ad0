"""Streaming download-and-decompress over HTTP.

The analog of the reference's fetch-download recipe
(/root/reference/examples/web/lz4.stream.fetch-download.html): the client
pulls an ``.lz4`` response and decompresses it INCREMENTALLY as network
chunks arrive (constant memory, bytes usable before the download ends),
instead of buffering the whole body.

Self-contained: spins up a local HTTP server that streams a generated
frame in small chunks, then streams it back down through ``LZ4Decoder``.

Run: python examples/09_http_client_stream.py
"""

import http.client
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

PAYLOAD = (b"event,ts,value\n"
           + b"".join(b"sensor-%d,17000%d,%d\n" % (i % 7, i, i * 37 % 1000)
                      for i in range(20000)))


class Lz4Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        frame = bytes(lz4.compress(
            PAYLOAD, config=lz4.FrameConfig(block_size=65536,
                                            content_checksum=True)))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-lz4")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        # stream in small chunks, like a real network
        for i in range(0, len(frame), 4096):
            part = frame[i: i + 4096]
            self.wfile.write(b"%x\r\n" % len(part) + part + b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *a):
        pass


def main():
    server = ThreadingHTTPServer(("127.0.0.1", 0), Lz4Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    conn = http.client.HTTPConnection("127.0.0.1", port)
    conn.request("GET", "/data.lz4")
    resp = conn.getresponse()

    # Incremental decode: every network chunk goes straight through the
    # frame FSM; decoded bytes are usable immediately.
    dec = lz4.LZ4Decoder()
    out = bytearray()
    chunks = 0
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        chunks += 1
        for piece in dec.update(chunk):
            out += bytes(piece)
    server.shutdown()

    assert bytes(out) == PAYLOAD
    print(f"downloaded+decoded {len(out)} B from {chunks} network chunks "
          f"(checksum verified): OK")


if __name__ == "__main__":
    main()
