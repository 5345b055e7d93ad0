"""Dev HTTP(S) server streaming LZ4-compressed responses.

Reference counterpart: examples/web/lz4.web-server.js — a zero-dependency
TLS-or-plain static server with cross-origin-isolation headers (:70-78),
a STREAMING POST /upload that decodes as chunks arrive (:91-111), and a
dynamic /sample.lz4 generated through the compress stream (:114-141).
Python analog, feature for feature:

    python examples/07_http_server.py [port]            # plain HTTP
    python examples/07_http_server.py [port] --tls      # self-signed TLS
    curl -sk https://localhost:8654/sample.lz4 | \
        python -m divortio_lz4 decompress /dev/stdin -o -
"""

import os
import ssl
import subprocess
import sys
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_self_signed_cert() -> tuple[str, str]:
    """One-shot self-signed cert for the dev server (the reference ships
    PEMs next to the server; this generates them on demand)."""
    d = tempfile.mkdtemp(prefix="lz4srv")
    crt, key = os.path.join(d, "crt.pem"), os.path.join(d, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", crt, "-days", "2", "-nodes", "-subj", "/CN=localhost"],
        check=True, capture_output=True)
    return crt, key


class LZ4Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _isolation_headers(self):
        # COOP/COEP — the SharedArrayBuffer-enabling headers of the
        # reference server (lz4.web-server.js:70-78), kept for parity.
        self.send_header("Cross-Origin-Opener-Policy", "same-origin")
        self.send_header("Cross-Origin-Embedder-Policy", "require-corp")

    def do_GET(self):
        if self.path == "/sample.lz4":
            return self._sample()
        path = os.path.normpath(os.path.join(ROOT, self.path.lstrip("/")))
        if not path.startswith(ROOT) or not os.path.isfile(path):
            self.send_error(404)
            return
        stream = lz4.CompressStream(lz4.FrameConfig(block_size=65536,
                                                    content_checksum=True))
        self.send_response(200)
        self._isolation_headers()
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Content-Encoding", "lz4-frame")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 16)
                if not chunk:
                    break
                out = stream.write(chunk)
                if out:
                    self._chunk(out)
        self._chunk(stream.flush())
        self._chunk(b"")

    def _sample(self):
        """Dynamic sample generated through the compress stream
        (lz4.web-server.js:114-141)."""
        record = (b'{"event":"sample","seq":%d,"payload":"' +
                  b"x" * 64 + b'"}\n')
        stream = lz4.CompressStream(lz4.FrameConfig(block_size=65536))
        self.send_response(200)
        self._isolation_headers()
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for i in range(2000):
            out = stream.write(record % i)
            if out:
                self._chunk(out)
        self._chunk(stream.flush())
        self._chunk(b"")

    def _chunk(self, data: bytes):
        if data:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        else:
            self.wfile.write(b"0\r\n\r\n")

    def do_POST(self):
        if self.path != "/upload":
            self.send_error(404)
            return
        # STREAMING upload decode: chunks feed the FSM as they arrive
        # (lz4.web-server.js:91-111) — the whole body is never buffered.
        dec = lz4.DecompressStream()
        remaining = int(self.headers.get("Content-Length", 0))
        plain = comp = 0
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 16))
            if not chunk:
                break
            remaining -= len(chunk)
            comp += len(chunk)
            plain += len(dec.write(chunk))
        self.send_response(200)
        self._isolation_headers()
        body = f"received {comp} compressed / {plain} plain bytes\n".encode()
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        print(f"[lz4-server] {fmt % args}", file=sys.stderr)


def serve(port: int = 8654, tls: bool = False) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("127.0.0.1", port), LZ4Handler)
    if tls:
        crt, key = make_self_signed_cert()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(crt, key)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    return httpd


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    port = int(args[0]) if args else 8654
    tls = "--tls" in sys.argv
    print(f"serving {ROOT} LZ4-compressed on "
          f"{'https' if tls else 'http'}://127.0.0.1:{port}", file=sys.stderr)
    serve(port, tls).serve_forever()
