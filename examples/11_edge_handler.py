"""Edge-function-style handler: proxy an origin response, compressing its
body stream on the fly, and let the "client" stream-decode the result.

Reference counterpart: examples/stream/lz4.stream.cloudflare-worker.js —
a Worker fetch handler that pipes `originResponse.body` through
`LZ4.compressStream()` into a new Response with `Content-Encoding: lz4`
and no Content-Length. The Python analogs: a Response carrying a chunk
iterator for its body, the handler wrapping it with CompressStream, and
the client draining the stream through DecompressStream.
(The in-repo HTTP versions of this pattern: examples/07_http_server.py
serves /sample.lz4 through the stream API; 09_http_client_stream.py is
the fetch-and-decode client.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4 as lz4


class Response:
    """Minimal Response: status, headers, and a streaming body iterator."""

    def __init__(self, body_iter, status=200, headers=None):
        self.body = body_iter
        self.status = status
        self.headers = dict(headers or {})


def mock_origin_response():
    """An origin whose body arrives as a stream of chunks."""
    def stream():
        text = b"Edge computing allows for low-latency transformations... "
        for i in range(5):
            yield text + b"(Chunk %d)\n" % i
    return Response(stream(), headers={"Content-Type": "text/plain"})


def handle_request(request_url):
    """The edge handler: origin -> compress -> user, all streaming."""
    origin = mock_origin_response()
    print(f"[Edge] origin responded: {origin.status} for {request_url}")

    headers = dict(origin.headers)
    headers["Content-Encoding"] = "lz4"
    headers.pop("Content-Length", None)  # unknown once streaming

    compressed = lz4.CompressStream().pipe(origin.body)
    return Response(compressed, status=origin.status, headers=headers)


# --- Run the simulation ---
res = handle_request("https://api.example.com/data")
print(f"[Client] received headers: {res.headers}")

# The client drains the compressed stream and decodes it incrementally.
decoder = lz4.DecompressStream()
total_wire = 0
plain = b""
for chunk in res.body:
    total_wire += len(chunk)
    plain += decoder.write(bytes(chunk))

expected = b"".join(
    b"Edge computing allows for low-latency transformations... "
    b"(Chunk %d)\n" % i for i in range(5))
assert plain == expected, "edge round-trip mismatch"
print(f"[Client] decoded {len(plain)} bytes from {total_wire} wire bytes "
      "— content verified.")
