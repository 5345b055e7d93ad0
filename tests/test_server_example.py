"""Dev-server example: streaming GET/POST + TLS parity with the reference."""

import http.client
import ssl
import threading
import time

import numpy as np
import pytest

import divortio_lz4 as lz4


def _start(tls=False, port=18654):
    import importlib.util, os, sys
    spec = importlib.util.spec_from_file_location(
        "srv07", os.path.join(os.path.dirname(__file__), "..",
                              "examples", "07_http_server.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    httpd = mod.serve(port, tls)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    time.sleep(0.2)
    return httpd


def test_server_streaming_roundtrip():
    httpd = _start(port=18654)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", 18654, timeout=10)
        conn.request("GET", "/README.md")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Cross-Origin-Opener-Policy") == "same-origin"
        body = resp.read()
        plain = bytes(lz4.decompress(np.frombuffer(body, np.uint8)))
        with open("/root/repo/README.md", "rb") as f:
            assert plain == f.read()
        # dynamic sample endpoint
        conn.request("GET", "/sample.lz4")
        r2 = conn.getresponse()
        sample = bytes(lz4.decompress(np.frombuffer(r2.read(), np.uint8)))
        assert sample.startswith(b'{"event":"sample","seq":0')
        # streaming upload
        payload = b"upload payload " * 5000
        comp = bytes(lz4.compress(payload))
        conn.request("POST", "/upload", body=comp)
        r3 = conn.getresponse()
        msg = r3.read()
        assert f"{len(payload)} plain".encode() in msg
    finally:
        httpd.shutdown()


def test_server_tls():
    import shutil
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    httpd = _start(tls=True, port=18655)
    try:
        ctx = ssl._create_unverified_context()
        conn = http.client.HTTPSConnection("127.0.0.1", 18655, timeout=10,
                                           context=ctx)
        conn.request("GET", "/README.md")
        resp = conn.getresponse()
        assert resp.status == 200
        plain = bytes(lz4.decompress(np.frombuffer(resp.read(), np.uint8)))
        with open("/root/repo/README.md", "rb") as f:
            assert plain == f.read()
    finally:
        httpd.shutdown()
