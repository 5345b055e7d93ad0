"""Comparator adapter registry + interop recorder."""

import numpy as np

from benchmark.libs import registry, run_interop_check


def test_registry_has_environment_codecs():
    reg = registry()
    assert "divortio-lz4" in reg and "gzip" in reg and "zstd" in reg
    payload = b"registry adapter payload " * 400
    for name, a in reg.items():
        comp = a.compress(payload)
        assert a.decompress(comp) == payload, name


def test_interop_check_records_anchor():
    out = run_interop_check()
    # With python-lz4 present both directions must pass; without it the
    # golden-vector anchor stands in.
    if out["python_lz4"] is not None:
        assert out["python_lz4"]["ours_decoded_by_liblz4"]
        assert out["python_lz4"]["liblz4_decoded_by_us"]
    else:
        assert out["golden_vector_anchor"]
