"""Test harness configuration.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise, on a
virtual 8-device mesh so the multi-device sharding paths are exercised
without cards (SURVEY §4: multi-device simulation via a fake-device mesh),
and opts in to Pallas interpret mode for the device kernels on the CPU
(ops/route.py). Must run before any module imports jax.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on a
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("DIVORTIO_LZ4_INTERPRET", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from divortio_lz4.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other platforms)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless the first device is a GPU —
    decided per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def rng():
    return np.random.default_rng(0xD1507)


def make_compressible(n: int, rng=None) -> np.ndarray:
    """Synthetic compressible corpus: repeated JSON-ish event records
    (benchmark/src/base/benchUtils.js:7-22 analog)."""
    rng = rng or np.random.default_rng(42)
    record = (b'{"ts":1700000000,"level":"info","service":"api-gateway",'
              b'"msg":"request completed","status":200,"latency_ms":42,'
              b'"path":"/v1/users/12345","trace":"abcdef0123456789"}\n')
    reps = -(-n // len(record))
    return np.frombuffer((record * reps)[:n], dtype=np.uint8)


@pytest.fixture
def compressible():
    return make_compressible
