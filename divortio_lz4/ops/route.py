"""The one place that maps a platform to a kernel route.

On a GPU, Pallas kernels are compiled (Triton). On the CPU they run in
Pallas interpret mode, and only when the caller has opted in by setting
``DIVORTIO_LZ4_INTERPRET=1`` in the environment (the test suite does). Any
other platform is an error: no path falls back to the interpreter, or to
the host tier, by itself.
"""

from __future__ import annotations

import os

import jax

INTERPRET_ENV = "DIVORTIO_LZ4_INTERPRET"


def kernel_interpret(platform: str | None = None) -> bool:
    """Whether Pallas kernels on *platform* (default: the first device's)
    run in interpret mode. Raises where no route exists."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        if os.environ.get(INTERPRET_ENV) == "1":
            return True
        raise RuntimeError(
            "LZ4 device kernels need a GPU; to run them in Pallas interpret "
            f"mode on the CPU, set {INTERPRET_ENV}=1")
    raise RuntimeError(f"no LZ4 kernel route for platform {platform!r}")
