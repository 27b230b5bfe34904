"""Test configuration: an 8-device virtual CPU mesh.

Kernel correctness and multi-device sharding are validated on the CPU
backend (the same XLA programs run on the GPU; chip_smoke.py drives the
compiled kernels and the served path on the card). Tests that need the
card carry the `gpu` marker and skip here (see the `gpu_device`
fixture).
"""
import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

# The suite's own compile cache, apart from the program's default
# (<repo>/.jax_cache): tests compile many small odd shapes.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), ".jax_cache_tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python chip_smoke.py)")
    return dev
