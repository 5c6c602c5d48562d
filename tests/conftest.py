"""Test env: unless JAX_PLATFORMS names a platform, run on the CPU with an
8-device virtual mesh, so sharding logic is exercised without a card.
`JAX_PLATFORMS=cuda pytest -m gpu` runs the tests that need a card.

The platform is set via jax.config after import, before first backend use.
The compilation cache follows the package rule (volcanosv_tpu.CACHE_DIR)."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda "
                    "pytest -m gpu)")
    return devs[0]
