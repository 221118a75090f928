"""Test configuration: CPU runs get a virtual 8-device CPU mesh.

Run the CPU tests with ``JAX_PLATFORMS=cpu``; sharding/collective tests
fake a mesh with 8 virtual CPU devices.  Tests that need the GPU are
marked ``gpu`` and take the ``gpu`` fixture, which skips them when JAX
finds no GPU (run them on the card with ``python -m pytest -m gpu
tests/test_gpu.py``).
"""

import os

import numpy as np
import pytest

import jax

jax.config.update("jax_num_cpu_devices", 8)

from ft8_demodulator_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test when there is none."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run: python -m pytest -m gpu "
                    "tests/test_gpu.py)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def goldens():
    """Golden fixtures generated once from the reference implementation."""
    path = os.path.join(os.path.dirname(__file__), "goldens", "protocol_goldens.npz")
    return np.load(path)


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same fresh stream, so outcomes
    # never depend on which other tests ran first
    return np.random.default_rng(1234)
