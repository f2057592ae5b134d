"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs on the CPU, with multi-device sharding validated on fake
CPU devices (``xla_force_host_platform_device_count=8``). The backend is
forced to CPU both by ``JAX_PLATFORMS`` and by ``jax.config`` before any
backend starts. What needs the GPU (cuDNN attention, compiled kernels at
full width) is exercised by ``python chip_smoke.py`` on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from intentbev.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)

