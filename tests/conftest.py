"""Test config: JAX runs on the CPU with 8 virtual devices, so sharding
tests run without several cards (SURVEY.md section 4, multi-host strategy).
``JAX_PLATFORMS`` is honoured when set (``JAX_PLATFORMS=cuda`` for the
``-m gpu`` kernel comparisons on a card)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from norlab_icp_mapper_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless the default JAX device is a GPU (decided per test, never
    at import: every pytest worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
