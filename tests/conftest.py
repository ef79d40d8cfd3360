"""Test configuration: run on CPU with 8 virtual devices so multi-device sharding
paths can be exercised without a GPU (SURVEY.md section 7)."""

import os

# Force CPU even when the environment pre-sets JAX_PLATFORMS: unit tests run
# locally; the GPU path is exercised by chip_smoke.py and bench.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# An explicit config update is authoritative over any platform plugin that
# registers itself at import.
jax.config.update("jax_platforms", "cpu")

from smoqyelphqmc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the suite re-traces many identical programs
# across test files; caching compiled executables across runs (and across tests
# in one run) cuts wall time substantially.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
