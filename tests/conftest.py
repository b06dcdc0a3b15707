"""Test harness: run all tests on the JAX CPU backend with 8 virtual devices
so multi-chip sharding paths (parallel/) are exercised without accelerators.

Pytest plugin autoload can import jax before this conftest runs, which locks
in env-derived config defaults — so the platform is also forced through
jax.config (effective until the first backend initialization).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_platform_name", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # older jax: XLA_FLAGS fallback above covers it

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_backend():
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}"
    )
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)
