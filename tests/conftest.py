"""Test config: the tests run on the CPU backend with an 8-device virtual
mesh, so sharding tests run without accelerator hardware (SURVEY.md §4
implication). `jax.config.update` pins the platform even where the
environment names another one (it is applied before first backend
initialization); the GPU runs through `python chip_smoke.py`."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute sharded tests on the virtual CPU mesh; the "
        "quick loop is `pytest tests/ -q -m 'not slow'`")
