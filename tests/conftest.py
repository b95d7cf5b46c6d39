"""Test harness: force an 8-device virtual CPU platform before jax imports.

Per SURVEY.md §4: multi-host behavior is tested single-host with
XLA_FLAGS=--xla_force_host_platform_device_count=8 fake meshes.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# the CLI points JAX at the checkout's persistent compile cache; tests run
# without it, so parallel workers never share cache files
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

# Keep the CPU test suite on a 12-slot channel pool: the PRODUCT default
# is the reference's full per-system plan (rx_stream.CHANNEL_PLAN,
# sdrinit.c:41-107), which the CPU backend these tests run on is slow at;
# chip_smoke.py runs the full plans on the GPU. Tests that exercise the
# full plan pass n_slots explicitly.
from gps_jamming_tpu.runtime import rx_stream as _rx_stream

_rx_stream.CHANNEL_PLAN = {k: 12 for k in _rx_stream.CHANNEL_PLAN}


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration test (full receiver loop)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the GPU "
        "checks run through chip_smoke.py)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX runs on {dev.platform}")
    return dev
