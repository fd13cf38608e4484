"""Test configuration.

The tests run on JAX's CPU backend in float64, with 8 virtual devices for
the mesh tests (``XLA_FLAGS=--xla_force_host_platform_device_count=8``).
The platform is the one ``JAX_PLATFORMS`` names, the CPU when it is unset.
The persistent compile cache stays off.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them elsewhere.  On a machine with a
card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

(the CPU backend stays available for the float64 references).
"""
import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def gpu_device():
    """The GPU a test runs on; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's first device is "
                    f"{dev.platform} (run with JAX_PLATFORMS=cuda,cpu)")
    return dev


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} ({jax.devices()[0].platform})"
