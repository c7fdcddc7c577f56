"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so the
multi-device sharding paths are exercised without accelerators (SURVEY.md
§4 — better than the reference, which had no automated distributed
testing). Tests that need a GPU carry the `gpu` marker and skip here; run
them on a machine with a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]
