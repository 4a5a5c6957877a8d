"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors SURVEY.md §4's implication: the reference has no multi-node tests;
we test multi-device behavior without several devices by forcing the host
platform to expose 8 virtual devices.  float64 is enabled so numeric parity
tests can compare against high-precision references.

``CAR_RACING_TEST_PLATFORM`` (default ``cpu``): any other value keeps the
platform JAX finds and leaves x64 off — how ``chip_smoke.py`` runs the
``gpu``-marked tier in its own process on the card.  Tests marked ``gpu``
skip, by the fixture below, unless the first device is a GPU.
"""

import os

_FORCE_CPU = os.environ.get("CAR_RACING_TEST_PLATFORM", "cpu") == "cpu"

if _FORCE_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if _FORCE_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(scope="session")
def repo_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _chdir_repo_root(monkeypatch, repo_root):
    """Data paths are repo-root relative (like the reference's cwd-relative
    CSV loads, base.py:124-125)."""
    monkeypatch.chdir(repo_root)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """``gpu``-marked tests need a GPU; decided here, at run time."""
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {jax.devices()[0].platform})")
