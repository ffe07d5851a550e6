"""Test config: force CPU with 8 virtual devices so sharding tests run
anywhere ('multi-node without a cluster', SURVEY.md §4)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless the caller names a platform (``JAX_PLATFORMS=cuda`` for the
# tests marked ``gpu``)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects it")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (the gpu fixture "
        "decides at run time)")


@pytest.fixture()
def gpu():
    """The default JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run "
                    "with JAX_PLATFORMS=cuda python -m pytest -m gpu")
    return dev


@pytest.fixture(scope="session")
def cornell_scene():
    from vkrt.scene import load_cornell

    return load_cornell()


@pytest.fixture(scope="session")
def procedural_cornell():
    from vkrt.scene import make_cornell_box

    return make_cornell_box()


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
