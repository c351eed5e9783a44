"""Test configuration: run on CPU with a virtual 8-device mesh.

The tests run on the CPU backend with 8 host devices
(``jax_num_cpu_devices``), the standard JAX pattern for testing
``Mesh``/``shard_map`` code on one host. Tests that need the card carry the
``gpu`` marker and take the ``gpu`` fixture, which skips them here; on the
card, ``chip_smoke.py`` runs the same checks in-process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped elsewhere (chip_smoke.py runs "
                   "the same check on the card)")


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise.
    Decided when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (runs on the card through chip_smoke.py)")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)
