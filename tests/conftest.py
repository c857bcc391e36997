"""Test configuration: an 8-device virtual CPU mesh by default.

Tests exercise sharded code paths (shard_map / jit over a Mesh) on the
CPU backend so the suite runs anywhere.  Tests of code that only runs on
the card are marked ``gpu`` and take the ``gpu`` fixture, which skips
them elsewhere; on a machine with an NVIDIA GPU run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the config beats a platform some site customization may have set
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU (decided at run
    time, never at import, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
