"""Test configuration.

Mirrors the reference's determinism fixture (``tests/conftest.py:9-23``):
float64 numerics and fixed seeds. Additionally forces JAX onto a virtual
8-device CPU platform so multi-chip sharding tests run anywhere.
"""

import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# An installed accelerator plugin (JAX's CUDA plugin) would otherwise be
# picked up; force the virtual-device CPU platform.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _seed_everything():
    random.seed(42)
    np.random.seed(42)
    yield
