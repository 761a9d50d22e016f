"""Test configuration: run JAX on a simulated 8-device CPU mesh.

Tests run on the CPU; multi-device sharding is validated on virtual CPU
devices (SURVEY.md §4 item 5).  Tests marked `gpu` need the card and skip
here.  Must set flags before the first
jax import anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

import pytest

# make the in-repo package importable without installation (zero-egress env)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ASSETS = pathlib.Path(os.environ.get("VOX_ASSETS", "/root/reference/assets"))


@pytest.fixture(scope="session")
def assets_dir() -> pathlib.Path:
    if not ASSETS.is_dir():
        pytest.skip(f"asset dir {ASSETS} not available")
    return ASSETS
