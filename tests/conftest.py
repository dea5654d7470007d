"""Test configuration: run on CPU with 8 virtual devices and float64.

Multi-device sharding is exercised on a virtual CPU mesh (the analog of the
reference's oversubscribed local `mpiexec -np 12`, SURVEY section 4); the
GPU path is covered by `python chip_smoke.py` (and `--four-cards`) on the
card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

# an installed accelerator plugin may register itself regardless of the env
# var, so force the platform through the config too
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (minutes); excluded by default — enable with "
        "--runslow or RUN_SLOW=1",
    )


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full tier, ~15+ min)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW") == "1":
        return
    skip_slow = pytest.mark.skip(reason="slow tier: pass --runslow or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
