"""Test configuration.

The suite runs on the host CPU with 8 virtual devices, so multi-device
sharding tests run anywhere (SURVEY.md §4 strategy — the same collective
program on an emulated mesh).  The GPU tier (tests/test_gpu_e2e.py,
marker ``gpu``) runs on the card and is selected with ``-m gpu``:

    python -m pytest tests/test_gpu_e2e.py -m gpu -n 0

Only then is the platform left to JAX; whether a card is present is
decided inside that tier's fixtures.
"""

import os

import numpy as np
import pytest


def _gpu_tier(config) -> bool:
    expr = config.getoption("markexpr", default="") or ""
    return "gpu" in expr and "not gpu" not in expr


def pytest_configure(config):
    if not _gpu_tier(config):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import hetpu  # noqa: F401  (places the persistent compile cache)
    # the suite's wall-clock is dominated by XLA compiles (every (op,
    # level, shape) is a distinct executable): cache all of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


# Smoke tier: every test in these modules is fast — pure-kernel math at
# tiny N, no deep-chain keygen.  `pytest -m smoke` finishes in ~1 min;
# the remaining modules are the `full` tier.
_SMOKE_MODULES = {
    "test_modular", "test_rns", "test_ntt", "test_dsl", "test_twofloat",
    "test_aux", "test_backend",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        marked = set(item.keywords)
        if "smoke" not in marked and "full" not in marked:
            if mod in _SMOKE_MODULES:
                item.add_marker(pytest.mark.smoke)
            else:
                item.add_marker(pytest.mark.full)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
