"""Test configuration.

By default the suite runs on a virtual 8-device CPU mesh, so sharding and
collective paths are exercised without hardware.  JAX initializes its
backends lazily, so `jax.config.update` here still applies even when
something imported jax earlier.  The persistent compilation cache is not
enabled in this mode: XLA:CPU's cached executables carry host machine
features and have been seen to mismatch the host on load.

`DDO_TEST_DEVICE=1` runs the suite on the default accelerator instead,
with the persistent compile cache on.  It needs one pytest process per
card — every JAX process reserves most of the card's memory at start —
so it refuses pytest-xdist workers.
"""
import os

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

DEVICE_MODE = os.environ.get("DDO_TEST_DEVICE") == "1"

if DEVICE_MODE:
    from ddo_tpu.utils.jax_setup import enable_compile_cache

    enable_compile_cache()
else:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    jax.config.update("jax_platforms", "cpu")

import gc

import pytest


def pytest_configure(config):
    if DEVICE_MODE and (
        os.environ.get("PYTEST_XDIST_WORKER")
        or getattr(config.option, "numprocesses", None)
    ):
        raise pytest.UsageError(
            "DDO_TEST_DEVICE=1 runs one pytest process per card: drop -n "
            "(each JAX process reserves most of the card's memory)"
        )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The suite jit-compiles hundreds of distinct programs; keeping them all
    loaded eventually crashes XLA:CPU's JIT inside backend_compile (observed
    as a segfault after ~90 compilations regardless of which test runs
    then).  Each module's models share compilations, so per-module clearing
    keeps the speed benefit without accumulating executables."""
    yield
    jax.clear_caches()
    gc.collect()
