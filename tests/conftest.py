"""Test configuration: force an 8-device virtual CPU platform so multi-device
sharding paths are exercised without accelerator hardware.

Mirrors the reference's test strategy of checking the device path against a
host path (SURVEY.md section 4): here, the same jitted code runs on the CPU
backend and is compared against numpy oracles; the GPU runs the identical
program (chip_smoke.py compares the two on the card).

NOTE: a pytest plugin in this environment imports jax before conftest runs,
so env vars (JAX_PLATFORMS / XLA_FLAGS) are too late - use jax.config, which
takes effect as long as the backend has not been initialized yet.

Tests that need the card carry the ``chip`` marker and the ``gpu`` fixture;
they skip on the CPU. Run them on the card with
``PRT_CHIP_TESTS=1 python -m pytest tests/test_rasterize.py -m chip -p no:xdist``,
which keeps JAX's default (GPU) platform.
"""

import os

import jax

CHIP_RUN = os.environ.get("PRT_CHIP_TESTS") == "1"
if not CHIP_RUN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# after the platform config: importing the package creates device constants
from pose_refine import platform  # noqa: E402
# Persistent compile cache for the test platform, in the checkout: tests
# are seeded deterministically, so the traced programs repeat run-to-run.
# A separate directory from the device cache (CPU executables are
# host-feature-specific).
platform.enable_compile_cache(".jax_cache" if CHIP_RUN else ".jax_cache_cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

import zlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    # Function-scoped and seeded from the test name: every test draws a
    # deterministic stream INDEPENDENT of which other tests ran before it
    # (a shared session rng made assertions depend on suite order).
    seed = zlib.crc32(request.node.name.encode())
    return np.random.default_rng(seed)


@pytest.fixture()
def gpu():
    """The GPU device for ``chip``-marked tests; skips (decided at run time,
    never at import) where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {dev.platform}); "
                    "run with PRT_CHIP_TESTS=1 on the card")
    return dev
