"""Test harness config: force an 8-device virtual CPU mesh (SURVEY.md §4.5)
so sharding/collective tests run without accelerator hardware.  Kernel
tests run the Pallas kernel in interpret mode; the compiled kernel is
checked on the GPU by ``chip_smoke.py``."""
import os

# Hard-set (not setdefault): the tests run on the CPU even on a machine
# with a GPU; jax.config.update below forces it for the already-imported
# case too.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(19)  # the reference's seed (Program.fs:14)
