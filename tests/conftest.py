"""Test configuration: force CPU with 8 virtual devices (the standard JAX trick for
testing multi-chip sharding without hardware) and enable float64 for parity checks
against scipy reference solves."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# pin the CPU even where a GPU plug-in is installed: the tests run on the
# virtual 8-device CPU mesh; the GPU path is proven by chip_smoke.py
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent compile cache: the suite re-jits the same fixed-shape kernels every
# run; caching cuts repeat wall time by minutes
from hsolve.utils.runtime import configure_compile_cache  # noqa: E402

configure_compile_cache()
