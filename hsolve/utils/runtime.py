"""Process set-up shared by the entry points (``bench.py``, ``chip_smoke.py``,
``scripts/`` and the tests): where JAX keeps its persistent compile cache, the GPU
requirement of a measurement run, and the card's name and power limit."""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Place JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
    set here.  Otherwise the cache lives at the fixed ``.jax_cache/`` in the
    repository root (listed in ``.gitignore``), so every process of a run - and
    every run from the same checkout - finds what the others compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR


def require_gpu():
    """Return ``jax.devices()`` if JAX's default backend is a GPU, else raise.

    A measurement run never falls back to the CPU: its numbers would be read as
    the card's."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform} "
            f"({devs[0].device_kind}); this run measures the GPU and does not "
            "fall back to the CPU")
    return devs


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, one line
    per card: a card set below its maximum power runs slower under load, so every
    number taken on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60)
    return out.stdout.strip()
