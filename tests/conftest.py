"""Test configuration: a CPU JAX backend with 8 virtual devices, so sharding
tests exercise real multi-device meshes everywhere.

Tests marked `gpu` need the card; the `gpu_device` fixture skips them where
JAX finds none. The card is looked for inside the fixture, never while
tests are collected, so every xdist worker collects the same tests.
JAX_PLATFORMS is forced to "cpu" unless it is already set, so on a machine
with the card they run with:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist

(chip_smoke.py runs them too, in its own process.)
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from optixpathtracer_tpu.runtime import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: the suite is compile-dominated (tiny shapes,
# big programs - sharded grad steps take minutes to build on CPU); caching
# makes re-runs fast.
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU visible to JAX")
    return gpus[0]
