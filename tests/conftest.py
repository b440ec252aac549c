"""Test environment.

By default the tests run on the CPU backend with 8 virtual devices and x64
enabled, whatever accelerator the machine has. `MSM_TEST_GPU=1` keeps the
GPU as JAX's default backend instead — the card run of the `gpu`-marked
tests (`MSM_TEST_GPU=1 python -m pytest -m gpu tests/`, or phase (e) of
chip_smoke.py). The CPU stays reachable there as `jax.devices("cpu")`.

Must configure the environment before jax initializes a backend.
"""

import os

if os.environ.get("MSM_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("MSM_TEST_GPU") != "1":
    # the env var alone is too late if jax was imported (and configured)
    # before this conftest ran
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every test worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with MSM_TEST_GPU=1 on a card)")
    return gpus[0]
