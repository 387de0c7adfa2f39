"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices (the multi-device analog of a
fake backend: SURVEY.md §4) and float64 enabled — the reference solves to
KKT tolerance 1e-7 in Float64, which f32 cannot reach.

The platform is selected through jax.config *after* import (an environment
may pin JAX_PLATFORMS), and XLA_FLAGS is set before first backend use. Only
an explicit JAX_PLATFORMS=cuda keeps the GPU, for the `gpu`-marked tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  "cuda" if os.environ.get("JAX_PLATFORMS") == "cuda"
                  else "cpu")
jax.config.update("jax_enable_x64", True)



import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided when the test
    runs, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Run the backward-sweep kernel in the Pallas interpreter: the
    solver's dispatch then calls `backward_sweep_pallas` with
    `interpret=True`. Tests that use `backward_kernel="pallas"` off the GPU
    ask for it explicitly; the jit caches are dropped afterwards, so no
    other test reuses a program with the interpreter inside."""
    from functools import partial

    from ipddp2tpu.ops import backward_pallas

    monkeypatch.setattr(backward_pallas, "backward_sweep_pallas",
                        partial(backward_pallas.backward_sweep_pallas,
                                interpret=True))
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled XLA executables after each test module.

    A long-lived worker accumulates XLA:CPU JIT executable memory until a
    late large compile (8-device shard_map programs, solver while_loops)
    segfaults the process — the round-2/3 "worker crash" mode that xdist
    can only paper over by restarting the worker (the in-flight test still
    reports FAILED). Dropping the jit caches between modules bounds the
    accumulation; cross-module cache reuse is negligible."""
    yield
    jax.clear_caches()
