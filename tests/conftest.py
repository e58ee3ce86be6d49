import os

# Force a virtual 8-device CPU mesh for all tests: deterministic, no GPU
# needed, and exercises the same sharding code paths as a multi-GPU host.
# Backend selection happens lazily, so overriding the env here (before any
# backend is initialized) routes tests to the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may have been imported (and JAX_PLATFORMS read) before this
# conftest ran; update the live config too.
jax.config.update("jax_platforms", "cpu")

assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh; backend was initialized too "
    f"early: {jax.devices()}"
)


# The full suite accumulates dozens of large compiled CPU executables and
# compiler state across modules; past ~50% that state has segfaulted
# XLA:CPU *during a later compile* (reproducibly in test_sharded, which
# compiles the largest sharded program — while the same file alone, or
# with just the pallas modules, is green).  Dropping caches between
# modules keeps the compiler's working set bounded; the cost is a few
# recompiles of shared helpers.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    import gc

    jax.clear_caches()
    gc.collect()
