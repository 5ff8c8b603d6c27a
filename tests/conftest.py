"""Test harness: force an 8-device virtual CPU mesh.

The substitute for a fake distributed backend (SURVEY.md §4): XLA's
``--xla_force_host_platform_device_count`` fakes 8 CPU devices so the
shard_map/psum data-parallel path is exercised without hardware.  The
platform is forced via jax.config before any jax computation runs, so the
suite stays on the CPU even where an accelerator plugin is installed.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# Persistent XLA compilation cache: the suite is compile-bound on CPU (tiny
# shapes, many distinct jit traces), and cache keys are HLO hashes, so reuse
# is exact.  setdefault so CI can point it elsewhere or disable it with
# JAX_COMPILATION_CACHE_DIR="".
_cache_dir = os.path.join(os.path.dirname(__file__), ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache_dir)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

# FBSDEJ_DEVICE_TESTS=1 keeps the real accelerator visible — ONLY for the
# single-device slow convergence gates (tests/test_convergence_slow.py,
# minutes on the accelerator vs tens of minutes on CPU).  Run that mode
# WITHOUT xdist: each worker process would reserve most of the card's
# memory.  The multi-device SPMD tests need the virtual 8-CPU mesh and are
# skipped in that mode.
if os.environ.get("FBSDEJ_DEVICE_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Auto-mark the fast tier: anything not slow/device/full is ``quick``.

    ``pytest -m quick`` is the fast CI tier (the opt-in-instrument equality
    tests — adjoint, hoist_gamma, fuse_heads — doubled the default suite's
    wall-clock; they carry ``full`` and run via the default addopts or
    ``-m full``).  The gate
    smoke tier (``gates``) likewise runs in the default tier only: it
    trains all 15 hardware-gate configs end-to-end (~10 CPU-min)."""
    for item in items:
        if not any(item.get_closest_marker(m)
                   for m in ("slow", "device", "full", "gates")):
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(42)
