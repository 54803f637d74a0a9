"""Test config: force an 8-device virtual CPU mesh BEFORE jax initializes.

Mirrors the reference's only viable no-hardware strategy (SURVEY.md §4):
exactness makes every sharded run a bit-comparison against the
single-device result.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# an already-initialised config (a plugin's site hook, a parent process)
# may have picked another platform: pin CPU through the config API too
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    """Per-test deterministic generator, seeded from the test's own id.

    The old session-scoped stream made every test's matrices depend on
    how many draws ran BEFORE it — adding one test anywhere reshuffled
    every later test's inputs, and matrix-conditional assertions
    (hybrid-path meta, tolerance checks) flaked a test file away from
    the edit (round-4: test_hybrid_mesh_checkpoint_combo KeyError from a
    new test in test_exact.py).  Seeding by test id makes each test's
    inputs a pure function of itself."""
    import zlib
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def random_int_matrix(rng, n, density, vmax=4):
    a = (rng.random((n, n)) < density).astype(np.int64)
    return a * rng.integers(1, vmax + 1, (n, n))


def random_float_matrix(rng, n, density):
    a = (rng.random((n, n)) < density).astype(np.float64)
    return a * rng.random((n, n)) * 5.0
