"""The one place that decides how the accelerator code runs.

Every exact walk (the Gray-walk kernel in ops/ryser_pallas.py, its
callers in ops/ryser.py, ops/glynn.py, ops/batch.py and the hybrid
scheduler) asks this module instead of reading the JAX platform itself:

* ``"gpu"`` — an NVIDIA GPU is JAX's default backend: the kernel is
  compiled for the card through Pallas' Triton route;
* ``"cpu"`` — the platform was set to CPU explicitly (``JAX_PLATFORMS=cpu``
  or ``jax.config.update("jax_platforms", "cpu")``, as the test suite
  does): the same kernel body runs in the Pallas interpreter.

Any other platform raises: the engine has no code path for it, and a
silent fall-back to the interpreter would hide a 1000x slowdown.
"""

from __future__ import annotations

import os

import jax

GPU = "gpu"
CPU = "cpu"


def _cpu_requested() -> bool:
    plats = (jax.config.jax_platforms
             or os.environ.get("JAX_PLATFORMS", "") or "")
    return plats.split(",")[0].strip().lower() == "cpu"


def backend() -> str:
    """``"gpu"`` or ``"cpu"`` (see the module docstring)."""
    plat = jax.default_backend()
    if plat in ("gpu", "cuda"):
        return GPU
    if plat == "cpu" and _cpu_requested():
        return CPU
    if plat == "cpu":
        raise RuntimeError(
            "no GPU found and the CPU platform was not requested: set "
            "JAX_PLATFORMS=cpu to run the walks in the Pallas interpreter")
    raise RuntimeError(f"unsupported JAX platform {plat!r}: the walks run "
                       f"on an NVIDIA GPU, or interpreted on the CPU")


def interpret() -> bool:
    """True when Pallas kernels must run in interpret mode."""
    return backend() == CPU
