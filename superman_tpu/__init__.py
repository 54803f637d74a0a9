"""superman_tpu — matrix permanent engine for NVIDIA GPUs, in JAX.

A ground-up JAX/XLA/Pallas re-design of the capability set of
kamerkaya/SUPerman (CUDA/C++): exact permanents via the Nijenhuis–Wilf
Gray-code Ryser formula, sparse SpaRyser/SkipPer variants, Monte-Carlo
estimators (Rasmussen, Sinkhorn-scaling-guided), matrix orderings,
exact-preserving compressions, Sinkhorn preconditioning, grid-graph
perfect-matching counting, CLI + Python/C APIs — executed on the GPU by
a Pallas (Triton) walk kernel sharded over a `jax.sharding.Mesh`, with a
native C++ OpenMP engine for the host CPU path.
"""

import jax as _jax

# float64 is load-bearing for exactness guarantees (host-side reductions,
# the f64 XLA walk, longdouble quad parity); all device arrays in this
# package carry explicit dtypes so enabling x64 does not change kernel types.
_jax.config.update("jax_enable_x64", True)

# persistent XLA compilation cache: the engine's kernel shapes repeat
# across runs, so a compile is paid once per checkout, not per process.
# JAX_COMPILATION_CACHE_DIR wins (JAX reads it itself); otherwise the
# cache lives in .jax_cache/ beside the package.  Opt out with
# SUPERMAN_NO_CC=1.
import os as _os


def _cache_dir() -> str:
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if not _os.environ.get("SUPERMAN_NO_CC"):
    try:
        _jax.config.update("jax_compilation_cache_dir", _cache_dir())
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except (OSError, AttributeError):
        pass

# float-anomaly tracing (the reference only has commented-out
# nvcc-fpchecker targets, revised_perman/Makefile:59-76): set
# SUPERMAN_DEBUG_NANS=1 to fail fast on NaN/Inf in any device computation.
if _os.environ.get("SUPERMAN_DEBUG_NANS"):
    _jax.config.update("jax_debug_nans", True)

from .core.flags import Flags
from .core.result import Result
from .core.matrix import DenseMatrix, SparseMatrix, matrix2compressed
from .io.triplet import read_triplet, write_triplet
from .io.matrixmarket import read_matrix_market, read_any
from .api import permanent, permanent_batch, grid_permanent

__version__ = "0.1.0"

__all__ = [
    "Flags", "Result", "DenseMatrix", "SparseMatrix", "matrix2compressed",
    "read_triplet", "write_triplet", "read_matrix_market", "read_any",
    "permanent", "permanent_batch", "grid_permanent",
]
