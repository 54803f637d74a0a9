"""Tracing / profiling / progress observability.

Parity: the reference's observability surface (SURVEY.md §5) — wall-clock
timing around every engine (omp_get_wtime, main.cu:35-37), per-chunk
progress lines ("ChunkID k is DONE by kernel i in t",
gpu_exact_dense.cu:876), and the `make profile` Nsight hook
(revised_perman/Makefile:28-40) — rebuilt for JAX:

* `log(...)`        — leveled stderr logging, enabled with
                      SUPERMAN_VERBOSE=1 (or 2 for per-chunk noise).
* `timer(name)`     — context manager recording wall-clock spans; spans are
                      retrievable via `drain_spans()` for Result.meta.
* `profile(name)`   — context manager that wraps the block in a
                      `jax.profiler.trace` when SUPERMAN_PROFILE_DIR is set
                      (TensorBoard-compatible XPlane dump; the JAX
                      equivalent of compiling with -lineinfo for Nsight).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import List, Tuple

_lock = threading.Lock()
_spans: List[Tuple[str, float]] = []


def verbosity() -> int:
    try:
        return int(os.environ.get("SUPERMAN_VERBOSE", "0"))
    except ValueError:
        return 0       # malformed value -> the documented default (quiet)


def log(msg: str, level: int = 1) -> None:
    if verbosity() >= level:
        with _lock:
            print(f"[superman_tpu +{time.monotonic():.3f}] {msg}",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def timer(name: str, level: int = 2):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _spans.append((name, dt))
        log(f"{name}: {dt:.4f}s", level=level)


def drain_spans() -> List[Tuple[str, float]]:
    """Return and clear the recorded (name, seconds) spans."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


@contextlib.contextmanager
def profile(name: str):
    """jax.profiler trace around the block when SUPERMAN_PROFILE_DIR is
    set; otherwise a no-op.  View with TensorBoard's profile plugin."""
    outdir = os.environ.get("SUPERMAN_PROFILE_DIR")
    if not outdir:
        yield
        return
    import jax
    with jax.profiler.trace(outdir):
        with jax.profiler.TraceAnnotation(name):
            yield
    log(f"profile '{name}' written to {outdir}", level=1)
