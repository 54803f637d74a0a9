"""Glynn-formula exact permanent — an independent second exact engine.

per(A) = 2^(1-n) * sum over delta in {+-1}^n with delta_n = +1 of
         (prod_i delta_i) * prod_j (sum_i delta_i * a_ij).

The reference has no Glynn implementation; it is added here because
cross-ALGORITHM agreement is the primary correctness oracle (SURVEY.md
§4.1) and Ryser/Nijenhuis-Wilf otherwise provides every device result.

The Gray walk over delta maps EXACTLY onto the Ryser walk kernel
(ops/ryser_pallas.py) with different packing:

* state x_j = sum_i delta_i a_ij; initially (all delta = +1) the column
  sums of A;
* flipping delta_k toggles -2*a[k, :] in and out of x — so the kernel's
  column table holds  G[k, :] = -2 * (row k of A)  for k < n-1;
* the term sign (prod delta) = (-1)^popcount(gray(m)) = (-1)^m — the
  parity the kernel already applies (XOR of Gray bits telescopes to m&1);
* final factor 2^(1-n) replaces Ryser's (4*(n&1)-2).

Column scaling by powers of two is exact and keeps every |x_j| ~ 1, as in
the Ryser path.

Scope (deliberate): Glynn is the ORACLE engine — single-path, no
host-slicing, no hybrid scheduler, no chunk pruning.  Under
multi-process every host redoes the full walk (correct, wasteful);
production workloads route through the Ryser engine, and Glynn's value
is exactly that it shares none of its distribution machinery.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import backend
from ..core.matrix import DenseMatrix
from ..core.result import Result
from . import gray
from .df64 import split_f64


def _col_scales(a: np.ndarray) -> np.ndarray:
    """Integer exponents s_j bounding |x_j| <= ~1 along the whole walk:
    |x_j| <= sum_i |a_ij| always."""
    ab = np.abs(np.asarray(a, dtype=np.float64))
    xmax = ab.sum(axis=0)
    with np.errstate(divide="ignore"):
        s = np.ceil(np.log2(np.maximum(xmax, 1e-300)))
    return np.clip(s, -980, 980).astype(np.int64)


def _pack_glynn(a_s: np.ndarray, n_pad: int):
    """x0 = column sums; walk table G[:, k] = -2 * row k (k < n-1)."""
    n = a_s.shape[0]
    x0 = np.ones(n_pad, dtype=np.float64)
    x0[:n] = a_s.sum(axis=0)
    g = np.zeros((n - 1, n_pad), dtype=np.float64)
    g[:, :n] = -2.0 * a_s[: n - 1, :]
    x0_pair = np.stack(split_f64(x0))
    cols_pair = np.stack(split_f64(g))
    return x0_pair, cols_pair


def glynn_exact(dense: DenseMatrix, flags, mesh=None) -> Result:
    a = np.asarray(dense.mat)
    n = a.shape[0]
    calc = flags.resolved_calc()
    t0 = time.perf_counter()
    if n <= 2 or calc in ("quad", "f64") or n < 19:
        from .oracle import perman_glynn
        # quad (and small-n tf96) keep long-double precision on the host
        # walk — same contract as ryser_exact's host rung (ryser.py)
        dt = (np.longdouble if calc in ("quad", "tf96") else np.float64)
        p = perman_glynn(a, dtype=dt)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name="glynn_host", iterations=1 << max(n - 1, 0))

    # trivial zero: an empty row/column zeroes every Glynn term AND the
    # scale-retry heuristic would rerun 3 full walks on pure zeros
    # (same early-out as ryser_exact)
    if (np.count_nonzero(a, axis=1) == 0).any() or \
       (np.count_nonzero(a, axis=0) == 0).any():
        return Result(0.0, time.perf_counter() - t0,
                      algo_name=f"glynn_pallas_{calc}", iterations=0,
                      meta={"reason": "empty row/col"})

    df = calc == "df64"
    kahan = calc == "f32k"
    tf = calc == "tf96"
    # Glynn's x_j = sum_i delta_i a_ij * 2^-s_j: all terms in x_j share
    # the column scale, so the walk is exact in f32 iff the column
    # abs-sums fit in 24-bit mantissas (mirror of ryser._exact_storage's
    # row test)
    # value-based like ryser._exact_storage (round 5): integer-VALUED
    # float64 matrices (pattern .mtx files) get the exact walk too
    a64 = a.astype(np.float64)
    exact_storage = bool(
        (dense.type == "int" or np.all(a64 == np.round(a64)))
        and np.max(np.abs(a64).sum(axis=0), initial=0.0) < 2 ** 22)
    if tf and not exact_storage:
        import warnings
        warnings.warn("tf96 requires exact-f32 storage; falling back to "
                      "df64")
        tf, df, calc = False, True, "df64"
    from ..parallel.sharding import pad_ids, compute_partials
    num_shards = (int(np.prod(mesh.devices.shape))
                  if mesh is not None else 1)
    plan = gray.make_plan(n, flags.lanes, flags.chunk_log2,
                          num_shards=num_shards)
    ids_blocks = pad_ids(
        np.arange(plan.num_chunks, dtype=np.int32), plan.lanes, num_shards)
    interpret = backend.interpret()

    scales = _col_scales(a)
    best = None
    shifted = 0
    shift_cap = max(1, 100 // n)
    for attempt in range(3):
        a_s = np.ldexp(a.astype(np.float64), -scales[None, :])
        x0_pair, cols_pair = _pack_glynn(a_s, plan.n_pad)
        partials = compute_partials(
            ids_blocks, x0_pair, cols_pair, plan,
            df=df, exact_storage=exact_storage, mesh=mesh, kahan=kahan,
            tf=tf, interpret=interpret)
        total = (partials.sum(dtype=np.longdouble) if tf
                 else float(partials.sum(dtype=np.float64)))
        # bounded cumulative shifts + finite fallback (see ops/ryser.py)
        if not np.isfinite(total):
            break
        best = (total, int(scales.sum()))
        if total != 0.0 and abs(total) > 2.0 ** -40:
            break
        room = shift_cap - shifted
        if room <= 0:
            break
        bump = 120 if total == 0.0 else int(-np.log2(abs(total)) // n + 1)
        per_row = max(1, min(bump, room))
        scales = scales - per_row
        shifted += per_row
    total, E = best if best is not None else (total, int(scales.sum()))
    with np.errstate(over="ignore"):
        acc = np.longdouble(total) if tf else np.float64(total)
        p = float(np.ldexp(acc, E + 1 - n)) + 0.0
    dt = time.perf_counter() - t0
    iters = plan.num_chunks << plan.r
    return Result(p, dt, algo_name=f"glynn_pallas_{calc}",
                  iterations=iters,
                  meta={"calc": calc, "scale_log2": E,
                        "iters_per_sec": iters / dt})

