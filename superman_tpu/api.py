"""Top-level Python API.

``permanent(matrix_or_path, **flag_overrides)`` is the single entry point:
it mirrors the reference's L4 orchestration (RunAlgo + scaling/compression
drivers, revised_perman/main.cpp:98-1264) behind one call.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from .core.flags import Flags
from .core.result import Result
from .core.matrix import DenseMatrix


def _pad_rect(dm: DenseMatrix, flags: Flags) -> DenseMatrix:
    """Rectangular reduction (flags.rectangular): per_rect(A), the sum
    over injections of the smaller side into the larger, equals
    per([A; ones(n-m, n)]) / (n-m)!  exactly — every permutation of the
    padded square matrix is an injection of the m real rows times one of
    the (n-m)! arrangements of the dummy rows over the leftover columns,
    each contributing factor 1.  So EVERY engine (exact walks,
    estimators, gurvits) runs unchanged on the padded matrix; the
    driver divides the (n-m)! back out (log-space when it overflows).
    Inputs with more rows than columns are transposed first (the
    convention defines per_rect for m <= n).  The reference rejects
    non-square input outright (read_matrix.hpp:11-157) although its own
    corpus ships one (unknown_perman/ch5-5-b2.mtx, 600x200)."""
    a = np.asarray(dm.mat)
    m_, n_ = a.shape
    if m_ == n_:
        return dm
    if not flags.rectangular:
        raise ValueError(
            f"matrix is {m_}x{n_} (not square); pass rectangular=True "
            "for the injection-sum rectangular permanent")
    if m_ > n_:
        a = a.T
        m_, n_ = n_, m_
    pad = np.ones((n_ - m_, n_), dtype=a.dtype)
    flags._rect = (m_, n_)
    return DenseMatrix(np.vstack([a, pad]), dm.type)


def _unpad_rect_result(res: Result, flags: Flags) -> Result:
    """Divide the padding (n-m)! back out of a Result (value, meta
    log2_estimate, stderr), in log space so corpus-scale magnitudes
    survive."""
    import math
    m_, n_ = flags._rect
    k = n_ - m_
    fact_l2 = math.lgamma(k + 1) / math.log(2.0)
    with np.errstate(over="ignore", invalid="ignore"):
        if np.isfinite(res.permanent) and res.permanent != 0.0:
            if k <= 170:      # (n-m)! fits f64: one exact-ish division
                res.permanent = res.permanent / float(math.factorial(k))
            else:
                sgn = math.copysign(1.0, res.permanent)
                res.permanent = sgn * float(
                    np.exp2(np.log2(abs(res.permanent)) - fact_l2)) + 0.0
        elif np.isinf(res.permanent) and "log2_estimate" in res.meta:
            l2 = float(res.meta["log2_estimate"]) - fact_l2
            sgn = float(res.meta.get("sign", 1.0))
            res.permanent = sgn * float(np.exp2(min(l2, 1100))) + 0.0
        if res.meta.get("log2_estimate") is not None:
            res.meta["log2_estimate"] = \
                float(res.meta["log2_estimate"]) - fact_l2
        if res.meta.get("stderr"):
            se = float(res.meta["stderr"])
            if np.isfinite(se) and se > 0:
                res.meta["stderr"] = (
                    se / float(math.factorial(k)) if k <= 170 else
                    float(np.exp2(np.log2(se) - fact_l2)) + 0.0)
    res.meta["rect_shape"] = [m_, n_]
    res.meta["pad_rows"] = k
    return res


def _as_dense(m, flags: Flags) -> DenseMatrix:
    if m is None:
        if not flags.grid_graph:
            raise ValueError("matrix is required unless grid_graph=True")
        from .prep.gridgraph import grid_graph_matrix
        dm = grid_graph_matrix(flags.gridm, flags.gridn)
        flags.type = dm.type
        return dm
    from .core.matrix import SparseMatrix
    if isinstance(m, SparseMatrix):
        # keep the storage class (same dtype rules as the ndarray path
        # below): densifying as "double" would silently disable the
        # exact-f32/tf96 tiers for integer-valued sparse inputs
        vals = np.asarray(m.cvals)
        if np.issubdtype(vals.dtype, np.integer):
            tname = "int"
        elif vals.dtype == np.float32:
            tname = "float"
        else:
            tname = "double"
        m = m.to_dense(tname)
    if isinstance(m, DenseMatrix):
        dm = m
    elif isinstance(m, str):
        from .io.matrixmarket import read_any
        dm = read_any(m, flags.binary_graph, flags.storage_half_precision,
                      flags.storage_quad_precision,
                      allow_rect=flags.rectangular)
        flags.filename = m
    else:
        a = np.asarray(m)
        if a.ndim != 2 or (a.shape[0] != a.shape[1]
                           and not flags.rectangular):
            raise ValueError("matrix must be square")
        if np.issubdtype(a.dtype, np.integer):
            tname = "int"
        elif a.dtype == np.float32:
            tname = "float"
        else:
            tname = "double"
        dm = DenseMatrix(a, tname)
    if flags.binary_graph:
        dm = dm.binarized()
    dm = _pad_rect(dm, flags)
    flags.type = dm.type
    return dm


def permanent(matrix: Union[np.ndarray, DenseMatrix, str, None] = None,
              **overrides) -> Result:
    """Compute the permanent of a square matrix.

    matrix: array-like, DenseMatrix, a path (triplet / MatrixMarket), or
    None with grid_graph=True (count perfect matchings of a
    gridm x gridn grid, reference RunPermanForGridGraphs).
    overrides: any `Flags` field, e.g. sparse=True, approximation=True,
    calc="f32", preprocessing=2, compression=True, scaling_threshold=1.0.
    """
    flag_fields = {f.name for f in dataclasses.fields(Flags)}
    unknown = set(overrides) - flag_fields
    if unknown:
        raise TypeError(f"unknown flags: {sorted(unknown)}")
    from .backend import backend
    flags = Flags(**overrides)
    dm = _as_dense(matrix, flags)
    from .drivers.runner import run
    from .utils import trace
    where = backend()
    with trace.profile("superman_tpu.permanent"):
        with trace.timer(f"permanent[{flags.algo_name or flags.perman_algo}]",
                         level=2):
            res = run(dm, flags)
    spans = trace.drain_spans()
    if spans:
        res.meta.setdefault("spans", spans)
    res.meta["backend"] = where
    if getattr(flags, "_rect", None):
        res = _unpad_rect_result(res, flags)
    return res


def permanent_batch(mats, **overrides):
    """Exact permanents of many matrices; same-order matrices share one
    device program (see ops/batch.py)."""
    from .backend import backend
    from .ops.batch import permanent_batch as _pb
    where = backend()
    results = _pb(mats, **overrides)
    for res in results:
        res.meta["backend"] = where
    return results


def grid_permanent(m: int, n: int, **overrides) -> Result:
    """Number of perfect matchings of an m x n grid graph (reference -i)."""
    overrides.setdefault("grid_graph", True)
    overrides.setdefault("gridm", m)
    overrides.setdefault("gridn", n)
    return permanent(None, **overrides)
