"""ctypes bindings to the native CPU engine.

Parity: the libConnect.so surface (reference interface_connector.c:61-231 +
superPython.py): `read_calculate_return`, `matlab_calculate_return_int`,
`matlab_calculate_return_double`, `connect` — plus direct entry points for
each engine (dense/sparse/skipper exact, Rasmussen, scaling estimator).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..core.matrix import DenseMatrix
from ..core.result import Result

_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..native.build import build
        lib = ctypes.CDLL(build())
        D = ctypes.c_double
        I = ctypes.c_int
        LL = ctypes.c_longlong
        U = ctypes.c_ulonglong
        dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.sup_perman_dense.restype = D
        lib.sup_perman_dense.argtypes = [dp, I, I, I]
        lib.sup_perman_sparse.restype = D
        lib.sup_perman_sparse.argtypes = [dp, I, I, I]
        lib.sup_perman_skipper.restype = D
        lib.sup_perman_skipper.argtypes = [dp, I, I, I]
        ip64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.sup_perman_dense_chunks.restype = D
        lib.sup_perman_dense_chunks.argtypes = [dp, I, ip64, LL, I, I]
        lib.sup_rasmussen.restype = D
        lib.sup_rasmussen.argtypes = [dp, I, LL, I, U,
                                      ctypes.POINTER(D)]
        lib.sup_approx_scaling.restype = D
        lib.sup_approx_scaling.argtypes = [dp, I, LL, I, I, I, U,
                                           ctypes.POINTER(D)]
        up64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.sup_perman_mod.restype = U
        lib.sup_perman_mod.argtypes = [up64, I, U]
        lib.sup_perman_mod_batch.restype = None
        lib.sup_perman_mod_batch.argtypes = [up64, I, up64, I, I, up64]
        lib.sup_perman_mod_pruned.restype = U
        lib.sup_perman_mod_pruned.argtypes = [up64, I, U, ip64, LL, I, I]
        lib.sup_perman_glynn_mod_chunked.restype = U
        lib.sup_perman_glynn_mod_chunked.argtypes = [up64, I, U, I, I]
        lib.sup_cpu_ifma.restype = I
        lib.sup_cpu_ifma.argtypes = []
        lib.read_calculate_return.restype = D
        lib.read_calculate_return.argtypes = [ctypes.c_char_p, I, I, I, I, I]
        lib.connect.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def perman_dense_chunks(a_scaled: np.ndarray, chunk_ids: np.ndarray,
                        r: int, threads: int) -> float:
    """Raw partial sum over aligned Gray chunks (hybrid-scheduler CPU side).

    a_scaled must be the SAME row-scaled matrix the device kernel runs on; the
    returned value carries no final sign factor (see perman_cpu.cpp).
    """
    lib = load()
    a = np.ascontiguousarray(a_scaled, dtype=np.float64)
    ids = np.ascontiguousarray(chunk_ids, dtype=np.int64)
    return float(lib.sup_perman_dense_chunks(
        a, a.shape[0], ids, len(ids), int(r), int(threads)))


def perman_mod_batch(mats: np.ndarray, primes: np.ndarray,
                     threads: int = 0) -> np.ndarray:
    """per(mats[i]) mod primes[i] for pre-reduced uint64 matrices.

    Backs ops/exact.py's CRT reconstruction; mats has shape (np, n, n)
    with mats[i] already reduced into [0, primes[i]).
    """
    lib = load()
    mats = np.ascontiguousarray(mats, dtype=np.uint64)
    ps = np.ascontiguousarray(primes, dtype=np.uint64)
    out = np.empty(len(ps), dtype=np.uint64)
    lib.sup_perman_mod_batch(mats, mats.shape[-1], ps, len(ps),
                             int(threads), out)
    return out


def cpu_ifma() -> bool:
    """True when the host runs the AVX-512 IFMA 8-lane Z_p walk (52-bit
    Montgomery lanes); the CRT backend then picks <2^52 primes so the
    pruned walk dispatches onto it (measured ~6.6x the scalar 61-bit
    walk on the chesapeake core plan)."""
    try:
        return bool(load().sup_cpu_ifma())
    except Exception:
        return False


def perman_mod_pruned(am: np.ndarray, p: int, ids: np.ndarray, r: int,
                      threads: int = 0) -> int:
    """per(am) mod p over the live chunks `ids` at chunk length 2^r.

    The native twin of ops/modp.perman_core_mod's pruned walk (same
    ids/r contract, ops/modp._live_exact); am pre-reduced into [0, p).
    """
    lib = load()
    am = np.ascontiguousarray(am, dtype=np.uint64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    assert 1 <= int(r) <= 62
    return int(lib.sup_perman_mod_pruned(am, am.shape[0], p, ids,
                                         len(ids), int(r), int(threads)))


def perman_glynn_mod(am: np.ndarray, p: int, r: int = None,
                     threads: int = 0) -> int:
    """per(am) mod p via the GLYNN polarization walk — the second,
    algorithmically independent exact engine (native
    sup_perman_glynn_mod_chunked).  Used to cross-certify EXACT_KNOWN
    rows at a fresh prime: a systematic NW-walk/plan bug corrupts every
    CRT residue identically (invisible to the held-out verifier), but
    cannot also reproduce under Glynn's different identity.  am
    pre-reduced into [0, p); r is the chunk log-length (default splits
    into ~8k chunks so the IFMA lanes and OMP threads fill).
    """
    lib = load()
    am = np.ascontiguousarray(am, dtype=np.uint64)
    n = am.shape[0]
    if r is None:
        r = max(1, n - 1 - 13)
    return int(lib.sup_perman_glynn_mod_chunked(am, n, p, int(r),
                                                int(threads)))


def read_calculate_return(filename: str, algorithm: int, nt: int = 16,
                          x: int = 100000, y: int = 4, z: int = 5) -> float:
    """Reference superPython entry point (superPython.py:21-29)."""
    return float(load().read_calculate_return(
        filename.encode(), algorithm, nt, x, y, z))


def perman_native(dense: DenseMatrix, flags) -> Result:
    """Route a flags-configured run to the native CPU engine."""
    lib = load()
    a = np.ascontiguousarray(dense.mat, dtype=np.float64)
    n = dense.nov
    nt = int(flags.threads)
    t0 = time.perf_counter()
    zeros = ctypes.c_double(0.0)
    if flags.approximation:
        algo = str(flags.perman_algo)
        if algo in ("rasmussen", "1", "3"):
            p = lib.sup_rasmussen(a, n, int(flags.number_of_times), nt,
                                  int(flags.seed) + 12345,
                                  ctypes.byref(zeros))
            name = "cpu_rasmussen"
        else:
            p = lib.sup_approx_scaling(a, n, int(flags.number_of_times),
                                       int(flags.scale_intervals),
                                       int(flags.scale_times), nt,
                                       int(flags.seed) + 12345,
                                       ctypes.byref(zeros))
            name = "cpu_approx_scaling"
        iters = int(flags.number_of_times)
    elif flags.sparse:
        cq = 1 if flags.resolved_calc() == "quad" else 0
        if flags.preprocessing == 2 or str(flags.perman_algo) in (
                "2", "3", "skipper"):
            p = lib.sup_perman_skipper(a, n, nt, cq)
            name = "cpu_skipper"
        else:
            p = lib.sup_perman_sparse(a, n, nt, cq)
            name = "cpu_sparyser"
        if cq:
            name += "_quad"
        iters = 1 << (n - 1)
    else:
        cq = 1 if flags.resolved_calc() == "quad" else 0
        p = lib.sup_perman_dense(a, n, nt, cq)
        name = "cpu_ryser_quad" if cq else "cpu_ryser"
        iters = 1 << (n - 1)
    dt = time.perf_counter() - t0
    return Result(float(p), dt, algo_name=name, zeros=int(zeros.value),
                  iterations=iters,
                  meta={"threads": nt, "iters_per_sec": iters / max(dt, 1e-9)})
