"""Z_p modular Ryser walk on the device — exact permanents by CRT.

The exact CRT engine (ops/exact.py) runs the Nijenhuis–Wilf walk in Z_p
on the host CPU (native Montgomery kernel).  This module runs the SAME
Z_p walk on the default JAX device as a plain lane-vectorised `lax`
loop (``crt_perman_core(..., backend="device")``), reusing the engine's
planning stack (aligned gray chunks `ops/gray.py`, pruned live-chunk
plans `ops/pruning.py`):

* primes p <= 2039 with a LAZY residue representation in [0, 2p): all
  values and their pairwise products stay integers < 4p^2 < 2^24, every
  one EXACTLY representable in f32 — the walk is ordinary f32
  arithmetic with a floor-multiply Barrett-style reduction whose
  reciprocal is rounded DOWN (invp' = (1 - 2^-22)/p in f32, provably
  < 1/p), so q = floor(v * invp') never overestimates and
  r = v - q*p lands in [0, 2p) with NO conditional correction at all.
  Every product formed is an exact integer, so fused multiply-adds
  cannot change a result.
* x updates, the product tree and the accumulator all reduce each step;
  a lane's partial sum stays lazy in [0, 2p) and the lane total is an
  exact integer sum, reduced mod p once on the host.

The cost selector in ops/exact.py does not pick this engine: the native
CRT walk covers every core, and no device rate for this walk has been
measured.  It is reachable by name and pinned against the host twins.
"""

from __future__ import annotations

import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import gray

_I32 = jnp.int32

#: largest usable prime: lazy residues live in [0, 2p), so (2p)^2 must
#: stay an exact f32 integer (< 2^24) -> p < 2^11
PRIME_CEIL = 2039


def _invp_down(p) -> np.float32:
    """f32 reciprocal provably BELOW 1/p: q = floor(v * invp_down) then
    never overestimates floor(v/p), so v - q*p >= 0 without correction
    and < 2p because the relative shortfall (~2^-21) times the largest
    v/p (= 4p < 2^13) stays far under 1."""
    return np.float32((1.0 - 2.0 ** -22) * np.float32(1.0 / np.float32(p)))


def primes_mod(count: int) -> list:
    """`count` distinct odd primes descending from PRIME_CEIL."""
    from .exact import _is_prime_u64
    out, c = [], PRIME_CEIL
    while len(out) < count:
        if _is_prime_u64(c):
            out.append(c)
        c -= 2
        if c < 3:
            raise ValueError("prime pool below 3 exhausted")
    return out


# --------------------------------------------------------- host packing

def reduce_core_mod(core, p: int):
    """Residue matrix of a bigint core mod p, as (n, n) int64 ndarray."""
    return np.asarray([[int(v) % p for v in row] for row in core],
                      dtype=np.int64)


def pack_mod(am: np.ndarray, p: int):
    """Host pack of a residue matrix: (x0v, cols) f32 arrays.

    x0v:  (n,) walk init x0 = a[:,n-1] - rowsum/2 in Z_p (inv2 =
          (p+1)/2);
    cols: (n-1, n) residue columns, cols[k, i] = a[i, k].
    """
    n = am.shape[0]
    inv2 = (p + 1) // 2
    rs = am.sum(axis=1) % p
    x0 = (am[:, n - 1] + (p - rs) * inv2) % p
    return (x0.astype(np.float32),
            np.ascontiguousarray(am[:, : n - 1].T).astype(np.float32))


def pack_glynn_mod(am: np.ndarray, p: int):
    """Host pack for the GLYNN identity on the UNCHANGED walk.

    The NW walk body computes x += s*c with s = +1 when the gray bit
    flips to 1.  Glynn's recursion over delta vectors (delta_0 = +1
    fixed, bit k set meaning delta_{k+1} = -1) is y_j -= 2 a_{k+1,j}
    at a 0->1 flip — i.e. the SAME body applied to init y0 = all-(+1)
    column sums and column tables carrying the NEGATED doubled rows
    c_k = (-2 a_{k+1,:}) mod p.  One compiled walk therefore
    serves both identities; only this packing and the final 2^(1-n)
    scale differ (the native twin sup_perman_glynn_mod does the same).
    """
    y0 = am.sum(axis=0) % p
    neg2 = (p - (2 * am[1:, :]) % p) % p         # (n-1, n) in [0, p)
    return y0.astype(np.float32), neg2.astype(np.float32)


# ------------------------------------------------------------ the walk

def _mod_reduce(v, p, invp):
    """v (exact f32 integer in [0, 4p^2)) -> v mod p, LAZY in [0, 2p).

    invp is the downward reciprocal (_invp_down): q never overestimates
    floor(v/p), so the remainder is already nonnegative and < 2p."""
    return v - jnp.floor(v * invp) * p


def _tree_prod_mod(rows, p, invp):
    """Product of a list of LAZY residue rows (in [0, 2p)), reduced at
    every level (products of two lazy residues are exact f32 integers
    < 4p^2 < 2^24; three are not)."""
    while len(rows) > 1:
        nxt = [_mod_reduce(rows[i] * rows[i + 1], p, invp)
               for i in range(0, len(rows) - 1, 2)]
        rows = nxt + rows[len(nxt) * 2:]
    return rows[0]


def _ctz(m):
    return lax.population_count((m & -m) - _I32(1))


@functools.partial(jax.jit, static_argnames=("n", "r"))
def _walk_mod(ids, x0v, cols, p, invp, *, n: int, r: int):
    """Z_p walk of the chunks `ids` (C,) int32 (sentinels < 0 are dead
    lanes); returns the exact integer sum of the live lanes' lazy
    partial sums (int64)."""
    dead = ids < 0
    bits = gray.chunk_gray_bits(jnp.where(dead, 0, ids), n, r)
    x = jnp.broadcast_to(x0v[:, None], (n,) + ids.shape)
    for k in range(n - 1):                       # sums < n*p: exact
        x = x + cols[k][:, None] * bits[:, k].astype(jnp.float32)[None, :]
    x = _mod_reduce(x, p, invp)                              # (n, C)
    smid = (1 - 2 * (ids & 1)).astype(jnp.float32)
    p2 = p + p

    def term(x):
        return _tree_prod_mod([x[i] for i in range(n)], p, invp)

    def body(m, carry):
        x, acc = carry
        k = _ctz(m)
        s = jnp.where(((m >> (k + _I32(1))) & _I32(1)) == _I32(0),
                      jnp.float32(1), jnp.float32(-1))
        s_row = jnp.where(k == _I32(r - 1), smid, s)
        v = x + lax.dynamic_index_in_dim(cols, k, keepdims=False)[:, None] \
            * s_row[None, :]
        v = jnp.where(v < 0, v + p2, v)
        x = jnp.where(v >= p2, v - p2, v)
        prod = term(x)
        t = jnp.where((m & _I32(1)) == _I32(0), prod, p2 - prod)
        acc = acc + t
        return x, jnp.where(acc >= p2, acc - p2, acc)

    acc = term(x)                                # m = 0 term, sign +1
    _, acc = lax.fori_loop(_I32(1), _I32(1 << r), body, (x, acc))
    return jnp.sum(jnp.where(dead, 0, acc.astype(jnp.int64)))


def mod_partials(ids: np.ndarray, x0v, cols, p: int, *, n: int,
                 r: int) -> int:
    """Walk the chunk ids mod p; returns the exact integer sum of the
    lanes' partials (caller reduces mod p).  The id list is padded with
    sentinels to a power of two so compiled shapes repeat."""
    ids = np.asarray(ids, dtype=np.int64).ravel()
    C = 1 << max(0, (len(ids) - 1).bit_length())
    pad = np.full(C, -1, dtype=np.int32)
    pad[: len(ids)] = ids
    tot = _walk_mod(jnp.asarray(pad), jnp.asarray(x0v), jnp.asarray(cols),
                    jnp.float32(p), jnp.float32(_invp_down(p)), n=n, r=r)
    return int(tot)


# ------------------------------------------------------------ the driver

def _check_prime(p: int, who: str):
    if p > PRIME_CEIL or p < 3:
        # the lazy [0, 2p) walk is EXACT only while (2p)^2 < 2^24; a
        # larger modulus would round products silently — and the CRT
        # held-out verifier could NOT catch it (the same wrong f32
        # arithmetic runs for every prime), so this must be a hard error
        raise ValueError(
            f"{who}: p={p} outside [3, {PRIME_CEIL}] — lazy residue "
            f"products must stay exact f32 integers")


def perman_core_mod(core, p: int, *, ids=None, r=None) -> int:
    """per(core) mod p for a bigint core matrix, walked on the device.

    ids/r: optional pruned live-chunk plan (ids in [0, 2^(n-1-r))); the
    dense walk covers the full index space.  Matches ops/exact.py's
    _perman_mod_host / the native sup_perman_mod bit for bit in Z_p.
    """
    n = len(core)
    _check_prime(p, "perman_core_mod")
    if n == 0:
        return 1 % p
    if n == 1:
        return int(core[0][0]) % p
    am = reduce_core_mod(core, p)
    x0v, cols = pack_mod(am, p)
    if r is None:
        r = gray.make_plan(n).r
    if ids is None:
        ids = np.arange(1 << max(0, n - 1 - r), dtype=np.int64)
    elif len(ids) == 0:
        return 0          # every chunk carries a zero row: per == 0
    total = mod_partials(ids, x0v, cols, p, n=n, r=int(r))
    acc = (2 * (total % p)) % p
    if not (n & 1):
        acc = (-acc) % p
    return acc


def perman_core_glynn_mod(core, p: int) -> int:
    """per(core) mod p via the GLYNN identity on the same device walk.

    Only the host packing (pack_glynn_mod) and the final 2^(1-n) scale
    differ from perman_core_mod.  Glynn has no zero-structure pruning
    (y_j vanishes only by cancellation), so the walk is always dense —
    use it as the second-algorithm CHECK at one fresh prime of an
    NW-CRT-certified integer.
    """
    n = len(core)
    _check_prime(p, "perman_core_glynn_mod")
    if n == 0:
        return 1 % p
    if n == 1:
        return int(core[0][0]) % p
    am = reduce_core_mod(core, p)
    y0v, cols = pack_glynn_mod(am, p)
    r = gray.make_plan(n).r
    ids = np.arange(1 << max(0, n - 1 - r), dtype=np.int64)
    total = mod_partials(ids, y0v, cols, p, n=n, r=int(r))
    return (total % p) * pow((p + 1) // 2, n - 1, p) % p


def _doubled_object(core) -> np.ndarray:
    """(n, n) object ndarray of 2*entry — doubled so the half-integer
    walk values x = a[:,n-1] - rowsum/2 become exact bigints."""
    n = len(core)
    a2 = np.empty((n, n), dtype=object)
    for i, row in enumerate(core):
        for j, v in enumerate(row):
            a2[i, j] = 2 * int(v)
    return a2


def _live_exact(a2: np.ndarray, r: int):
    """Exact-bigint twin of pruning._live_for: live chunk ids at chunk
    length 2**r, with every x_z(base) == 0 test in integer arithmetic.

    pruning.py's f64 zero test is exact for half-integer walks whose
    sums fit the 53-bit mantissa; d2-folded or dyadic-lifted cores can
    exceed that (cage5_c2 lifts to 57-bit entries), where a rounded
    zero test would silently drop NONZERO terms — fatal for an exact
    engine.  Scoring may approximate; THIS mask may not.
    """
    from .pruning import const_rows, inverse_gray
    n = a2.shape[0]
    m = n - 1 - r
    if m < 1:
        return None
    support = np.vectorize(bool)(a2)
    cr = const_rows(support, r)
    if len(cr) == 0:
        return None
    from .pruning import _PAT_SUPPORT_CAP
    dead = None
    for z in cr:
        cols = np.nonzero(support[z, : n - 1])[0]
        if len(cols) > _PAT_SUPPORT_CAP:
            continue     # 2^support bigint pattern: skip = under-prune
        x0_2 = a2[z, n - 1] - sum(a2[z]) // 2       # doubled x0, exact
        pat = [x0_2]
        for j in cols:
            v = a2[z, j]
            pat = pat + [pv + v for pv in pat]
        zpat = np.array([pv == 0 for pv in pat], dtype=bool)
        if not zpat.any():
            continue
        if dead is None:
            dead = np.zeros((2,) * m, dtype=bool)
        bits = cols - r
        shape = [1] * m
        for j in bits:
            shape[m - 1 - j] = 2
        dead |= zpat.reshape(shape)
    if dead is None:
        return None
    g_live = np.nonzero(~dead.ravel())[0].astype(np.uint64)
    ids = inverse_gray(g_live, m).astype(np.int64)
    ids.sort()
    return ids


def _score_float(core) -> np.ndarray:
    """Magnitude-clipped f64 image of a bigint core — for ORDERING and
    cost scoring only (zero pattern preserved; values approximate)."""
    def f(v):
        try:
            x = float(v)
        except OverflowError:
            x = math.inf if v > 0 else -math.inf
        if not np.isfinite(x):
            x = math.copysign(1e300, x)
        return x
    return np.asarray([[f(v) for v in row] for row in core],
                      dtype=np.float64)


def core_fingerprint(core) -> str:
    """Content hash of a bigint core: keys the plan cache and stamps CRT
    checkpoint rows (a stale checkpoint from ANOTHER matrix would pass
    the held-out verifier — its residues are self-consistent — so the
    rows must be bound to the exact core they were walked for)."""
    import hashlib
    h = hashlib.sha256()
    h.update(str(len(core)).encode())
    for row in core:
        for v in row:
            h.update(b"," + str(int(v)).encode())
        h.update(b";")
    return h.hexdigest()[:16]


#: fingerprint -> core_plan result; planning a big core costs seconds to
#: minutes of host bigint work (_live_exact over up to 2^26-entry gray
#: masks), and cost ESTIMATES need the same plan the real run uses —
#: the cache makes estimate + run plan exactly once
_PLAN_CACHE: dict = {}


def core_plan(core):
    """Pruned live-chunk plan for a bigint core.

    Plan CHOICE (column order, r) comes from the engine's cost-model
    planner on a float image; the live-id mask is then recomputed in
    exact bigint arithmetic (_live_exact).  Returns (col_perm, ids, r, live_frac) or None (use the dense index
    space).  Results are cached by core fingerprint.
    """
    from .pruning import plan_sparse
    key = core_fingerprint(core)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    sp = plan_sparse(_score_float(core), chunk_log2=None, df=True,
                     allow_factor=False)
    out = None
    if sp is not None:
        a2 = _doubled_object(core)[:, sp.col_perm]
        ids = _live_exact(a2, sp.r)
        if ids is not None:
            n = len(core)
            live_frac = len(ids) / (1 << (n - 1 - sp.r))
            out = (sp.col_perm, ids, sp.r, live_frac)
    if len(_PLAN_CACHE) >= 16:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = out
    return out


def crt_perman_core(core, *, log=None, checkpoint_path=None,
                    backend: str = "device", threads: int = 0):
    """EXACT ``per(core)`` of a bigint core, by CRT over Z_p walks.

    backend="device" walks each prime on the default JAX device
    (perman_core_mod: <= 11-bit primes, lazy-residue f32 walks);
    backend="native" runs the SAME plan/CRT/verifier/checkpoint pipeline
    with the native CPU engine's 61-bit Montgomery walks
    (sup_perman_mod_pruned): ~5.5x fewer walks per bound bit.

    The live-chunk plan is computed ONCE in exact bigint arithmetic and
    shared by every prime, and a held-out verification prime certifies
    the reconstruction end to end — a kernel or CRT bug cannot return
    silently.  Returns ``(per, meta)``.

    checkpoint_path: optional JSONL of ``{"p": .., "res": .., "fp": ..}``
    rows — per-prime residues survive a crash mid-run, and a restarted
    run recomputes only the missing primes.  Every row is stamped with
    the core's fingerprint and rows for a DIFFERENT core are ignored on
    load: a stale checkpoint would otherwise pass the held-out verifier
    (its residues are mutually consistent with the OLD core) and return
    the wrong matrix's permanent as certified-exact.
    """
    import json
    import os
    from .exact import _is_prime_u64, _log2_bound, _PRIME_CEIL
    if backend not in ("device", "native"):
        raise ValueError(f"crt_perman_core: unknown backend {backend!r}")
    t0 = time.perf_counter()
    n = len(core)
    fp = core_fingerprint(core)
    bits = _log2_bound(core) + 3
    if backend == "device":
        ceil_p = PRIME_CEIL
    else:
        # IFMA hosts take <2^50 primes so every walk dispatches onto the
        # 8-lane AVX-512 lazy-residue path (bindings.native.cpu_ifma):
        # ~20% more primes per CRT bit for ~10x walk throughput
        from ..bindings.native import cpu_ifma
        ceil_p = ((1 << 50) - 1) if cpu_ifma() else _PRIME_CEIL
    need_primes, cov, c = [], 0.0, ceil_p
    while cov < bits or not need_primes:
        while not _is_prime_u64(c):
            c -= 2
        need_primes.append(c)
        cov += math.log2(c)
        c -= 2
    while not _is_prime_u64(c):
        c -= 2
    verifier = c
    known = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        stale = 0
        for line in open(checkpoint_path):
            row = json.loads(line)
            if row.get("fp") == fp:
                known[int(row["p"])] = int(row["res"])
            else:
                stale += 1
        if stale and log:
            log(f"{backend}_mod: ignoring {stale} checkpoint rows from a "
                f"different core (fingerprint mismatch)")
    plan = core_plan(core)
    if plan is not None:
        col_perm, ids, r, live_frac = plan
        work = [[core[i][j] for j in col_perm] for i in range(n)]
    else:
        work, ids, r, live_frac = core, None, None, 1.0
    if backend == "native":
        from ..bindings.native import perman_mod_batch, perman_mod_pruned

        def _residue(p):
            am = np.asarray([[int(v) % p for v in row] for row in work],
                            dtype=np.uint64)
            if ids is None:
                if n >= 10:
                    # dense index space as 64 synthetic chunks: the
                    # chunked walk dispatches onto the IFMA lanes (and
                    # spreads over host threads), the one-shot batch
                    # walk does neither
                    r_d = n - 1 - 6
                    dense_ids = np.arange(64, dtype=np.int64)
                    return perman_mod_pruned(am, p, dense_ids, r_d,
                                             threads)
                return int(perman_mod_batch(
                    am[None], np.asarray([p], np.uint64), threads)[0])
            return perman_mod_pruned(am, p, ids, r, threads)
    else:
        def _residue(p):
            return perman_core_mod(work, p, ids=ids, r=r)
    residues = []
    for i, p in enumerate(need_primes + [verifier]):
        if p in known:
            residues.append(known[p])
            continue
        residues.append(_residue(p))
        if checkpoint_path:
            with open(checkpoint_path, "a") as f:
                f.write(json.dumps({"p": p, "res": residues[-1],
                                    "fp": fp}) + "\n")
        if log:
            log(f"{backend}_mod: prime "
                f"{i + 1}/{len(need_primes) + 1} "
                f"(p={p}) done at {time.perf_counter() - t0:.1f}s")
    X, P = 0, 1
    for rr, p in zip(residues[:-1], need_primes):
        t = (rr - X) * pow(P, -1, p) % p
        X += P * t
        P *= p
    if X > P // 2:
        X -= P
    if X % verifier != residues[-1]:
        raise AssertionError(
            f"{backend} CRT verification prime mismatch — modular walk "
            f"or reconstruction is broken")
    meta = {"engine": ("device_mod" if backend == "device"
                       else "native_mod_crt"),
            "nprimes": len(need_primes),
            "bound_bits": round(bits, 1), "live_frac": live_frac,
            "r": r, "wall_s": time.perf_counter() - t0}
    return X, meta
