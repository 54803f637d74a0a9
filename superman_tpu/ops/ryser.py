"""Exact-permanent engine: planning, dispatch, reduction.

One engine over what the reference exposes as the dense exact kernel
family (gpu_exact_dense.cu wrappers p0-p6) plus the CPU parallel_perman64
(algo.h:662), parameterized by calc dtype and mesh, instead of five
memory-placement variants.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import numpy as np

from ..core.matrix import DenseMatrix
from ..core.result import Result
from .. import backend
from . import gray


def _exact_storage(dense: DenseMatrix) -> bool:
    """True when matrix values and the half-integer x walk are exact in f32
    (the int suites): f32 updates are then error-free.

    Decided on the VALUES, not the declared storage class: a float64
    matrix holding small integers (pattern .mtx files like chesapeake,
    int suites read with -w) walks identically to an "int"-typed one, and
    the declared-type gate silently downgraded its df64 path to the
    full-pair walk and its tf96 tier to a df64 fallback (tf96's product
    tree needs exact-f32 x, ryser_pallas.py)."""
    a = np.asarray(dense.mat)
    if a.dtype == np.longdouble:
        return False                  # -v storage keeps long-double bits
    a = a.astype(np.float64)
    if dense.type != "int" and not np.all(a == np.round(a)):
        return False
    return bool(np.max(np.abs(a).sum(axis=1), initial=0.0) < 2 ** 22)


def _row_scales(a: np.ndarray) -> np.ndarray:
    """Integer exponents s_j so that scaling row j by 2**-s_j bounds every
    |x_j| by ~1 along the whole walk (|x_j| <= |a[j,n-1]| + abs-rowsum/2).

    Power-of-two scaling is EXACT in binary floating point, so the f32/df64
    kernels keep their exactness guarantees while every intermediate tree
    product stays <= 1 in magnitude — overflow becomes impossible.  The
    reference instead relies on double's 11-bit exponent
    (its float/half-precision kernels overflow on the same suites).
    The permanent is recovered as result * 2**sum(s).
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    xmax = ab[:, -1] + ab.sum(axis=1) / 2
    with np.errstate(divide="ignore"):
        s = np.ceil(np.log2(np.maximum(xmax, 1e-300)))
    # wide clip: compression drivers can concentrate magnitude into rows
    # far beyond 2^+-60 (found by fuzzing); the scale is applied with
    # exact ldexp so any exponent in double range is fine
    return np.clip(s, -980, 980).astype(np.int64)


def _log2_perm_estimate(a: np.ndarray, trials: int = 6,
                        seed: int = 12345):
    """Crude host-side log2 |permanent| magnitude probe (Rasmussen's
    estimator in log space over |A|, reference algo.h:171 repurposed):
    a few n^2 greedy passes, median of the per-trial log estimates.

    Only used to CENTER the power-of-two row scaling so the scaled Gray
    total lands near 2^-12 on the first attempt: without it, matrices
    whose permanent is far below the row-scale bound (sparse suites,
    compressed drivers) need 1-2 full underflow-retry relaunches — each
    a complete engine pass.  A wrong estimate costs only a retry (the
    attempt loop with its finite/underflow fallbacks is unchanged).
    Returns None when every trial dies (permanent likely 0).
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    n = ab.shape[0]
    rng = np.random.default_rng(seed)
    # process rows sparsest-first: fewer dead ends, lower variance
    order = np.argsort((ab > 0).sum(axis=1), kind="stable")
    ests = []
    for _ in range(trials):
        used = np.zeros(n, dtype=bool)
        lg = 0.0
        for i in order:
            nz = np.nonzero((ab[i] > 0) & ~used)[0]
            if len(nz) == 0:
                lg = None
                break
            j = nz[rng.integers(len(nz))]
            lg += np.log2(len(nz)) + np.log2(ab[i, j])
            used[j] = True
        if lg is not None:
            ests.append(lg)
    return float(np.median(ests)) if ests else None


def _center_scales(a: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Shift the per-row scales so the first attempt's scaled total is
    near 2^-12 instead of underflow-retrying its way there.  The shift
    is capped at 2^60 total term growth (f32 headroom; the retry loop's
    non-finite fallback still guards mis-estimates)."""
    est = _log2_perm_estimate(a)
    if est is None or not np.isfinite(est):
        return scales
    n = a.shape[0]
    delta = min(60, max(0, int(scales.sum()) - (int(est) + 12)))
    if delta <= 0:
        return scales
    scales = scales.copy()
    per_row, rem = divmod(delta, n)
    scales -= per_row
    if rem:
        scales[:rem] -= 1
    return scales


def amp_cond_walk_log2(a: np.ndarray,
                       interpret: Optional[bool] = None) -> tuple:
    """EXACT log2 of (amp, cond): the Ryser cancellation amplitude
    sum_m |prod_i x_i(m)| and its WITHIN-LINE conditioned companion
    sum_m sum_i S_i * prod_{j!=i} |x_j(m)| over the full 2^(n-1) walk
    (S_i = row i's x-amplitude bound — the per-row error carrier scale).

    Every fixed-precision walk tier's ACCUMULATION error is
    ~amp * 2^-mantissa; its x-UPDATE error (absent only on exact-f32
    integer storage) is ~cond * 2^-mantissa_x — a line passing near
    zero mid-walk divides its carried error by |x_i|, which the plain
    amplitude cannot see (measured: pores_1_r under-predicted by ~2^27,
    round-4 real suite).  The sampled probe
    (drivers/runner._amp_probe_log2) additionally underestimates
    heavy-tailed term distributions by 50+ bits; this walk runs the
    f32+Kahan kernel with |prod| + conditioned accumulation
    (ops/ryser_pallas amp=True) — exact at the f32 walk rate.  The
    reference has no analogue: it prints noise on cancellation-bound
    inputs with no warning (SURVEY §4.3).

    Returns (log2 amp, log2 cond); (-inf, -inf) for a structurally zero
    walk, (+inf, +inf) when the measurement could not be stabilized
    (callers treat as worst case).  Per-line condition saturates at
    2^45 on the kernel path (pair-x updates, ryser_pallas._AMP_EPS)
    and 2^50 on the host path — both far past any float tier's escape
    hatch (a bound >= 2^-3 relative already reads "no correct digits").
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n == 0 or not np.all(np.any(a != 0, axis=1)):
        return float("-inf"), float("-inf")  # empty row: every x_i(m) = 0
    if n < 19:
        # host-exact: the full index space is tiny; same math as the
        # sampled probe but exhaustive (and in log space, no overflow)
        x0 = a[:, -1] - a.sum(axis=1) / 2.0
        cols = a[:, : n - 1]
        S = np.abs(x0) + np.abs(cols).sum(axis=1)    # row amplitude
        m = np.arange(1 << (n - 1), dtype=np.uint64)
        g = m ^ (m >> np.uint64(1))
        bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
                & np.uint64(1)).astype(np.float64)
        x = x0[None, :] + bits @ cols.T
        ax = np.abs(x)
        with np.errstate(divide="ignore"):
            logt = np.where(np.all(ax != 0, axis=1),
                            np.log2(ax).sum(axis=1), -np.inf)
        axc = np.maximum(ax, S[None, :] * 2.0 ** -50)
        logc = (np.log2(axc).sum(axis=1)
                + np.log2((S[None, :] / axc).sum(axis=1)))

        def _lse2(v):
            fin = v[np.isfinite(v)]
            if fin.size == 0:
                return float("-inf")
            mx = float(fin.max())
            return mx + float(np.log2(np.exp2(fin - mx).sum()))

        return _lse2(logt), _lse2(logc)
    from ..parallel.sharding import compute_partials
    if interpret is None:
        interpret = backend.interpret()
    plan = gray.make_plan(n)
    B = plan.num_chunks // plan.lanes
    ids_blocks = np.arange(plan.num_chunks,
                           dtype=np.int64).astype(np.int32).reshape(
        B, plan.lanes)
    # The kernel's conditioned accumulator assumes every scaled row has
    # amplitude ~1 (its effective S_i is 2^scale_i), so any centering or
    # retry shift must be UNIFORM across rows — a per-row adjustment
    # would silently shrink the S_i weights (measured ~1 bit low with
    # _center_scales' remainder distribution; up to 2^(60/n) with its
    # full delta).  The uniform offset c is added back to the cond
    # recovery below.
    s_raw = _row_scales(a)
    cs = _center_scales(a, s_raw)
    c0 = int(np.ceil(np.mean(s_raw - cs)))   # uniform centering amount
    shift = 0
    for _ in range(4):
        c = c0 + shift
        scales = s_raw - c
        a_s = np.ldexp(a, -scales[:, None])
        x0_pair, cols_pair = gray.pack_matrix(a_s, plan.n_pad)
        partials = compute_partials(
            ids_blocks, x0_pair, cols_pair, plan,
            df=False, exact_storage=False, mesh=None, kahan=True,
            interpret=interpret, amp=True)
        total = float(partials[0].sum(dtype=np.float64))
        cond = float(partials[1].sum(dtype=np.float64))
        if np.isfinite(total) and total > 0.0 and np.isfinite(cond):
            # row scaling is exact powers of two; the amplitude recovers
            # by 2^sum(scales), the conditioned total by an extra 2^c
            # (each row's true amplitude weight is 2^s_raw_i = 2^c times
            # the kernel's unit assumption)
            ssum = int(scales.sum())
            return (float(np.log2(total) + ssum),
                    float(np.log2(cond) + ssum + c))
        if total == 0.0:
            shift += max(1, 64 // n)    # underflow: grow the terms
        else:
            shift -= max(1, 64 // n)    # overflow: shrink the terms
    return float("inf"), float("inf")


def amp_walk_log2(a: np.ndarray, interpret: Optional[bool] = None) -> float:
    """log2 of the exact Ryser amplitude alone (see amp_cond_walk_log2)."""
    return amp_cond_walk_log2(a, interpret=interpret)[0]


def ryser_exact(dense: DenseMatrix, flags, mesh=None,
                chunk_ids: Optional[np.ndarray] = None) -> Result:
    """Exact permanent of `dense`.

    chunk_ids: optional pruned live-chunk list (sparse/SkipPer path;
    pruned chunks contribute exactly zero, so no correction term exists).
    """
    a = np.asarray(dense.mat)
    n = a.shape[0]
    calc = flags.resolved_calc()
    t0 = time.perf_counter()

    if n <= 2:
        from .oracle import perman_brute
        p = perman_brute(a)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name="ryser_exact", iterations=1)

    if calc == "quad" or (calc == "tf96" and n < 19):
        # quad: host long-double walk.  Small-n tf96 lands here too: the
        # kernel tier needs n >= 19 and the XLA fallback below would
        # silently degrade it to f32; the long-double walk meets
        # (exceeds) the tf96 ~1e-12 contract.
        from .oracle import perman64
        p = perman64(a, dtype=np.longdouble)
        name = "ryser_quad_host" if calc == "quad" else "ryser_tf96_host"
        return Result(float(p), time.perf_counter() - t0,
                      algo_name=name, iterations=1 << (n - 1),
                      meta={"calc": calc})

    if calc == "f64" or n < 19:
        from .ryser_xla import ryser_xla
        import jax.numpy as jnp
        dt = (jnp.float64 if calc in ("f64", "df64", "f32k")
              else jnp.float32)
        p = ryser_xla(a, dtype=dt)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name=f"ryser_xla_{calc}",
                      iterations=1 << (n - 1),
                      meta={"calc": calc})

    # ---- kernel path (calc f32 / f32k / df64 / tf96) ----
    df = calc == "df64"
    kahan = calc == "f32k"
    tf = calc == "tf96"
    exact_storage = _exact_storage(dense)
    if tf and (not exact_storage or flags.hybrid or flags.checkpoint_path):
        # tf96 needs f32-exact x updates (int suites) and the long-double
        # reduction path (the hybrid scheduler journals f64 unit sums)
        import warnings
        warnings.warn("tf96 requires exact-f32 storage and the non-hybrid "
                      "path; falling back to df64")
        tf, df, calc = False, True, "df64"

    # trivial zero: an empty row or column makes the permanent 0 and also
    # breaks the row-scaling heuristic, so dispose of it here
    if (np.count_nonzero(a, axis=1) == 0).any() or \
       (np.count_nonzero(a, axis=0) == 0).any():
        return Result(0.0, time.perf_counter() - t0,
                      algo_name=f"ryser_pallas_{calc}", iterations=0,
                      meta={"reason": "empty row/col"})

    from ..parallel.sharding import pad_ids, compute_partials
    num_shards = (int(np.prod(mesh.devices.shape))
                  if mesh is not None else 1)
    # -e/grid_multip: the reference multiplies its CUDA grid dim
    # (revised_perman/gpu_exact_dense.cu:902-905); here it
    # over-decomposes into grid_multip x more (shorter) chunk blocks
    gm = max(1, int(getattr(flags, "grid_multip", 1)))
    min_blocks = 32 if (flags.hybrid or flags.checkpoint_path) else 1
    plan = None
    factor_rows = None
    alive_rows = None
    sparse_meta = None
    # auto-sparse: on clearly sparse inputs the pruned engine engages
    # even without -s (the planner declines when unprofitable, and its
    # candidate evaluation costs ~20-40 ms, only worth it at n >= 28
    # where the dense walk is >= 0.1 s).  skip_pruning=False forces the
    # pure dense walk (benchmark baseline).
    density = np.count_nonzero(a) / max(1, a.size)
    auto_sparse = n >= 28 and density < 0.30
    if chunk_ids is None and (flags.sparse or auto_sparse) \
            and flags.skip_pruning:
        from .pruning import plan_sparse
        # row factoring works on the single-device, mesh and multi-host
        # engines (each shard derives its weights on device from its id
        # slice); only the hybrid scheduler keeps the full-row walk —
        # it journals unweighted unit sums
        allow_factor = not (flags.hybrid or flags.checkpoint_path)
        from ..utils import trace as _trace
        with _trace.timer("sparse_plan"):
            sp = plan_sparse(a, chunk_log2=flags.chunk_log2,
                             df=df or tf, allow_factor=allow_factor)
        if sp is not None:
            a = np.ascontiguousarray(a[:, sp.col_perm])
            chunk_ids = sp.ids
            if len(sp.factor_rows):
                factor_rows, alive_rows = sp.factor_rows, sp.alive_rows
            n_pad = (len(sp.alive_rows) if factor_rows is not None
                     else n)
            lanes_t = flags.lanes or 1024
            # sharded pruned walks shrink L so the >= 1 block/shard
            # floor doesn't walk mostly-dead lanes (48% useful at 64
            # shards with a fixed L=512)
            from ..parallel.sharding import sparse_lanes
            lanes_t = sparse_lanes(len(sp.ids), num_shards, lanes_t)
            nchunks = 1 << (n - 1 - sp.r)
            plan = gray.RyserPlan(n=n, n_pad=n_pad, r=sp.r,
                                  lanes=min(lanes_t, nchunks),
                                  num_chunks=nchunks)
            sparse_meta = {"dead_frac": round(sp.dead_frac, 4),
                           "factored_rows": len(sp.factor_rows),
                           "r": sp.r}
    if plan is None:
        plan = gray.make_plan(
            n, flags.lanes, flags.chunk_log2,
            num_shards=num_shards, min_blocks=min_blocks, grid_multip=gm)
    if chunk_ids is None:
        chunk_ids = np.arange(plan.num_chunks, dtype=np.int64)
    live = len(chunk_ids)
    if live == 0:
        return Result(0.0, time.perf_counter() - t0,
                      algo_name=f"ryser_pallas_{calc}", iterations=0,
                      meta={"reason": "all chunks pruned"})

    ids_blocks = pad_ids(np.asarray(chunk_ids, dtype=np.int64).astype(
        np.int32), plan.lanes, num_shards,
        block_multiple=32 if sparse_meta is not None else 1)
    # multi-host: each host takes its deterministic interleaved block
    # slice and runs the normal engine on it; totals are combined with
    # one f64 allgather (parallel/multihost.py)
    nprocs = jax.process_count()
    if nprocs > 1:
        from ..parallel.multihost import host_slice
        ids_blocks = pad_ids(
            host_slice(ids_blocks, jax.process_index(), nprocs).ravel(),
            plan.lanes, num_shards,
            block_multiple=32 if sparse_meta is not None else 1)
        if ids_blocks.size == 0:
            ids_blocks = np.full((num_shards, plan.lanes), -1, np.int32)
    interpret = backend.interpret()
    # launch-decision log (parity: the reference's occupancy log lines,
    # "==SC== Grid dim is set to", revised_perman/gpu_exact_dense.cu:898)
    from ..utils import trace
    trace.log(f"plan: n={n} n_pad={plan.n_pad} r={plan.r} "
              f"lanes={plan.lanes} chunks={live}/{plan.num_chunks} "
              f"calc={calc} shards={num_shards}", level=2)

    scales = _center_scales(a, _row_scales(a))
    hybrid_stats = None
    best = None                 # (total, E) of the last FINITE attempt
    shifted = 0                 # cumulative per-row downshift (log2)
    shift_cap = max(1, 100 // n)   # total growth <= 2^100 across attempts
    for attempt in range(3):
        # ldexp applies the per-row exponent exactly even when 2**-s
        # alone would overflow double (rows at 2^-500 scale fine)
        a_s = np.ldexp(a.astype(np.float64), -scales[:, None])
        factors = None
        if factor_rows is not None:
            # factored constant rows: the kernel walks only alive_rows;
            # each chunk's constant-row product becomes a per-lane df64
            # (or longdouble for tf96) weight applied before reduction.
            # The weight pack rides to the device as a tiny row subset
            # (gray.factor_weights rebuilds per-chunk products there);
            # host_fn covers the unreduced paths.
            from .pruning import chunk_factors
            nf_pad = len(factor_rows)
            fx0_pair, fcols_pair = gray.pack_matrix(a_s[factor_rows],
                                                    nf_pad)
            a_s_att = a_s

            def host_fn(blk, _a=a_s_att):
                return chunk_factors(
                    _a, factor_rows, blk, plan.r,
                    dtype=np.longdouble if tf else np.float64)

            factors = (fx0_pair, fcols_pair, nf_pad, host_fn)
        from ..utils import trace as _trace
        with _trace.timer("pack"):
            a_pack = a_s[alive_rows] if factor_rows is not None else a_s
            x0_pair, cols_pair = gray.pack_matrix(a_pack, plan.n_pad)
        # a checkpoint path routes through the journaling scheduler even
        # without the CPU helper (device-only unit queue)
        if flags.hybrid or flags.checkpoint_path:
            from ..parallel.scheduler import compute_partials_hybrid
            total, hybrid_stats = compute_partials_hybrid(
                a_s, ids_blocks, x0_pair, cols_pair, plan,
                df=df, exact_storage=exact_storage, mesh=mesh,
                kahan=kahan, interpret=interpret, threads=flags.threads,
                cpu_helper=flags.cpu,
                checkpoint_path=flags.checkpoint_path)
        else:
            # chop the block list into power-of-2-sized groups so the set
            # of compiled kernel shapes is {1,2,4,...} x num_shards and is
            # REUSED across matrices (the post-pruning block count varies
            # per matrix; without this every sparse matrix would compile
            # its own kernel)
            total = np.longdouble(0.0) if tf else 0.0
            q = ids_blocks.shape[0] // num_shards
            off = 0
            for bit in reversed(range(max(1, q).bit_length())):
                sz = 1 << bit
                if q & sz:
                    sl = slice(off * num_shards, (off + sz) * num_shards)
                    blk = ids_blocks[sl]
                    partials = compute_partials(
                        blk, x0_pair, cols_pair, plan,
                        df=df, exact_storage=exact_storage, mesh=mesh,
                        kahan=kahan, tf=tf, interpret=interpret,
                        factors=factors,
                        reduce_ok=sparse_meta is not None)
                    if tf:
                        total += partials.sum(dtype=np.longdouble)
                    else:
                        total += float(partials.sum(dtype=np.float64))
                    off += sz
        if nprocs > 1:
            # one f64 scalar over DCN; also keeps the underflow-retry
            # decision below consistent across hosts
            from ..parallel.multihost import combine_host_totals
            total = combine_host_totals(total)
        # scaled sums far below 1 may have lost underflowed terms; shift
        # the row scales to center the result near 2^0 and rerun (scaling
        # is exact, so a rerun is a pure exponent adjustment).  Shifts are
        # bounded CUMULATIVELY — compounding them overflowed f32 to
        # inf/NaN on signed near-zero-permanent matrices (found by
        # fuzzing) — and a non-finite rerun falls back to the last finite
        # attempt.
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
    # ldexp multiplies by 2**E exactly, handling E beyond the exponent
    # range of a standalone 2.0**E (which would overflow to inf even when
    # total * 2**E is finite); out-of-range RESULTS become the honest
    # double inf/0 rather than raising (found by fuzzing).  tf96 keeps
    # the long-double precision until this final rounding.
    with np.errstate(over="ignore"):
        if tf:
            p = float((4 * (n & 1) - 2)
                      * np.ldexp(np.longdouble(total), E)) + 0.0
        else:
            p = float((4 * (n & 1) - 2)
                      * np.ldexp(np.float64(total), E)) + 0.0
    dt = time.perf_counter() - t0
    iters = live << plan.r
    meta = {"calc": calc, "chunks": live, "r": plan.r,
            "lanes": plan.lanes, "scale_log2": E,
            "mesh": None if mesh is None else num_shards,
            "iters_per_sec": iters / dt}
    if sparse_meta is not None:
        meta["sparse"] = sparse_meta
    name = f"ryser_pallas_{calc}"
    if hybrid_stats is not None:
        name = f"ryser_hybrid_{calc}"
        meta["hybrid"] = {
            "units": hybrid_stats.units_total,
            "device": hybrid_stats.units_device,
            "cpu": hybrid_stats.units_cpu,
            "resumed": hybrid_stats.units_resumed,
            "retries": hybrid_stats.retries,
            "handoffs": hybrid_stats.handoffs}
    return Result(p, dt, algo_name=name, iterations=iters, meta=meta)
