"""Time the Gray-walk kernel against XLA's plain walk on one device.

    python -m superman_tpu.tools.walk_bench [--n 32] [--tiers f32,df64]
                                            [--unroll 1,2,3,4] [--xla] [--e2e]

For each tier the kernel walks the whole 2^(n-1) index space of a seeded
0/1 matrix (density 0.5) in the dense plan the engine uses (ops/gray.py
make_plan), once to compile and then --reps times; each timed run ends
in block_until_ready.  --unroll times every listed static unroll u.
--xla times ops/ryser_xla._walk (f32 and f64) with the same lane count,
the plain walk that XLA compiles without a hand-written kernel.  --e2e
times sp.permanent itself (warm: compile excluded) for each tier and for
calc="f64", the engine's plain-XLA float64 path.  Every line is one JSON
object; rates are Gray iterations per second.  The kernel's value is
checked against the f64 XLA walk.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _timed(fn, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return first, min(walls) if walls else first, walls


def _tier(name):
    from ..ops import ryser_pallas as rp
    return {"f32": rp.Tier(), "f32k": rp.Tier(kahan=True),
            "df64": rp.Tier(df=True),
            "df64_full": rp.Tier(df=True, exact_storage=False),
            "tf96": rp.Tier(tf=True)}[name]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tiers", default="f32,f32k,df64,tf96")
    ap.add_argument("--unroll", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--xla", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .. import backend
    from ..ops import gray, ryser_pallas as rp
    from ..ops.ryser import _row_scales
    from ..ops.ryser_xla import _walk
    from ..ops.oracle import gray_init_lanes

    n = args.n
    rng = np.random.default_rng(args.seed)
    a = (rng.random((n, n)) < 0.5).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    a_s = np.ldexp(a, -_row_scales(a)[:, None])
    plan = gray.make_plan(n)
    iters = float(plan.num_chunks) * (1 << plan.r)
    interpret = backend.interpret()
    dev = jax.devices()[0]
    head = {"device": dev.device_kind, "platform": dev.platform,
            "n": n, "r": plan.r, "chunks": plan.num_chunks}
    ids = jnp.asarray(np.arange(plan.num_chunks, dtype=np.int32)
                      .reshape(-1, plan.lanes))
    x0p, colsp = (jnp.asarray(v) for v in gray.pack_matrix(a_s, n))

    # the f64 XLA walk is the reference value for every kernel line
    ref = None
    X, smid = gray_init_lanes(a_s, np.arange(plan.num_chunks), plan.r,
                              dtype=np.float64)
    cols = a_s[:, : n - 1].T
    for dt in ((jnp.float32, jnp.float64) if args.xla else (jnp.float64,)):
        Xd, sd, cd = (jnp.asarray(v, dt) for v in (X, smid, cols))
        f = lambda: _walk(Xd, sd, cd, n=n, r=plan.r, dtype=dt)
        first, best, walls = _timed(f, args.reps if args.xla else 0)
        tot = float(np.asarray(f(), np.float64).sum())
        if dt == jnp.float64:
            ref = tot
        if args.xla:
            print(json.dumps({**head, "impl": "xla_walk",
                              "dtype": jnp.dtype(dt).name,
                              "first_s": first, "best_s": best,
                              "walls": walls,
                              "giters_s": iters / best / 1e9}), flush=True)

    for name in args.tiers.split(","):
        tier = _tier(name)
        xhi, xlo, smid = gray.chunk_init(ids, x0p, colsp, n=n, n_pad=n,
                                         r=plan.r, df=tier.full_df)
        us = ([int(u) for u in args.unroll.split(",")] if args.unroll
              else [rp.unroll_for(tier, plan.r, interpret)])
        for u in us:
            f = lambda: rp.walk_lanes(xhi, xlo, smid, colsp, r=plan.r, u=u,
                                      tier=tier, interpret=interpret)
            first, best, walls = _timed(f, args.reps)
            out = np.asarray(f(), np.float64)
            w = out[:, :tier.words].sum(axis=1)
            tot = float(w.sum())
            rel = abs(tot - ref) / abs(ref) if ref else float("nan")
            print(json.dumps({**head, "impl": "kernel", "tier": name,
                              "u": u, "first_s": first, "best_s": best,
                              "walls": walls,
                              "giters_s": iters / best / 1e9,
                              "rel_vs_f64_walk": rel}), flush=True)


    if args.e2e:
        import superman_tpu as sp
        for calc in args.tiers.split(",") + ["f64"]:
            calc = "df64" if calc == "df64_full" else calc
            f = lambda: sp.permanent(a, calc=calc, skip_pruning=False)
            first, best, walls = _timed(lambda: f().permanent, args.reps)
            print(json.dumps({**head, "impl": "sp.permanent", "calc": calc,
                              "first_s": first, "best_s": best,
                              "walls": walls, "value": f().permanent}),
                  flush=True)


if __name__ == "__main__":
    main()
