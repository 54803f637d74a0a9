"""SMC flagship capture: the 36x36 grid (n=648) population estimate vs
the Kasteleyn closed form, written as a JSONL artifact.

This tool writes one JSON line per run (DEMO_SMC.jsonl by default) with
the estimate, its cross-population sigma and the walls.  The grid
flagship is the reference's own headline approximation target
(gpu_approximation_dense RunPermanForGridGraphs, main.cu:250); the
closed-form truth is prep/gridgraph.kasteleyn_log2.

scale_intervals is NOT passed: the run exercises the auto-selector
(ops/approx._select_si) end to end, so the headline number does not
depend on a hand-tuned constant.

Run on the GPU:  python -m superman_tpu.tools.smc_flagship
  [--grid 36] [--trials 100000] [--seed 11] [--out DEMO_SMC.jsonl]
"""

from __future__ import annotations

import json
import time

import numpy as np


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=36)
    p.add_argument("--trials", type=int, default=100000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", default="DEMO_SMC.jsonl")
    args = p.parse_args(argv)

    import superman_tpu as sp
    from superman_tpu.prep.gridgraph import kasteleyn_log2

    g = args.grid
    exact_l2 = float(kasteleyn_log2(g, g))
    # warm-up run (compiles every (B, si) shape), then the timed run
    kw = dict(grid_graph=True, gridm=g, gridn=g, approximation=True,
              perman_algo="scaling", smc=1, number_of_times=args.trials)
    sp.permanent(None, seed=args.seed + 1, **kw)
    t0 = time.perf_counter()
    r = sp.permanent(None, seed=args.seed, **kw)
    wall = time.perf_counter() - t0

    est_l2 = float(r.meta["log2_estimate"])
    stderr_rel = float(r.meta["stderr_rel"])
    sig_l2 = stderr_rel / float(np.log(2.0))
    z = (est_l2 - exact_l2) / sig_l2 if sig_l2 > 0 else float("inf")
    row = {"grid": g, "n": g * g // 2, "trials": int(r.meta["trials"]),
           "populations": r.meta["populations"],
           "scale_intervals": r.meta["scale_intervals"],
           "si_auto": r.meta.get("si_auto"),
           "est_log2": round(est_l2, 4), "exact_log2": round(exact_l2, 4),
           "sigma_log2": round(sig_l2, 4), "z": round(z, 3),
           "stderr_rel": round(stderr_rel, 5),
           "warm_wall_s": round(wall, 2), "seed": args.seed}
    with open(args.out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))
    ok = abs(z) <= 3.0
    print(f"flagship: est {est_l2:.4f} vs exact {exact_l2:.4f} "
          f"(z = {z:.2f}, si = {row['scale_intervals']}) "
          f"[{'OK' if ok else 'FAIL'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
