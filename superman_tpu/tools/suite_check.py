"""Cross-engine sweep over the reference's Erdős–Rényi suites.

Runs the device df64 engine against the independent native C++ double engine
on bundled reference matrices (BASELINE.md correctness target: int suites
n=30-33 across densities) and reports per-matrix relative differences.

    python -m superman_tpu.tools.suite_check [--n 30 32] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def check(files, out=None, log=print, calc="df64"):
    import numpy as np
    import superman_tpu as sp
    from superman_tpu.bindings.native import native_available

    if not native_available():
        raise RuntimeError("native engine unavailable")
    rows = []
    worst = 0.0
    for path in files:
        t0 = time.time()
        dev = sp.permanent(path, calc=calc)
        nat = sp.permanent(path, calc="f64", cpu=True, gpu=False)
        rel = (abs(dev.permanent - nat.permanent)
               / max(abs(nat.permanent), 1e-300))
        worst = max(worst, rel)
        rec = {"file": path.split("/")[-1], "calc": calc,
               "device": dev.permanent, "native_double": nat.permanent,
               "rel_diff": float(f"{rel:.3e}"),
               "device_s": round(dev.time, 3), "native_s": round(nat.time, 3),
               "wall_s": round(time.time() - t0, 2)}
        rows.append(rec)
        log(json.dumps(rec))
    summary = {"matrices": len(rows), "worst_rel_diff": float(f"{worst:.3e}")}
    log(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            for rec in rows + [summary]:
                f.write(json.dumps(rec) + "\n")
    return rows, worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-suite-check")
    p.add_argument("--n", type=int, nargs="+", default=[30, 31, 32])
    p.add_argument("--densities", nargs="+",
                   default=["0.10", "0.20", "0.30", "0.50", "0.70", "0.90"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--root", default="/root/reference/int")
    p.add_argument("--out", default=None)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--calc", default="df64")
    args = p.parse_args(argv)
    import os
    cand = [f"{args.root}/{n}_{d}_{s}"
            for n in args.n for d in args.densities for s in args.seeds]
    files = [f for f in cand if os.path.exists(f)]
    for f in sorted(set(cand) - set(files)):
        print(f"suite_check: skipping missing {f}", file=sys.stderr)
    _, worst = check(files, out=args.out, calc=args.calc)
    if worst > args.tol:
        print(f"SUITE CHECK FAILED: worst rel diff {worst:.3e} > {args.tol}",
              file=sys.stderr)
        return 1
    print(f"SUITE CHECK OK: worst rel diff {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
