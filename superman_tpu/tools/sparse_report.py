"""Sparse-engine hardware evidence: wall-clock + accuracy sweep.

For each sparse suite matrix, runs the dense df64 walk and the pruned
sparse walk on the GPU, checks both against the recorded
native-double value (from suite report files when present, or fresh
native when absent), and records speedup + plan facts.

    python -m superman_tpu.tools.sparse_report [--out FILE]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def recorded_native(root: str) -> dict:
    vals = {}
    for path in glob.glob(os.path.join(root, "SUITE_REPORT*.jsonl")):
        with open(path) as f:
            for ln in f:
                d = json.loads(ln)
                if "file" in d and "native_double" in d:
                    vals[d["file"]] = d["native_double"]
    return vals


def run(files, out=None, log=print, repo_root="/root/repo"):
    import numpy as np
    import superman_tpu as sp

    native = recorded_native(repo_root)
    rows = []
    worst = 0.0
    for path in files:
        name = path.split("/")[-1]
        want = native.get(name)
        if want is None:
            from superman_tpu.bindings.native import native_available
            if not native_available():
                log(f"skip {name}: no recorded or computable native value")
                continue
            want = sp.permanent(path, calc="f64", cpu=True,
                                gpu=False).permanent
        # skip_pruning=False forces the pure dense walk (the
        # engine auto-engages sparse on these inputs otherwise)
        sp.permanent(path, calc="df64", skip_pruning=False)
        t = []
        for _ in range(2):
            t0 = time.perf_counter()
            dres = sp.permanent(path, calc="df64",
                                skip_pruning=False)
            t.append(time.perf_counter() - t0)
        dense_wall = min(t)
        sp.permanent(path, sparse=True, calc="df64")     # warm sparse
        t = []
        for _ in range(2):
            t0 = time.perf_counter()
            sres = sp.permanent(path, sparse=True, calc="df64")
            t.append(time.perf_counter() - t0)
        sparse_wall = min(t)
        rel = abs(sres.permanent - want) / max(abs(want), 1e-300)
        worst = max(worst, rel)
        rec = {"file": name, "native_double": want,
               "sparse": sres.permanent,
               "rel_diff": float(f"{rel:.3e}"),
               "sparse_wall_s": round(sparse_wall, 4),
               "dense_wall_s": round(dense_wall, 4),
               "speedup": round(dense_wall / sparse_wall, 3),
               "plan": sres.meta.get("sparse")}
        rows.append(rec)
        log(json.dumps(rec))
    summary = {"matrices": len(rows),
               "worst_rel_diff": float(f"{worst:.3e}"),
               "mean_speedup": round(
                   float(np.mean([r["speedup"] for r in rows])), 3)
               if rows else None}
    log(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            for rec in rows + [summary]:
                f.write(json.dumps(rec) + "\n")
    return rows, worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-sparse-report")
    p.add_argument("--n", type=int, nargs="+", default=[32])
    p.add_argument("--densities", nargs="+",
                   default=["0.10", "0.15", "0.20", "0.25"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--root", default="/root/reference/int")
    p.add_argument("--out", default=None)
    p.add_argument("--tol", type=float, default=1e-8)
    args = p.parse_args(argv)
    files = [f"{args.root}/{n}_{d}_{s}" for n in args.n
             for d in args.densities for s in args.seeds]
    files = [f for f in files if os.path.exists(f)]
    _, worst = run(files, out=args.out)
    return 0 if worst <= args.tol else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
