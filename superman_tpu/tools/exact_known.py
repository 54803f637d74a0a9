"""Build EXACT_KNOWN.jsonl: certified exact permanents of the reference
corpus (SURVEY §4.3 known-answer mechanism, done properly).

The reference ships its real matrices with NO recorded values; worse, on
cancellation-bound files (pores_1_r: amplitude ~2^280 over |per|) every
fixed-precision engine it has — double AND __float128 — returns noise.
The modular-CRT engine (ops/exact.py) computes the true integer
permanent with an end-to-end held-out-prime certificate, giving this
corpus its first actual known answers.  real_suite.py arbitrates
against these rows.

Run:  python -m superman_tpu.tools.exact_known [--out EXACT_KNOWN.jsonl]
      [--budget SECONDS] [--files SUBSTR ...] [--merge] [--reverify]

--merge keeps existing rows (skipping their files) so a later run can
extend the table with just the big cores (chesapeake core n=39,
cage5_c2 n=37, will57 core n=49) without re-paying the already-certified
rows.

--reverify recomputes every existing row through the native CRT
pipeline and compares exact numerators.  Because that pipeline picks
its prime ceiling by host capability (<2^50 IFMA lanes vs <2^61
scalar), a re-run on a different-era host uses a DISJOINT prime set
and different arithmetic — each row's original held-out certificate
is then cross-checked by an independent reconstruction.

On top of that, reverify runs the SECOND ALGORITHM: per_core is checked
mod a fresh ~2^49 prime against the native Glynn polarization walk
(bindings.native.perman_glynn_mod) whenever the core's 2^(n-1) Gray
space fits --algo2-iters.  The CRT held-out prime only catches walk
bugs that perturb residues INCONSISTENTLY across primes; a systematic
bug (wrong plan, wrong fold, wrong walk identity) corrupts every
Nijenhuis–Wilf residue identically and sails through — it cannot also
reproduce under Glynn's different identity.  The ~2^49 check prime is
structurally disjoint from every certification prime set (native IFMA
descends from 2^50-1, scalar native from ~2^61, the device Z_p walk
uses <=11-bit primes).  --report writes the summary artifact
(EXACT_REVERIFY.json) that tests/test_evidence.py pins.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="EXACT_KNOWN.jsonl")
    p.add_argument("--budget", type=float, default=2000.0,
                   help="per-file cost-estimate cap in seconds")
    p.add_argument("--files", nargs="*", default=None,
                   help="only files whose name contains one of these")
    p.add_argument("--merge", action="store_true",
                   help="keep existing rows; only compute missing files")
    p.add_argument("--reverify", action="store_true",
                   help="recompute every existing row (native CRT, "
                        "host-capability prime set) and compare")
    p.add_argument("--algo2-iters", type=float, default=None,
                   help="max 2^(core_n-1) Gray iters for the Glynn "
                        "second-algorithm check (default ~1.3e8 on "
                        "IFMA hosts, ~8e6 scalar)")
    p.add_argument("--report", default=None,
                   help="write a JSON reverify summary artifact here")
    p.add_argument("--algo2-device", action="store_true",
                   help="device Glynn second-algorithm check of existing "
                        "rows at one fresh <=2039 prime (for cores past "
                        "the CPU Glynn frontier); merges into --report")
    args = p.parse_args(argv)

    from ..io.matrixmarket import read_any
    from ..ops import exact
    from .real_suite import corpus

    if args.algo2_device:
        return _algo2_device(args, read_any, exact, corpus)

    if args.reverify:
        # reverify is BY DESIGN a host-only independent reconstruction:
        # keep it off the accelerator
        try:
            import jax
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
        return _reverify(args, read_any, exact, corpus)

    done, declined = {}, {}
    if args.merge and os.path.exists(args.out):
        for line in open(args.out):
            row = json.loads(line)
            # declined-plan ledger rows never block a recompute attempt
            # (a better plan or bigger budget may certify them later)
            if row.get("declined"):
                declined[row["file"]] = line.rstrip("\n")
            else:
                done[row["file"]] = line.rstrip("\n")

    out = open(args.out + ".partial", "w")
    for line in done.values():
        out.write(line + "\n")
    for path in corpus():
        name = os.path.basename(path)
        if name in done:
            continue
        if args.files and not any(s in name for s in args.files):
            continue
        a = np.asarray(read_any(path, 0, 0, 0).mat, np.float64)
        secs, npr, core_n = exact.exact_cost_estimate(a)
        if secs > args.budget:
            # guard-visible measured decline (round-4 verdict item 7):
            # the plan ledger records WHY this file has no exact value
            # (engine None keeps every consumer skipping it)
            declined[name] = json.dumps(
                {"file": name, "n": int(a.shape[0]), "core_n": core_n,
                 "nprimes": npr, "value": None, "engine": None,
                 "declined": True, "est_secs": round(float(secs), 0),
                 "budget_s": args.budget})
            print(f"{name}: declined (est {secs:.0f} s, core n={core_n})"
                  " — ledger row recorded", flush=True)
            continue
        declined.pop(name, None)
        t0 = time.time()
        frac, meta = exact.perman_exact_fraction(
            a, log=lambda s: print(f"  {name}: {s}", flush=True),
            checkpoint_path=args.out + f".ck.{name}.jsonl")
        val = exact._float_of_fraction(frac)
        sign, l2 = ((0.0, None) if frac == 0 else
                    (1.0 if frac > 0 else -1.0,
                     exact.log2_abs_fraction(frac)))
        num = str(frac.numerator)
        row = {"file": name, "n": int(a.shape[0]),
               "core_n": meta["core_n"], "nprimes": meta.get("nprimes"),
               "k": meta["k"], "value": val, "sign": sign,
               "log2_abs": l2,
               # keep rows self-contained: the cage5-class lifted cores
               # run to ~2110 bits (~640 digits), and algo2 checks
               # reconstruct per_core from the stored numerator
               "numerator": num if len(num) <= 4000 else num[:40] + "...",
               "denominator_log2": meta["k"] * int(a.shape[0]),
               "wall_s": round(time.time() - t0, 2),
               "engine": meta.get("engine")}
        out.write(json.dumps(row) + "\n")
        out.flush()
        ck = args.out + f".ck.{name}.jsonl"
        if os.path.exists(ck):
            os.remove(ck)           # row certified; residues obsolete
        print(f"{name}: per = {val:.12e} (core n={meta['core_n']}, "
              f"{row['wall_s']} s)", flush=True)
    for line in declined.values():
        out.write(line + "\n")
    out.close()
    os.replace(args.out + ".partial", args.out)
    return 0


def _glynn_check_prime(exact):
    """Fresh ~2^49 prime for the second-algorithm check — structurally
    disjoint from every certification prime set (see module doc)."""
    c = (1 << 49) - 1
    while not exact._is_prime_u64(c):
        c -= 2
    return c


def _merge_report(path, new_rows, extra=None):
    """Merge per-file rows into the reverify report artifact."""
    merged, base = {}, {}
    if os.path.exists(path):
        try:
            base = json.load(open(path))
            merged = {r["file"]: r for r in base.get("rows", [])}
        except Exception:
            merged, base = {}, {}
    for r in new_rows:
        merged.setdefault(r["file"], {}).update(r)
    rows_out = [merged[k] for k in sorted(merged)]
    n_bad = sum(1 for r in rows_out
                if r.get("crt_match") is False
                or r.get("glynn_ok") is False
                or r.get("glynn_device_ok") is False)
    base.update(rows=rows_out, n_match=len(rows_out) - n_bad,
                n_mismatch=n_bad)
    if extra:
        base.update(extra)
    with open(path, "w") as f:
        json.dump(base, f, indent=1)


def _algo2_device(args, read_any, exact, corpus):
    """Device Glynn check: reconstruct per_core from a row's stored exact
    numerator (per_core = numerator / mult, both integers after the
    2^(k*n) denominator cancels) and compare mod a fresh <=2039 prime
    against ops/modp.perman_core_glynn_mod — the second-algorithm
    certificate for cores past the CPU Glynn frontier (will57 n=49).
    The fresh prime is primes_mod(nprimes+2)[-1]: deterministically
    below every prime the certification run consumed."""
    from fractions import Fraction

    from ..ops import modp

    rows = {}
    for line in open(args.out):
        d = json.loads(line)
        rows[d["file"]] = d
    paths = {os.path.basename(p): p for p in corpus()}
    report, bad = [], 0
    for name, row in sorted(rows.items()):
        if args.files and not any(s in name for s in args.files):
            continue
        if not row.get("engine") or row["engine"] == "fold_only":
            continue
        if row["numerator"].endswith("..."):
            print(f"{name}: numerator truncated in the row — recertify "
                  f"with the current writer first", flush=True)
            continue
        a = np.asarray(read_any(paths[name], 0, 0, 0).mat, np.float64)
        m, k = exact.dyadic_int_matrix(a)
        core, mult = exact._fold_lines(m)
        if not core:
            continue
        frac = Fraction(int(row["numerator"]),
                        1 << row["denominator_log2"])
        per_core_frac = frac * (1 << (k * a.shape[0])) / mult
        assert per_core_frac.denominator == 1, name
        per_core = per_core_frac.numerator
        pg = modp.primes_mod((row.get("nprimes") or 1) + 2)[-1]
        t0 = time.time()
        got = modp.perman_core_glynn_mod(core, pg)
        ok = bool(got == per_core % pg)
        bad += not ok
        print(f"{name}: glynn_device={'OK' if ok else 'FAIL'} (p={pg}, "
              f"core n={len(core)}, {time.time() - t0:.1f} s)",
              flush=True)
        report.append({"file": name, "glynn_device_ok": ok,
                       "glynn_device_prime": pg,
                       "glynn_device_wall_s": round(time.time() - t0, 1)})
    if args.report and report:
        _merge_report(args.report, report)
    print(f"algo2-device: {len(report) - bad} OK, {bad} FAIL", flush=True)
    return 0 if bad == 0 else 1


def _reverify(args, read_any, exact, corpus):
    from fractions import Fraction

    from ..bindings.native import cpu_ifma, perman_glynn_mod
    from ..ops import modp

    algo2_iters = args.algo2_iters
    if algo2_iters is None:
        algo2_iters = float(1 << 27) if cpu_ifma() else float(1 << 23)
    pg = _glynn_check_prime(exact)
    rows = {}
    for line in open(args.out):
        d = json.loads(line)
        rows[d["file"]] = d
    paths = {os.path.basename(p): p for p in corpus()}
    ok = bad = skipped = 0
    report = []
    for name, row in sorted(rows.items()):
        if not row.get("engine") or row["engine"] == "fold_only":
            skipped += 1
            continue
        if args.files and not any(s in name for s in args.files):
            skipped += 1
            continue
        a = np.asarray(read_any(paths[name], 0, 0, 0).mat, np.float64)
        secs, _, core_n = exact.exact_cost_estimate(a)
        if secs > args.budget:
            print(f"{name}: skipped (est {secs:.0f} s)", flush=True)
            skipped += 1
            continue
        m, k = exact.dyadic_int_matrix(a)
        core, mult = exact._fold_lines(m)
        t0 = time.time()
        per_core = (modp.crt_perman_core(core, backend="native")[0]
                    if core else 1)
        # rows store the REDUCED Fraction numerator (gcd with 2^(k*n)
        # cancelled), not the raw lifted integer
        frac = Fraction(mult * per_core, 1 << (k * a.shape[0]))
        num = str(frac.numerator)
        want = row["numerator"]
        match = (num == want if not want.endswith("...")
                 else num.startswith(want[:-3]))
        algo2 = None
        if core and float(1 << (len(core) - 1)) <= algo2_iters:
            am = np.asarray([[int(v) % pg for v in row_] for row_ in core],
                            dtype=np.uint64)
            algo2 = bool(perman_glynn_mod(am, pg) == per_core % pg)
        print(f"{name}: {'MATCH' if match else 'MISMATCH'}"
              f"{'' if algo2 is None else ' algo2=' + ('OK' if algo2 else 'FAIL')}"
              f" ({time.time() - t0:.1f} s)", flush=True)
        ok += match and algo2 is not False
        bad += (not match) or algo2 is False
        report.append({"file": name, "crt_match": bool(match),
                       "glynn_ok": algo2,
                       "wall_s": round(time.time() - t0, 1)})
    print(f"reverify: {ok} match, {bad} MISMATCH, {skipped} skipped",
          flush=True)
    if args.report:
        # merge-by-file so a flagship re-run with a raised --algo2-iters
        # (chesapeake: 2^38 Glynn iters) folds into the same artifact
        _merge_report(args.report, report,
                      extra={"glynn_prime": pg,
                             "algo2_iters": algo2_iters,
                             "n_skipped": skipped})
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
