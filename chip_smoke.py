"""End-to-end check of the permanent engine on one NVIDIA GPU.

    python chip_smoke.py           # every phase, one card
    python chip_smoke.py --four    # only the four-card mesh phase

Each phase drives a user entry point (sp.permanent, sp.permanent_batch,
the exact CRT engine) on seeded matrices at real sizes, compares the
answer with an independent reference, and prints one line: value,
reference, relative error, tolerance, the backend the engine reported
(meta["backend"]) and the wall time.  The last line is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed on
a GPU; otherwise the script exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        _fail(f"nvidia-smi: {e}")
    return out


class Phases:
    def __init__(self):
        self.failed = []

    def check(self, name, value, ref, tol, backend, wall, rel=None):
        if rel is None:
            rel = (abs(value - ref) / abs(ref) if ref else abs(value - ref))
        ok = bool(np.isfinite(rel) and rel <= tol and backend == "gpu")
        print(f"phase {name}: value={value!r} ref={ref!r} rel_err={rel:.3e} "
              f"tol={tol:.1e} backend={backend} wall_s={wall:.3f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def run(self, name, fn):
        """fn() -> (value, ref, tol, backend[, rel]); timed here."""
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:          # noqa: BLE001 — reported, fails run
            print(f"phase {name}: FAIL {type(e).__name__}: {e}",
                  flush=True)
            self.failed.append(name)
            return
        self.check(name, *out[:4], time.perf_counter() - t0, *out[4:])


def _dense01(rng, n, d):
    a = (rng.random((n, n)) < d).astype(np.int64)
    np.fill_diagonal(a, 1)
    return a


def single_card(ph: Phases) -> None:
    import superman_tpu as sp
    from superman_tpu import backend
    from superman_tpu.bindings.native import native_available
    from superman_tpu.ops import ryser_xla
    from superman_tpu.ops.exact import perman_exact_fraction

    rng = np.random.default_rng(SEED)
    gpu = backend.backend()

    # n=32 d=0.5 0/1: every walk tier against the f64 XLA walk
    def f64_walk(a):
        # the plain XLA float64 walk, wide enough to fill the card
        return ryser_xla.ryser_xla(a, max_lanes=1 << 17)

    a32 = _dense01(rng, 32, 0.5)
    ref32 = f64_walk(a32)
    for calc, tol in (("f32", 5e-2), ("f32k", 1e-3), ("df64", 1e-8),
                      ("tf96", 1e-8)):
        def tier(calc=calc, tol=tol):
            r = sp.permanent(a32, calc=calc, skip_pruning=False)
            assert r.algo_name == f"ryser_pallas_{calc}", r.algo_name
            return r.permanent, ref32, tol, r.meta["backend"]
        ph.run(f"dense_n32_{calc}", tier)

    # tf96 on J24 (24! exactly: within half an f64 ulp) and on a +-1
    # matrix against the exact CRT integer
    def tf96_ones():
        r = sp.permanent(np.ones((24, 24), np.int64), calc="tf96")
        return r.permanent, float(math.factorial(24)), 1.2e-16, \
            r.meta["backend"]
    ph.run("tf96_J24", tf96_ones)

    def tf96_pm1():
        b = rng.choice([-1, 1], (24, 24)).astype(np.int64)
        r = sp.permanent(b, calc="tf96")
        exact, _ = perman_exact_fraction(
            b, engine="native" if native_available() else "device")
        return r.permanent, float(exact), 1e-12, r.meta["backend"]
    ph.run("tf96_pm1_n24_vs_crt", tf96_pm1)

    # exact-product contract of the tf96 tree, as XLA compiles it
    def tf96_tree():
        from fractions import Fraction
        import jax.numpy as jnp
        from superman_tpu.ops.tf96 import tree_prod_tf96
        worst = 0.0
        for s in (8, 21, 32, 40):
            m = rng.integers(2**23, 2**24, size=(s, 64)).astype(np.float64)
            x = (m * rng.choice([-1.0, 1.0], (s, 64))
                 * 2.0**-23).astype(np.float32)
            words = [np.asarray(w, np.float64) for w in
                     tree_prod_tf96(list(jnp.asarray(x)))]
            for lane in range(64):
                exact = Fraction(1)
                for i in range(s):
                    exact *= Fraction(float(x[i, lane]))
                got = sum(Fraction(float(w[lane])) for w in words)
                worst = max(worst, abs(float((got - exact) / exact)))
        return worst, 0.0, 2.0**-66, gpu, worst
    ph.run("tf96_tree_exact_product_fuzz", tf96_tree)

    # sparse n=32 d=0.20 against the dense walk
    def sparse32():
        b = (rng.random((32, 32)) < 0.20) * rng.integers(1, 4, (32, 32))
        np.fill_diagonal(b, 1)
        dense = sp.permanent(b, calc="df64", skip_pruning=False)
        r = sp.permanent(b, calc="df64", sparse=True)
        assert "sparse" in r.meta, "the pruned plan did not engage"
        return r.permanent, dense.permanent, 1e-8, r.meta["backend"]
    ph.run("sparse_n32_d020", sparse32)

    # serving batch: 64 matrices of order 20 against per-matrix f64
    def batch():
        mats = [(rng.random((20, 20)) < 0.5) * rng.integers(1, 4, (20, 20))
                for _ in range(64)]
        res = sp.permanent_batch(mats)
        refs = [ryser_xla.ryser_xla(m) for m in mats]
        rels = [abs(r.permanent - f) / max(abs(f), 1e-300)
                for r, f in zip(res, refs)]
        i = int(np.argmax(rels))
        assert res[0].algo_name == "ryser_pallas_batch_df64"
        return res[i].permanent, refs[i], 1e-8, res[i].meta["backend"], \
            max(rels)
    ph.run("batch_64x_n20", batch)

    # Glynn against Ryser at n=24
    def glynn():
        b = (rng.random((24, 24)) < 0.5) * rng.integers(1, 4, (24, 24))
        np.fill_diagonal(b, 1)
        ry = sp.permanent(b, calc="df64", skip_pruning=False)
        gl = sp.permanent(b, calc="df64", perman_algo="glynn")
        assert gl.algo_name == "glynn_pallas_df64", gl.algo_name
        return gl.permanent, ry.permanent, 1e-8, gl.meta["backend"]
    ph.run("glynn_n24_vs_ryser", glynn)

    # calc="auto" at n=24, and its amplitude walk against a host sum
    a24 = (rng.random((24, 24)) < 0.5) * rng.integers(1, 4, (24, 24))
    np.fill_diagonal(a24, 1)

    def auto():
        r = sp.permanent(a24, calc="auto")
        return r.permanent, ryser_xla.ryser_xla(a24), 1e-8, \
            r.meta["backend"]
    ph.run("auto_n24", auto)

    def amp_walk():
        from superman_tpu.ops.ryser import amp_walk_log2
        got = amp_walk_log2(a24.astype(np.float64))
        want = _host_amp_log2(a24.astype(np.float64))
        return 2.0 ** (got - want), 1.0, 1e-4, gpu
    ph.run("amp_walk_n24", amp_walk)

    # scaling estimator on the 16x16 grid against Kasteleyn
    def grid():
        from superman_tpu.prep.gridgraph import kasteleyn_log2
        r = sp.grid_permanent(16, 16, approximation=True,
                              perman_algo="scaling", smc=1,
                              number_of_times=4096, seed=SEED + 1)
        l2 = float(r.meta["log2_estimate"])
        want = float(kasteleyn_log2(16, 16))
        sig = float(r.meta["stderr_rel"]) / math.log(2.0)
        z = abs(l2 - want) / sig if sig > 0 else math.inf
        return l2, want, 3.0, r.meta["backend"], z
    ph.run("scaling_grid16_vs_kasteleyn_z", grid)

    # the Z_p walk on the device against the native CRT
    def crt_device():
        from superman_tpu.ops import modp
        from superman_tpu.ops.exact import _perman_bigint_dfs
        core = [[int(v) for v in row] for row in
                (rng.random((14, 14)) < 0.5) * rng.integers(1, 9, (14, 14))]
        for i in range(14):
            core[i][i] = core[i][i] or 1
        got, meta = modp.crt_perman_core(core, backend="device")
        want = (modp.crt_perman_core(core, backend="native")[0]
                if native_available() else _perman_bigint_dfs(core))
        return float(got), float(want), 0.0, gpu, \
            0.0 if got == want else 1.0
    ph.run("crt_device_core14", crt_device)

    # the hybrid scheduler: every unit on the device, none retried
    def hybrid():
        b = _dense01(rng, 28, 0.5)
        r = sp.permanent(b, calc="df64", hybrid=True, cpu=False,
                         skip_pruning=False)
        h = r.meta["hybrid"]
        assert h["device"] > 0 and h["retries"] == 0, h
        ref = sp.permanent(b, calc="df64", skip_pruning=False)
        return r.permanent, ref.permanent, 1e-10, r.meta["backend"]
    ph.run("hybrid_n28", hybrid)

    # one long walk: n=36 dense df64 (2^35 steps)
    def n36():
        b = _dense01(rng, 36, 0.5)
        r = sp.permanent(b, calc="df64", skip_pruning=False)
        return r.permanent, f64_walk(b), 1e-8, r.meta["backend"]
    ph.run("dense_n36_df64", n36)


def _host_amp_log2(a: np.ndarray) -> float:
    """log2 sum_m |prod_i x_i(m)| over the whole Ryser walk, in numpy."""
    n = a.shape[0]
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    cols = a[:, : n - 1]
    total, step = 0.0, 1 << 18
    for start in range(0, 1 << (n - 1), step):
        m = np.arange(start, start + step, dtype=np.uint64)
        g = m ^ (m >> np.uint64(1))
        bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
                & np.uint64(1)).astype(np.float64)
        total += float(np.abs(np.prod(x0[None, :] + bits @ cols.T,
                                      axis=1)).sum())
    return math.log2(total)


def four_cards(ph: Phases) -> None:
    import superman_tpu as sp
    from superman_tpu.ops import gray
    from superman_tpu.parallel.mesh import make_mesh
    from superman_tpu.parallel.sharding import compute_partials, pad_ids
    from superman_tpu.ops.ryser import _row_scales

    rng = np.random.default_rng(SEED + 4)

    def dense36():
        a = _dense01(rng, 36, 0.5).astype(np.float64)
        a_s = np.ldexp(a, -_row_scales(a)[:, None])
        plan = gray.make_plan(36, num_shards=4)
        x0p, colsp = gray.pack_matrix(a_s, 36)
        ids = pad_ids(np.arange(plan.num_chunks, dtype=np.int32),
                      plan.lanes, 4)
        kw = dict(df=True, exact_storage=True)
        mesh = compute_partials(ids, x0p, colsp, plan, mesh=make_mesh(4),
                                **kw)
        single = compute_partials(ids, x0p, colsp, plan, **kw)
        diff = float(np.max(np.abs(mesh - single)))
        r = sp.permanent(a, calc="df64", skip_pruning=False,
                         mesh_shape=(4,))
        assert r.meta["mesh"] == 4
        return float(mesh.sum()), float(single.sum()), 0.0, \
            r.meta["backend"], diff
    ph.run("mesh4_dense_n36_df64_bitwise", dense36)

    def sparse36():
        b = (rng.random((36, 36)) < 0.10) * rng.integers(1, 4, (36, 36))
        np.fill_diagonal(b, 1)
        single = sp.permanent(b, calc="df64", sparse=True)
        mesh = sp.permanent(b, calc="df64", sparse=True, mesh_shape=(4,))
        assert mesh.meta["mesh"] == 4 and "sparse" in mesh.meta
        return mesh.permanent, single.permanent, 2e-12, \
            mesh.meta["backend"]
    ph.run("mesh4_sparse_n36_d010", sparse36)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        _fail(f"no GPU: JAX platform is {devs[0].platform!r}")
    need = 4 if args.four else 1
    if len(devs) < need:
        _fail(f"{need} GPUs needed, {len(devs)} found")
    import superman_tpu  # noqa: F401 — fails here outside the repository

    print(_card_line(), flush=True)
    print(f"jax devices: {devs}", flush=True)
    ph = Phases()
    t0 = time.perf_counter()
    (four_cards if args.four else single_card)(ph)
    print(f"phases: {'FAILED ' + ','.join(ph.failed) if ph.failed else 'all ok'}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    if ph.failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
