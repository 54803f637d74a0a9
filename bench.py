"""Headline benchmark: n=32 dense exact permanent on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.

Baseline anchor: the reference publishes no GPU numbers (BASELINE.md); the
BASELINE.json north star is "exact n=32 dense permanent faster than a
2-GPU CUDA baseline", reported as Gray-code iters/s.  The v1 kernel does
2^31 iterations of ~2n flops with a 2048x256-thread grid; on two
V100-class GPUs a well-tuned double-calc run is ~0.5 s => ~4.3e9 iters/s
TOTAL.  vs_baseline > 1 means ONE device beats that two-GPU estimate at
reference-parity accuracy (df64 compensated arithmetic ~ the reference's
double-over-float calc; checked against our independent native C++ double
engine).  The f32 rate (calc-half-precision parity, flags.h -h) is
reported in detail.
"""

import json
import time

import numpy as np

BASELINE_ITERS_PER_SEC = 4.3e9   # est. 2-GPU CUDA (see module docstring)
# independent oracle: native/perman_cpu.cpp sup_perman_dense (OpenMP,
# long-double accumulation) on int/32_0.50_0, measured on this machine
NATIVE_DOUBLE_VALUE = 1.6379790881209674e+41


def best_of(fn, k=5):
    best = None
    for _ in range(k):
        r = fn()
        if best is None or r.time < best.time:
            best = r
    return best


def main():
    import superman_tpu as sp
    from superman_tpu.io.triplet import read_triplet

    dm = read_triplet("/root/reference/int/32_0.50_0")
    sp.permanent(dm, calc="df64")          # warm-up / compile
    best = best_of(lambda: sp.permanent(dm, calc="df64"))
    iters_per_sec = best.iterations / best.time
    rel_err = abs(best.permanent - NATIVE_DOUBLE_VALUE) / NATIVE_DOUBLE_VALUE

    sp.permanent(dm, calc="f32")
    f32 = best_of(lambda: sp.permanent(dm, calc="f32"))
    sp.permanent(dm, calc="f32k")
    f32k = best_of(lambda: sp.permanent(dm, calc="f32k"))
    sp.permanent(dm, calc="tf96")
    tf96 = best_of(lambda: sp.permanent(dm, calc="tf96"), k=3)

    # sparse floor: the only measured reference numbers are CPU SkipPer
    # 0.563-1.30 s on n=32 d=0.20 (BASELINE.md); dense engine wall on
    # the same matrix anchors the sparse-vs-dense speedup
    sdm = read_triplet("/root/reference/int/32_0.20_0")
    SPARSE_VALID = 3.0796642024820435e+27   # native double, SUITE_REPORT
    sp.permanent(sdm, calc="df64", skip_pruning=False)
    sdense = best_of(lambda: sp.permanent(
        sdm, calc="df64", skip_pruning=False))
    sp.permanent(sdm, sparse=True, calc="df64")
    sparse = best_of(lambda: sp.permanent(sdm, sparse=True, calc="df64"))

    print(json.dumps({
        "metric": "n32_dense_exact_gray_iters_per_sec_per_chip",
        "value": round(iters_per_sec / 1e9, 4),
        "unit": "G iters/s",
        "vs_baseline": round(iters_per_sec / BASELINE_ITERS_PER_SEC, 4),
        "detail": {
            "calc": "df64 (reference double-calc parity)",
            "policy": "warm best-of-5 (tf96 best-of-3) after a compile rep",
            "wall_s": round(best.time, 4),
            "permanent": best.permanent,
            "rel_err_vs_native_double": float(f"{rel_err:.3e}"),
            "matrix": "int/32_0.50_0",
            "f32_g_iters_per_sec": round(f32.iterations / f32.time / 1e9,
                                         4),
            "f32_wall_s": round(f32.time, 4),
            "f32k_g_iters_per_sec": round(
                f32k.iterations / f32k.time / 1e9, 4),
            "f32k_rel_err": float(
                f"{abs(f32k.permanent - NATIVE_DOUBLE_VALUE) / NATIVE_DOUBLE_VALUE:.2e}"),
            "tf96_g_iters_per_sec": round(
                tf96.iterations / tf96.time / 1e9, 4),
            "tf96_rel_err": float(
                f"{abs(tf96.permanent - NATIVE_DOUBLE_VALUE) / NATIVE_DOUBLE_VALUE:.2e}"),
            "sparse_n32_d020_wall_s": round(sparse.time, 4),
            "sparse_n32_d020_dense_wall_s": round(sdense.time, 4),
            "sparse_vs_dense_speedup": round(sdense.time / sparse.time, 3),
            "sparse_rel_err": float(
                f"{abs(sparse.permanent - SPARSE_VALID) / SPARSE_VALID:.2e}"),
            "sparse_plan": sparse.meta.get("sparse"),
            "sparse_ref_cpu_skipper_s": [0.563, 1.30],
        },
    }))


if __name__ == "__main__":
    main()
