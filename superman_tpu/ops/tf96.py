"""Triple-float (tf96) arithmetic: ~72-bit-mantissa reals as f32 triples.

A precision tier above df64 (ops/df64.py) for the cancellation-dominated
cases where df64's ~2^-48 per-term product error caps end accuracy at
~1e-8..1e-9 (dense d=0.9 suites, all-ones matrices).  The reference's
only answer there is quad on the CPU (hours at n>=32); tf96 keeps the
walk on the accelerator at a few times the df64 cost.

Representation: (x0, x1, x2) f32 words, ulp-nonoverlapping after
renormalization, value = x0 + x1 + x2.  Algorithms follow the standard
floating-point-expansion constructions (VecSum renormalization, sloppy
addition, exact-pair products) built on the error-free transforms in
ops/df64.py; everything is branch-free and runs identically in jnp host
code and inside Pallas kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from .df64 import _lift_df, _tree, quick_two_sum, two_prod, two_sum


def renorm3(a0, a1, a2):
    """VecSum renormalization of a 3-term expansion (inputs may overlap;
    requires only |a0| >= |a1|,|a2| roughly, which all call sites satisfy
    structurally)."""
    s1, t2 = two_sum(a1, a2)
    r0, t1 = two_sum(a0, s1)
    # full TwoSum here: t1 (<= ulp(r0)) and t2 (<= ulp(s1)) are not
    # guaranteed ordered, so QuickTwoSum's precondition can fail
    r1, r2 = two_sum(t1, t2)
    return r0, r1, r2


def renorm3_prod(r0, r1, r2):
    """Cheap renormalization for the PRODUCT path's structurally-ordered
    words (9 flops vs renorm3's 18; round-3 verdict item 7 — the tf96
    tree spends ~18% of its flops renormalizing already-nearly-
    normalized triples).

    Preconditions (hold at both call sites, tf_mul / tf_mul_dd):
    (r0, r1) came from TwoSum(p0, s) + TwoSum(c, low) chains, so
    |r1| <= ~2^-21|r0| (FastTwoSum safe) and (r1, r2) need only the
    boundary between e = err(r0 + r1) and r2 resolved exactly — e and
    r2 are not magnitude-ordered (e can be 0), so that one stays a full
    TwoSum."""
    s0, e = quick_two_sum(r0, r1)
    s1, s2 = two_sum(e, r2)
    return s0, s1, s2


def tf_add(a0, a1, a2, b0, b1, b2):
    """Triple + triple (sloppy accumulation, error O(2^-72) relative)."""
    r0, e0 = two_sum(a0, b0)
    s1, e1 = two_sum(a1, b1)
    r1, e2 = two_sum(e0, s1)
    r2 = a2 + b2 + e1 + e2
    return renorm3(r0, r1, r2)


def tf_neg(a0, a1, a2):
    return -a0, -a1, -a2


def tf_from_dd(hi, lo):
    z = jnp.zeros_like(hi)
    return hi, lo, z


def tf_mul_dd(ahi, alo, bhi, blo, tp=two_prod):
    """(exact df64) x (exact df64) -> tf96, error ~2^-70 relative.

    Order-1 words (e0, p1, p2 ~ 2^-24 of the product) flow through exact
    TwoSums only; order-2 words (~2^-48) may be folded linearly — their
    rounding lands at ~2^-72."""
    p0, e0 = tp(ahi, bhi)                # dominant
    p1, e1 = tp(ahi, blo)
    p2, e2 = tp(alo, bhi)
    t, et = two_sum(p1, p2)
    s, es = two_sum(t, e0)               # exact order-1 sum
    # |s| <= ~2^-21.6 |p0| structurally -> FastTwoSum is safe
    r0, c = quick_two_sum(p0, s)
    low = et + es + e1 + e2 + alo * blo  # order-2 terms
    r1, r2 = two_sum(c, low)
    return renorm3_prod(r0, r1, r2)


def tf_mul(a0, a1, a2, b0, b1, b2, tp=two_prod):
    """Triple x triple -> triple, error ~2^-70 relative."""
    p0, e0 = tp(a0, b0)                  # exact dominant
    p1, e1 = tp(a0, b1)
    p2, e2 = tp(a1, b0)
    t, et = two_sum(p1, p2)
    s, es = two_sum(t, e0)               # exact order-1 sum
    r0, c = quick_two_sum(p0, s)         # |s| <= ~2^-21.6 |p0|
    low = (et + es + e1 + e2             # order-2 and order-3 terms
           + a0 * b2 + a2 * b0 + a1 * b1)
    r1, r2 = two_sum(c, low)
    return renorm3_prod(r0, r1, r2)


def tree_prod_tf96(xs, tp=two_prod):
    """Product of EXACT f32 factors (a list, or stacked on axis 0; see
    ops/df64.py) -> tf96 triple.

    Level 1 pairs are exact df64 (TwoProd); level 2 products of exact
    df64 pairs are tf96 with ~2^-72 error (tf_mul_dd); higher levels are
    tf96 multiplies.  An odd factor rides up a level, zero-extended."""
    return _tree(xs, [
        (tp, _lift_df),
        (lambda *a: tf_mul_dd(*a, tp=tp), lambda h, l: (h, l,
                                                         jnp.zeros_like(h))),
        (lambda *a: tf_mul(*a, tp=tp), None)])
