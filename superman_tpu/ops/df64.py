"""Double-float (df64) arithmetic: ~49-bit-mantissa reals as (hi, lo) f32 pairs.

The reference's `double` calc type (revised_perman/flags.h default;
algo.h accumulates products in double over a float x-vector) is
reproduced with compensated f32-pair arithmetic, which runs at the f32
rate inside the walk kernel.  All building blocks are branch-free and
run alike inside Pallas kernels and in plain jnp code.

Fused multiply-add contraction.  XLA (CPU and GPU) and Triton may fuse
a product into a following add.  An error-free transform breaks when
its rounded product p = fl(a*b) feeds a sum that the compiler fuses
into fma(a, b, x): the sum then sees the unrounded product while the
error term assumes p.  So every rounded product an error-free chain
consumes comes from a TwoProd `tp` that no compiler can fuse: the
default computes it in float64 (exact for f32 operands, and a
conversion is never contracted); the walk kernel passes an inline-PTX
version (ops/ryser_pallas.py).  Products that are exact (by a sign, or
of split halves) or that only feed low-order terms stay plain.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

#: keeps the sign, exponent and top 23 of the 52 stored mantissa bits
#: of a float64: the value truncated to f32 precision
_F32_MANTISSA = -(1 << 29)


def two_sum(a, b):
    """Knuth TwoSum: a + b = s + e exactly (6 flops)."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum, requires |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """TwoProd a * b = p + e exactly, through float64.

    The f64 product w of two f32 values is exact (48 bits).  p is w
    truncated to f32 precision by a bit mask and e = w - p, both exact
    in f32 (|e| < ulp(p)): no rounded product exists for a compiler to
    fuse into a neighbouring add, and no f32 round trip exists for it to
    fold away as excess precision."""
    w = a.astype(jnp.float64) * b.astype(jnp.float64)
    bits = lax.bitcast_convert_type(w, jnp.int64) & jnp.int64(_F32_MANTISSA)
    p = lax.bitcast_convert_type(bits, jnp.float64)
    return p.astype(jnp.float32), (w - p).astype(jnp.float32)


def df_add(ahi, alo, bhi, blo):
    """df64 + df64 (Bailey's sloppy add; ~11 flops, error O(eps^2))."""
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return quick_two_sum(s, e)


def df_add_f32(ahi, alo, b):
    s, e = two_sum(ahi, b)
    e = e + alo
    return quick_two_sum(s, e)


def df_mul(ahi, alo, bhi, blo, tp=two_prod):
    """df64 * df64."""
    p, e = tp(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


def df_mul_f32(ahi, alo, b, tp=two_prod):
    """df64 * f32."""
    p, e = tp(ahi, b)
    e = e + alo * b
    return quick_two_sum(p, e)


def df_neg(hi, lo):
    return -hi, -lo


# ---------------------------------------------------------------- host side

def split_f64(x: np.ndarray):
    """Split float64 array into an exact (hi, lo) f32 pair (host)."""
    hi = np.asarray(x, dtype=np.float64).astype(np.float32)
    lo = (np.asarray(x, dtype=np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    """Recombine (hi, lo) f32 arrays into float64 on host."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


# ------------------------------------------------------------ tree products
#
# A tree's factors come either as a list of equal-shape arrays (the walk
# kernel's per-row lane vectors on the card, where values cannot be
# sliced) or stacked in one array along axis 0 (the interpreter and
# plain jnp callers, where one op per level beats one op per row).  Each
# level pairs neighbours; an odd one out rides up a level, lifted to the
# wider type.  Items are tuples of words: (x,), (hi, lo), (t0, t1, t2).


def _count(items):
    return len(items) if isinstance(items, list) else items[0].shape[0]


def _level(items, mul, lift):
    if isinstance(items, list):
        nxt = [mul(*items[i], *items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        return nxt + [lift(*w) for w in items[len(nxt) * 2:]]
    s = items[0].shape[0]
    h = s // 2
    nxt = mul(*(w[0:2 * h:2] for w in items), *(w[1:2 * h:2] for w in items))
    if s % 2:
        rest = lift(*(w[2 * h:] for w in items))
        nxt = tuple(jnp.concatenate([a, b]) for a, b in zip(nxt, rest))
    return nxt


def _tree(xs, stages):
    """Product of the factors xs (list or stacked, see above) through
    typed stages [(mul, lift), ...]: one level per stage, and the last
    stage repeated until one item remains.  Returns its words."""
    items = [(x,) for x in xs] if isinstance(xs, list) else (xs,)
    for mul, lift in stages[:-1]:
        if _count(items) > 1:
            items = _level(items, mul, lift)
        else:
            items = ([lift(*items[0])] if isinstance(items, list)
                     else lift(*items))
    mul = stages[-1][0]
    while _count(items) > 1:
        items = _level(items, mul, lambda *w: w)
    return items[0] if isinstance(items, list) else tuple(
        w[0] for w in items)


def _lift_df(x):
    return x, jnp.zeros_like(x)


def tree_prod_f32(xs):
    """Product of f32 factors, log-depth tree."""
    return _tree(xs, [(lambda a, b: (a * b,), None)])[0]


def tree_prod_df64(xs, tp=two_prod):
    """Product of EXACT f32 factors -> df64 (hi, lo).  The first level is
    an exact TwoProd; higher levels are df64 multiplies (relative error
    ~ depth * 2^-48)."""
    return _tree(xs, [(tp, _lift_df),
                      (lambda *a: df_mul(*a, tp=tp), None)])


def tree_prod_full_df(xhis, xlos, tp=two_prod):
    """Product of df64 PAIR factors -> df64 (hi, lo)."""
    if isinstance(xhis, list):
        items = list(zip(xhis, xlos))
    else:
        items = (xhis, xlos)
    mul = lambda *a: df_mul(*a, tp=tp)  # noqa: E731
    while _count(items) > 1:
        items = _level(items, mul, lambda *w: w)
    return items[0] if isinstance(items, list) else tuple(
        w[0] for w in items)
