"""Pure-XLA (no Pallas) lane-vectorized Ryser walk.

Used for: float64 calc (IEEE double on the device), small matrices
where kernel launch overhead dominates, and as an independent
cross-check of the walk kernel (the reference's test strategy is
cross-algorithm agreement, SURVEY.md §4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import gray


@functools.partial(jax.jit, static_argnames=("n", "r", "dtype"))
def _walk(X, sign_mid, cols, *, n: int, r: int, dtype):
    """X: (C, n) initialized lane x-vectors; cols: (n-1, n) matrix columns.
    Returns per-lane signed partial sums (C,)."""
    acc = jnp.prod(X, axis=1)                  # m = 0 terms, sign +1

    def body(m, carry):
        X, acc = carry
        m = m.astype(jnp.int32)
        t = (m & -m).astype(jnp.float32)
        k = (lax.bitcast_convert_type(t, jnp.int32) >> 23) - 127
        s_scalar = (1 - 2 * ((m >> (k + 1)) & 1)).astype(dtype)
        s = jnp.where(k == r - 1, sign_mid, s_scalar)      # (C,)
        zero = jnp.zeros((), dtype=jnp.int32)
        ck = lax.dynamic_slice(cols, (k, zero), (1, cols.shape[1]))  # (1, n)
        X = X + s[:, None] * ck
        sign_m = (1 - 2 * (m & 1)).astype(dtype)
        acc = acc + sign_m * jnp.prod(X, axis=1)
        return X, acc

    _, acc = lax.fori_loop(1, 1 << r, body, (X, acc))
    return acc


def ryser_xla(a: np.ndarray, dtype=jnp.float64, max_lanes: int = 1 << 13):
    """Exact permanent via the XLA walk; float64 end to end by default
    (the reference's default double path), on the default device."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 2:
        from .oracle import perman_brute
        return float(perman_brute(a))
    total = 1 << (n - 1)
    C = min(total >> 1, max_lanes)
    r = (total // C).bit_length() - 1
    ids = np.arange(C, dtype=np.int64)
    from .oracle import gray_init_lanes
    X, sign_mid = gray_init_lanes(a, ids, r, dtype=np.float64)

    args = (jnp.asarray(X, dtype=dtype), jnp.asarray(sign_mid, dtype=dtype),
            jnp.asarray(a[:, : n - 1].T, dtype=dtype))
    acc = _walk(*args, n=n, r=r, dtype=dtype)
    total_sum = float(np.sum(np.asarray(acc, dtype=np.float64)))
    return (4 * (n & 1) - 2) * total_sum
