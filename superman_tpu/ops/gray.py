"""Gray-code range decomposition and x-vector initialization.

The Ryser index space i in [0, 2^(n-1)) is cut into aligned chunks of
2**r indices.  Because chunks are aligned, at inner step m every lane flips
the SAME column k = ctz(m) — the walk vectorizes across lanes with no
gathers (contrast: the reference reconstructs per-thread gray state inside
each CUDA thread, gpu_exact_dense.cu:90-98; here alignment removes the
divergence entirely).  The only lane-divergent quantity is the sign of the
single mid step m = 2**(r-1), which equals the chunk-index parity.

Chunk ids fit in int32 because the planner caps the chunk count.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import df64


@dataclasses.dataclass(frozen=True)
class RyserPlan:
    n: int           # matrix order
    n_pad: int       # rows walked by the kernel (n, or the sparse path's
    #                  non-factored row subset)
    r: int           # log2 chunk length
    lanes: int       # chunks per id block (L)
    num_chunks: int  # total chunks = 2^(n-1-r)

    @property
    def total_iters(self) -> int:
        return 1 << (self.n - 1)


#: log2 of the chunks (kernel lanes) a dense walk spreads over one
#: device: 2^17 lanes keep all 132 SMs of an H100 busy with whole
#: programs of 128 lanes
LG_DEVICE_CHUNKS = 17

#: shortest chunk (log2 steps) the planner picks on its own, so the
#: per-lane init and partial-sum transfer stay small against the walk
MIN_CHUNK_LOG2 = 8


def make_plan(n: int, lanes: int = 1024, chunk_log2=None, *,
              num_shards: int = 1, min_blocks: int = 1,
              grid_multip: int = 1, sparse: bool = False) -> RyserPlan:
    """Chunk-decomposition planner (dense walks).

    The default spreads 2^LG_DEVICE_CHUNKS chunks over each device (the
    grid then covers every SM), with chunks of at least
    2^MIN_CHUNK_LOG2 steps, and at least max(min_blocks, num_shards)
    blocks of `lanes` chunks.  min_blocks over-decomposes for the
    dynamic hybrid scheduler; grid_multip (the reference's grid-dim
    multiplier, -e) cuts grid_multip x more, shorter chunks.  sparse keeps the short-chunk default
    (r = n-18) for direct live_chunks callers; the engine's sparse plans
    come from ops/pruning.plan_sparse, which picks r with a cost model.
    """
    total = n - 1
    if chunk_log2 is None:
        if sparse:
            r = max(5, total - 17)
        else:
            lg_lanes = max(1, int(math.log2(lanes)))
            lg_blocks = int(math.ceil(math.log2(
                max(min_blocks, num_shards))))
            lg_shards = int(math.ceil(math.log2(max(1, num_shards))))
            lg_multip = int(math.ceil(math.log2(max(1, grid_multip))))
            r = min(total - lg_lanes - lg_blocks,
                    max(MIN_CHUNK_LOG2,
                        total - LG_DEVICE_CHUNKS - lg_shards) - lg_multip)
    else:
        r = chunk_log2
    r = max(2, min(r, n - 2)) if n > 3 else 1
    num_chunks = 1 << max(0, total - r)
    lanes = min(lanes, num_chunks)
    return RyserPlan(n=n, n_pad=n, r=r, lanes=lanes, num_chunks=num_chunks)


def chunk_gray_bits(chunk_ids, n: int, r):
    """Gray-code bits of base = chunk_id * 2^r as a (..., n-1) 0/1 int32
    array: bit b = gray(chunk)>>(b-r) for b >= r, chunk&1 for b == r-1,
    else 0.  r may be a traced int32 scalar."""
    l = chunk_ids.astype(jnp.int32)
    r = jnp.asarray(r, jnp.int32)
    gray_l = l ^ (l >> 1)
    b = jnp.arange(n - 1, dtype=jnp.int32)
    hi = (gray_l[..., None] >> jnp.maximum(b - r, 0)[None, :]) & 1
    hi = jnp.where(b[None, :] >= r, hi, 0)
    mid = jnp.where(b[None, :] == r - 1, l[..., None] & 1, 0)
    return hi | mid


def x0_f64(a: np.ndarray) -> np.ndarray:
    """Nijenhuis–Wilf initial x vector (host, float64):
    x0[j] = a[j, n-1] - rowsum(j)/2  (reference algo.h:1044-1049)."""
    a = np.asarray(a, dtype=np.float64)
    return a[:, -1] - a.sum(axis=1) / 2


@functools.partial(jax.jit, static_argnames=("n", "n_pad", "df"))
def chunk_init(chunk_ids, x0_pair, cols_pair, n: int, n_pad: int, r,
               df: bool):
    """Device-side lane init.

    chunk_ids: (B, L) int32 (may contain sentinel -1 -> zero x, dead lane).
    x0_pair:   (2, n_pad) f32 hi/lo of x0 (lo exact split of the f64 value).
    cols_pair: (2, n-1, n_pad) f32 hi/lo of the matrix columns (col k padded).
    r:         log2 chunk length.
    Returns (Xhi, Xlo, sign_mid): X* (B, n_pad, L), sign_mid (B, 1, L).

    The accumulation is a compensated (df64) chain over the n-1 columns, so
    the result equals the float64 init bit-for-bit for every input whose
    columns are exactly representable in the (hi, lo) pairs.
    """
    dead = (chunk_ids < 0)
    ids = jnp.where(dead, 0, chunk_ids)
    bits = chunk_gray_bits(ids, n, r)            # (B, L, n-1)
    bits_f = bits.astype(jnp.float32)
    xhi = jnp.broadcast_to(x0_pair[0][None, :, None],
                           ids.shape[:1] + (n_pad, ids.shape[1]))
    xlo = jnp.broadcast_to(x0_pair[1][None, :, None], xhi.shape)
    for k in range(n - 1):
        bk = bits_f[:, :, k][:, None, :]         # (B, 1, L)
        chi = cols_pair[0, k][None, :, None] * bk
        clo = cols_pair[1, k][None, :, None] * bk
        if df:
            xhi, xlo = df64.df_add(xhi, xlo, chi, clo)
        else:
            xhi = xhi + chi
    sign_mid = (1 - 2 * (ids & 1)).astype(jnp.float32)[:, None, :]
    # dead lanes: x = 0 zeroes the m=0 term, but the walk re-adds column
    # values to every row, so later products are not 0: the caller
    # masks them (factor weights are 0 for sentinel ids, and
    # compute_partials zeroes unweighted per-lane partials,
    # parallel/sharding.py, has_dead).
    alive = jnp.where(dead, 0.0, 1.0).astype(jnp.float32)[:, None, :]
    return xhi * alive, xlo * alive, sign_mid


@functools.partial(jax.jit, static_argnames=("n", "n_pad", "df"))
def chunk_init_batch(chunk_ids, x0_pair, cols_pair, n: int, n_pad: int, r,
                     df: bool):
    """Per-MATRIX lane init for the serving batch: like chunk_init, but
    x0_pair is (B, 2, n_pad) and cols_pair (B, 2, n-1, n_pad) — each of
    the B matrices gets its own pack.  chunk_ids is (B, L)."""
    dead = (chunk_ids < 0)
    ids = jnp.where(dead, 0, chunk_ids)
    bits_f = chunk_gray_bits(ids, n, r).astype(jnp.float32)  # (B, L, n-1)
    xhi = jnp.broadcast_to(x0_pair[:, 0][:, :, None],
                           ids.shape[:1] + (n_pad, ids.shape[1]))
    xlo = jnp.broadcast_to(x0_pair[:, 1][:, :, None], xhi.shape)
    for k in range(n - 1):
        bk = bits_f[:, :, k][:, None, :]                     # (B, 1, L)
        chi = cols_pair[:, 0, k][:, :, None] * bk
        clo = cols_pair[:, 1, k][:, :, None] * bk
        if df:
            xhi, xlo = df64.df_add(xhi, xlo, chi, clo)
        else:
            xhi = xhi + chi
    sign_mid = (1 - 2 * (ids & 1)).astype(jnp.float32)[:, None, :]
    alive = jnp.where(dead, 0.0, 1.0).astype(jnp.float32)[:, None, :]
    return xhi * alive, xlo * alive, sign_mid


@functools.partial(jax.jit, static_argnames=("n", "nf_pad"))
def factor_weights(chunk_ids, fx0_pair, fcols_pair, n: int, nf_pad: int,
                   r):
    """Per-chunk products of the factored-out constant rows, on device.

    Mirrors chunk_init (same df64-compensated base-x accumulation) for
    the factor-row subset, then folds the row axis with df64 multiplies.
    Computing the weights from the chunk ids on device avoids shipping
    a (B, L) f64 weight array to the device.  Returns (w_hi, w_lo) f32
    pairs, 0 for sentinel ids (< 0).
    """
    dead = (chunk_ids < 0)
    ids = jnp.where(dead, 0, chunk_ids)
    bits_f = chunk_gray_bits(ids, n, r).astype(jnp.float32)  # (B, L, n-1)
    shape = ids.shape[:1] + (nf_pad, ids.shape[1])
    xhi = jnp.broadcast_to(fx0_pair[0][None, :, None], shape)
    xlo = jnp.broadcast_to(fx0_pair[1][None, :, None], shape)
    for k in range(n - 1):
        bk = bits_f[:, :, k][:, None, :]
        chi = fcols_pair[0, k][None, :, None] * bk
        clo = fcols_pair[1, k][None, :, None] * bk
        xhi, xlo = df64.df_add(xhi, xlo, chi, clo)
    # the barrier keeps XLA from fusing the n-1 compensated adds into
    # every use in the product tree (each add's result feeds several
    # ops of the next, so fused copies multiply and the compile explodes)
    xhi, xlo = jax.lax.optimization_barrier((xhi, xlo))
    whi, wlo = df64.tree_prod_full_df(jnp.moveaxis(xhi, 1, 0),
                                      jnp.moveaxis(xlo, 1, 0))
    alive = jnp.where(dead, 0.0, 1.0).astype(jnp.float32)
    return whi * alive, wlo * alive


def pack_matrix(a: np.ndarray, n_pad: int):
    """Host-side packing: (x0_pair, cols_pair), the walk's initial x and
    its column table cols[k, i] = a[i, k], as exact f32 (hi, lo) pairs.
    Rows past `rows` (when n_pad > rows) are multiplicative identities
    (x0 = 1, column 0).

    a may be rectangular (rows, n): a row subset of an order-n matrix —
    the sparse path walks only non-constant rows (factored rows'
    products are applied as per-chunk weights, ops/pruning.py)."""
    a = np.asarray(a, dtype=np.float64)
    rows, n = a.shape
    x0 = np.ones(n_pad, dtype=np.float64)
    x0[:rows] = x0_f64(a)
    cols = np.zeros((n - 1, n_pad), dtype=np.float64)
    cols[:, :rows] = a[:, : n - 1].T
    x0_pair = np.stack(df64.split_f64(x0))
    cols_pair = np.stack(df64.split_f64(cols))
    return x0_pair, cols_pair
