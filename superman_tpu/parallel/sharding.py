"""Gray-code range sharding over the device mesh.

The engine's equivalent of the reference's L3 work distribution
(SURVEY.md §2.4): chunks are distributed over a 1-D mesh with `shard_map`;
per-device partial sums come back sharded and the final (exactness-critical)
reduction happens on host in float64.  Because every chunk costs exactly
2**r Gray steps — dead ranges are pruned *before* distribution rather than
skipped *during* the walk (contrast the reference's SkipPer divergence,
algo.h:885-1023) — a static equal split is load-balanced by construction,
replacing the reference's OpenMP-critical-section chunk counter
(gpu_exact_dense.cu:862-888) with something that also works across hosts.

The sharded executable is cached per mesh, chunk length and shapes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import gray
from ..ops import ryser_pallas as rp
from .mesh import RANGE_AXIS


def pad_ids(ids: np.ndarray, lanes: int, num_shards: int,
            block_multiple: int = 1):
    """Pad a 1-D chunk-id list with -1 sentinels (dead lanes) so it reshapes
    to (B, lanes) with B divisible by num_shards.

    block_multiple > 1 additionally rounds the PER-SHARD block count up
    to that multiple once a shard holds that many, so the on-device
    32-block reduction engages on every group (sentinel lanes
    contribute 0).  The rounding is per-shard, not global: at high
    shard counts each shard holds far fewer than 32 blocks, the reduce
    path is gated off anyway (compute_partials), and a global
    lcm(num_shards, 32) quantization padded the n=36 d=0.10 plan to 48%
    useful lanes at 64 shards."""
    per_block = lanes
    blocks = -(-len(ids) // per_block)
    blocks = -(-blocks // num_shards) * num_shards
    if block_multiple > 1:
        per_shard = blocks // num_shards
        if per_shard >= block_multiple:
            per_shard = -(-per_shard // block_multiple) * block_multiple
            blocks = per_shard * num_shards
    padded = np.full(blocks * per_block, -1, dtype=np.int32)
    padded[: len(ids)] = ids
    return padded.reshape(blocks, per_block)


def sparse_lanes(live: int, num_shards: int, lanes_cap: int) -> int:
    """Lane width for a sharded pruned walk.

    Every shard must hold >= 1 whole (L-lane) block, so at high shard
    counts a fixed L=512 forces num_shards * 512 lane-walks regardless
    of how few live chunks exist (useful fraction 0.48 at 64 shards on
    the n=36 d=0.10 plan).  Shrink
    L (powers of two, floor 128) until the mandatory num_shards * L
    floor keeps useful lanes >= ~75%.  Single-device callers keep the
    tuned cap (the block layout, not the floor, governs their padding).
    """
    L = int(lanes_cap)
    if num_shards <= 1:
        return L
    while L > 128 and num_shards * L * 3 > live * 4:
        L //= 2
    return L


@functools.lru_cache(maxsize=None)
def _sharded_fn(mesh: Mesh, n: int, n_pad: int, r: int, tier: rp.Tier,
                interpret: bool, weighted: bool = False, nf_pad: int = 1,
                reduce: bool = False):
    """jitted shard_map executable, cached per (mesh, statics).
    weighted/reduce mirror the single-device factored-sparse path: each
    shard derives its chunk weights on device from its own id slice."""

    def local(ids_blk, x0p, colsp, fx0, fcols):
        xhi, xlo, smid = gray.chunk_init(ids_blk, x0p, colsp, n=n,
                                         n_pad=n_pad, r=r,
                                         df=tier.full_df)
        w_pair = None
        if weighted:
            whi, wlo = gray.factor_weights(ids_blk, fx0, fcols, n=n,
                                           nf_pad=nf_pad, r=r)
            w_pair = jnp.stack([whi, wlo], axis=1)
        return rp.partials(xhi, xlo, smid, colsp, w_pair, r=r, tier=tier,
                           interpret=interpret, weighted=weighted,
                           reduce=reduce)

    f = shard_map(
        local, mesh=mesh,
        in_specs=(P(RANGE_AXIS), P(), P(), P(), P()),
        out_specs=P(RANGE_AXIS),
        check_vma=False)
    return jax.jit(f)


def compute_partials(ids_blocks: np.ndarray, x0_pair, cols_pair,
                     plan: gray.RyserPlan, *,
                     df: bool, exact_storage: bool,
                     mesh: Optional[Mesh] = None, kahan: bool = False,
                     tf: bool = False, interpret: bool = False,
                     factors=None, reduce_ok: bool = False,
                     amp: bool = False) -> np.ndarray:
    """Run init + kernel over (B, L) chunk ids, optionally sharded.

    factors: optional (fx0_pair, fcols_pair, nf_pad, host_fn) describing
    the sparse path's factored-out constant rows.  On the reduced paths
    the per-chunk weights are computed ON DEVICE from the chunk ids
    (gray.factor_weights) and applied before reduction; elsewhere
    host_fn(ids_blocks) supplies them (f64, or longdouble for tf96) and
    they multiply the returned per-lane partials on host.

    Returns host float64 partial sums whose .sum() is the (weighted)
    total: per-lane (B, L), or per-group (B // 32, L) when the
    on-device reduction ran (pruned sparse plans with B a multiple of
    32 per shard), which shrinks the device-to-host copy 32-fold.
    """
    n, n_pad, r = plan.n, plan.n_pad, plan.r
    tier = rp.Tier(df=df, exact_storage=exact_storage, kahan=kahan, tf=tf,
                   amp=amp)
    if amp:          # diagnostic walk: single-device, unweighted only
        assert mesh is None and not df and not tf and factors is None
    B = ids_blocks.shape[0]
    # Sentinel (-1) lanes are NOT self-zeroing: chunk_init zeroes their
    # x, but the walk re-adds column values to every row, so their
    # products come back nonzero (measured 8% error at n=16).  Factor
    # weights (device or host) zero dead lanes; on every unweighted path
    # the per-lane partials are masked below — which requires per-lane
    # output, so the device reduce is gated off there.
    has_dead = bool((ids_blocks < 0).any())
    num_shards = 1 if mesh is None else int(np.prod(mesh.devices.shape))
    b_shard = B // num_shards
    # reduce_ok comes from the pruned-sparse caller only: its pad_ids
    # block_multiple=32 guarantees shard boundaries align with the
    # 32-block reduction groups, so mesh and single runs regroup sums
    # IDENTICALLY — the dense paths keep per-lane partials and their
    # exact bitwise mesh-vs-single contract.
    reduce = bool(reduce_ok and b_shard % rp.REDUCE_GROUP == 0
                  and b_shard >= rp.REDUCE_GROUP)
    host_weights = None

    ids_j = jnp.asarray(ids_blocks)
    x0_j, cols_j = jnp.asarray(x0_pair), jnp.asarray(cols_pair)
    if num_shards == 1:
        w_pair = None
        if factors is not None:
            if reduce:
                fx0, fcols, nf_pad, _ = factors
                whi, wlo = gray.factor_weights(
                    ids_j, jnp.asarray(fx0), jnp.asarray(fcols),
                    n=n, nf_pad=nf_pad, r=r)
                w_pair = jnp.stack([whi, wlo], axis=1)    # (B, 2, L)
            else:
                host_weights = factors[3](ids_blocks)
        elif reduce and has_dead:
            # no factor weights, but sentinel lanes must be zeroed BEFORE
            # the on-device 32-block reduce: a synthetic (alive, 0)
            # weight pair masks them and keeps the reduced transfer
            alive = (ids_j >= 0).astype(jnp.float32)
            w_pair = jnp.stack([alive, jnp.zeros_like(alive)], axis=1)
        xhi, xlo, smid = gray.chunk_init(ids_j, x0_j, cols_j, n=n,
                                         n_pad=n_pad, r=r,
                                         df=tier.full_df)
        out = rp.partials(xhi, xlo, smid, cols_j, w_pair, r=r, tier=tier,
                          interpret=interpret, weighted=w_pair is not None,
                          reduce=reduce)
    else:
        reduce = reduce and (factors is not None or not has_dead)
        # device weighting rides the reduction path; without it
        # (small shards) the factors fall back to host_fn
        weighted = factors is not None and reduce
        if weighted:
            fx0, fcols, nf_pad, _ = factors
        else:
            # dummy replicated operands keep one arg signature
            fx0 = np.zeros((2, 1), np.float32)
            fcols = np.zeros((2, n - 1, 1), np.float32)
            nf_pad = 1
        fn = _sharded_fn(mesh, n, n_pad, r, tier, interpret,
                         weighted=weighted, nf_pad=int(nf_pad),
                         reduce=reduce)
        out = fn(ids_j, x0_j, cols_j, jnp.asarray(fx0), jnp.asarray(fcols))
        if factors is not None and not weighted:
            host_weights = factors[3](ids_blocks)
    if amp:
        # amp walk: words 0/1 = amplitude (hi, kahan-lo), words 2/3 = the
        # within-line conditioned amplitude — returned as (2, B, L)
        out = np.asarray(out, dtype=np.float64)
        p = np.stack([out[:, 0] + out[:, 1], out[:, 2] + out[:, 3]])
        if has_dead:
            p = p * (ids_blocks >= 0).astype(p.dtype)[None]
        return p
    out = out[:, :tier.words, :]            # device slice: small D2H
    if tf:
        # triple words summed in long double: the per-lane partial holds
        # ~72 mantissa bits, beyond f64
        out = np.asarray(out, dtype=np.longdouble)
        p = out[:, 0, :] + out[:, 1, :] + out[:, 2, :]
    else:
        out = np.asarray(out, dtype=np.float64)
        p = out[:, 0, :] + out[:, 1, :]     # hi + lo, exact in f64
    if host_weights is not None:
        p = p * np.asarray(host_weights).astype(p.dtype)
    elif has_dead and not reduce:
        # unweighted per-lane partials: zero the sentinel lanes (see the
        # has_dead comment above; weighted paths already carry 0 weights)
        p = p * (ids_blocks >= 0).astype(p.dtype)
    return p
