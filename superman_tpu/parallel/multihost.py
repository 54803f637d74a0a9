"""Multi-host work partitioning: deterministic interleaved chunk ownership.

The engine's replacement for the reference's (single-node-only) work
distribution, per SURVEY.md §2.5: there is no cross-host shared counter,
so the OpenMP-critical chunk scheduler becomes a DETERMINISTIC interleaved
assignment — host p owns block rows p, p+P, p+2P, ... of the (B, L) chunk
id array.  Interleaving (not contiguous split) balances the irregular
density of live chunks left by pruning.  Each host runs the normal
single-host engine (optionally its own local mesh + hybrid CPU pool) on
its slice; the only cross-host traffic is ONE float64 partial total per
host, allgathered over DCN and summed in a deterministic order — so the
multi-host result is bitwise identical to the single-host result for
every case where block-sum reassociation is exact (all int suites), and
within df64 tolerance otherwise.

Usage on each host:
    jax.distributed.initialize()   # or JAX_COORDINATOR_ADDRESS env
    sp.permanent(path)             # engine detects process_count() > 1
"""

from __future__ import annotations

import numpy as np


def host_slice(ids_blocks: np.ndarray, process_index: int,
               process_count: int) -> np.ndarray:
    """Block rows owned by this host (round-robin interleave)."""
    return ids_blocks[process_index::process_count]


def combine_host_totals(local_total):
    """Allgather each host's partial total and sum deterministically
    (ascending process index).  Single-process: identity.

    The total travels as an (hi, lo) float64 pair — hi = f64(x),
    lo = f64(x - hi) — so a long-double tf96 per-host sum keeps its extra
    mantissa bits across the wire (a plain f64 coercion would round each
    host's ~72-bit partial to 53 bits BEFORE the cross-host cancellation).
    The combine happens in long double on every host, in process order, so
    all hosts agree bitwise.  Returns np.longdouble when given one."""
    import jax
    was_ld = isinstance(local_total, np.longdouble)
    if jax.process_count() == 1:
        return local_total if was_ld else float(local_total)
    ld = np.longdouble(local_total)
    hi = np.float64(ld)
    lo = np.float64(ld - np.longdouble(hi))
    from jax.experimental import multihost_utils
    totals = multihost_utils.process_allgather(
        np.asarray([hi, lo], dtype=np.float64))
    pairs = np.asarray(totals, dtype=np.float64).reshape(-1, 2)
    acc = np.longdouble(0.0)
    for h, l in pairs:
        acc += np.longdouble(h) + np.longdouble(l)
    return acc if was_ld else float(acc)
