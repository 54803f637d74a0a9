"""Range sharding over the virtual 8-device CPU mesh.

The exactness invariant (SURVEY.md §4): a range-sharded exact permanent
must equal the unsharded result bitwise — partial sums are reduced on host
in f64, so grouping cannot change the value.
"""

import numpy as np
import pytest

import superman_tpu as sp
from superman_tpu.parallel.mesh import make_mesh
from tests.conftest import random_int_matrix


def test_mesh_has_8_devices():
    import jax
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_equals_single(rng, n_dev):
    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    single = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256)
    sharded = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                           mesh_shape=(n_dev,))
    assert sharded.permanent == single.permanent   # bitwise
    assert sharded.meta["mesh"] == n_dev


def test_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(4)


def test_entry_compiles():
    import __graft_entry__ as g
    import jax
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))


def test_sentinel_lanes_contribute_zero_when_npad_equals_n(rng):
    """Sentinel (-1) padded lanes are NOT self-zeroing (no all-zero pad
    row: the walk re-adds columns to every row), so compute_partials
    must mask unweighted per-lane partials and keep the device reduce
    off.  Regression: a sentinel-padded id list at n=16 summed 8% wrong,
    silently — in exactly the shapes the hybrid scheduler's fixed-size
    unit padding and no-factor sparse plans emit."""
    from superman_tpu.ops import gray
    from superman_tpu.parallel.sharding import pad_ids, compute_partials

    n = 16
    a = rng.random((n, n))
    plan = gray.RyserPlan(n=n, n_pad=n, r=4, lanes=64, num_chunks=1 << 11)
    x0_pair, cols_pair = gray.pack_matrix(a, plan.n_pad)
    ids = np.arange(1 << 11, dtype=np.int64).astype(np.int32)
    clean = pad_ids(ids, 64, 1, block_multiple=1)       # exact, 32 blocks
    dirty = pad_ids(ids, 63, 1, block_multiple=32)      # 1984 sentinels
    assert (dirty < 0).any()
    ref = None
    for blocks, reduce_ok in ((clean, True), (dirty, False), (dirty, True)):
        out = compute_partials(blocks, x0_pair, cols_pair, plan,
                               df=True, exact_storage=False,
                               interpret=True, reduce_ok=reduce_ok)
        tot = float(out.sum(dtype=np.float64))
        if ref is None:
            ref = tot
        else:       # cross-grouping: 1e-12-class, never the 8%-off garbage
            assert abs(tot - ref) <= 1e-9 * abs(ref)


def test_pad_ids_per_shard_quantization():
    """block_multiple rounds PER-SHARD block counts, not the global
    count: at 64 shards with ~31 raw blocks a global lcm(64, 32)
    quantization walks 2x the lanes."""
    from superman_tpu.parallel.sharding import pad_ids
    ids = np.arange(31 * 512, dtype=np.int32)
    # single device: >= 32 blocks rounds to the 32-multiple (reduce path)
    assert pad_ids(np.arange(33 * 512, dtype=np.int32), 512, 1,
                   block_multiple=32).shape[0] == 64
    # under 32 blocks nothing to round (reduce gated off)
    assert pad_ids(ids, 512, 1, block_multiple=32).shape[0] == 31
    # 64 shards, 1 block each: no further rounding beyond divisibility
    assert pad_ids(ids, 512, 64, block_multiple=32).shape[0] == 64
    # 8 shards: 4 blocks/shard < 32 -> just divisibility
    assert pad_ids(ids, 512, 8, block_multiple=32).shape[0] == 32
    # per-shard rounding still engages once a shard holds >= 32 blocks
    big = np.arange(8 * 33 * 512, dtype=np.int32)
    assert pad_ids(big, 512, 8, block_multiple=32).shape[0] == 8 * 64


def test_sparse_lanes_shrink_for_high_shard_counts():
    from superman_tpu.parallel.sharding import sparse_lanes
    # n=36 d=0.10 plan scale: 15797 live chunks
    assert sparse_lanes(15797, 1, 512) == 512
    assert sparse_lanes(15797, 8, 512) == 512
    assert sparse_lanes(15797, 64, 512) == 256     # 96% useful
    assert sparse_lanes(500, 64, 512) == 128       # floor
    # useful fraction target: shards * L <= live * 4/3 (above the floor)
    for live, s in ((15797, 64), (4000, 8), (100000, 64)):
        L = sparse_lanes(live, s, 512)
        assert L == 128 or s * L * 3 <= live * 4


def test_sparse_mesh_lane_shrink_end_to_end(rng):
    """The engine's sharded pruned walk with the shrunken lane width
    still reproduces the single-device value (cross-grouping 2e-12
    convention)."""
    import superman_tpu as sp
    a = (rng.random((24, 24)) < 0.25) * rng.integers(1, 5, (24, 24))
    np.fill_diagonal(a, 1)
    ss = sp.permanent(a, sparse=True, chunk_log2=6, lanes=512)
    sm = sp.permanent(a, sparse=True, chunk_log2=6, lanes=512,
                      mesh_shape=(8,))
    assert abs(sm.permanent - ss.permanent) <= 2e-12 * abs(ss.permanent)
