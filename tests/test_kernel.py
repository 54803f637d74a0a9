"""The Gray-walk kernel (ops/ryser_pallas.py) on the CPU.

The kernel body runs here in the Pallas interpreter against the plain
references in ops/oracle.py; the Triton lowering of every tier is
checked without a GPU (lowering for CUDA is pure Python); the wrapper's
grid, lane padding and block folding are checked on their own.  The
compiled kernel itself runs in chip_smoke.py on the card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superman_tpu.ops import df64, gray, ryser_pallas as rp
from superman_tpu.ops.oracle import perman64
from superman_tpu.ops.ryser import _row_scales

TIERS = {
    "f32": rp.Tier(),
    "f32k": rp.Tier(kahan=True),
    "df64": rp.Tier(df=True),
    "df64_pair": rp.Tier(df=True, exact_storage=False),
    "tf96": rp.Tier(tf=True),
    "amp": rp.Tier(kahan=True, amp=True, exact_storage=False),
}

# relative tolerance of each tier's walk against the f64/long-double
# oracle at n=12 (value ~1e5, amplitude a few x that)
TOL = {"f32": 1e-4, "f32k": 1e-6, "df64": 1e-12, "df64_pair": 1e-12,
       "tf96": 1e-15}


def _walk_inputs(a, r, lanes, blocks, tier):
    n = a.shape[0]
    x0p, colsp = gray.pack_matrix(a, n)
    ids = np.arange(blocks * lanes, dtype=np.int32).reshape(blocks, lanes)
    xhi, xlo, smid = gray.chunk_init(jnp.asarray(ids), jnp.asarray(x0p),
                                     jnp.asarray(colsp), n=n, n_pad=n, r=r,
                                     df=tier.full_df)
    return xhi, xlo, smid, jnp.asarray(colsp)


def _seeded(n, seed):
    rng = np.random.default_rng(seed)
    a = ((rng.random((n, n)) < 0.6) * rng.integers(1, 4, (n, n))).astype(
        np.float64)
    np.fill_diagonal(a, 1.0)
    return np.ldexp(a, -_row_scales(a)[:, None])


def _host_amp(a):
    n = a.shape[0]
    x0 = gray.x0_f64(a)
    m = np.arange(1 << (n - 1), dtype=np.int64)
    g = m ^ (m >> 1)
    bits = ((g[:, None] >> np.arange(n - 1)) & 1).astype(np.float64)
    return float(np.abs(np.prod(x0 + bits @ a[:, : n - 1].T, axis=1)).sum())


@pytest.mark.parametrize("name", ["f32", "f32k", "df64", "tf96", "amp"])
def test_kernel_tier_matches_oracle(name):
    """Every tier's interpret-mode walk of the whole index space (4
    blocks x 32 lanes x 2^4 steps at n=12) against the oracle."""
    tier = TIERS[name]
    n, r = 12, 4
    a = _seeded(n, 12)
    out = rp.walk_lanes(*_walk_inputs(a, r, 32, 4, tier), r=r, u=1,
                        tier=tier, interpret=True)
    out = np.asarray(out, np.longdouble)
    assert out.shape == (4, rp.WORDS, 32)
    if name == "amp":
        got = float((out[:, 0] + out[:, 1]).sum())
        assert got == pytest.approx(_host_amp(a), rel=1e-5)
        assert np.all(out[:, 2] > 0)              # conditioned amplitude
        return
    total = out[:, :tier.words].sum()
    want = perman64(a, dtype=np.longdouble) / (4 * (n & 1) - 2)
    assert float(abs(total - want) / abs(want)) <= TOL[name]
    assert np.all(out[:, tier.words:] == 0)       # unused words stay 0


@pytest.mark.parametrize("name,us", [("f32", (1, 2, 3)), ("df64", (1, 2)),
                                     ("tf96", (1, 2))])
def test_unroll_is_bitwise_invariant(name, us):
    """Every static unroll u runs the same floating-point operations, so
    per-lane partials are bitwise equal (the card runs u=1..4, the
    interpreter u=1; XLA:CPU compiles of big unrolled bodies take
    minutes, so the larger u are checked on f32 only)."""
    tier = TIERS[name]
    a = _seeded(9, 3)
    args = _walk_inputs(a, 5, 16, 2, tier)
    outs = [np.asarray(rp.walk_lanes(*args, r=5, u=u, tier=tier,
                                     interpret=True)) for u in us]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


def test_interpret_fold_matches_per_block():
    """Interpret mode folds the blocks of a shared column table into one
    program; the lanes must come back in their blocks, bitwise."""
    tier = TIERS["df64_pair"]
    a = _seeded(10, 5)
    xhi, xlo, smid, cols = _walk_inputs(a, 3, 8, 4, tier)
    folded = np.asarray(rp.walk_lanes(xhi, xlo, smid, cols, r=3, u=1,
                                      tier=tier, interpret=True))
    for b in range(4):
        one = rp.walk_lanes(xhi[b:b + 1], xlo[b:b + 1], smid[b:b + 1], cols,
                            r=3, u=1, tier=tier, interpret=True)
        assert np.array_equal(folded[b], np.asarray(one)[0])


def test_per_matrix_tables_match_shared():
    """The serving-batch form (a column table per block) gives the same
    lanes as the shared table when every block carries the same table."""
    tier = TIERS["df64"]
    a = _seeded(10, 6)
    xhi, xlo, smid, cols = _walk_inputs(a, 3, 8, 3, tier)
    shared = rp.walk_lanes(xhi, xlo, smid, cols, r=3, u=1, tier=tier,
                           interpret=True)
    per = rp.walk_lanes(xhi, xlo, smid, jnp.broadcast_to(cols, (3,)
                                                         + cols.shape),
                        r=3, u=1, tier=tier, interpret=True)
    assert np.array_equal(np.asarray(shared), np.asarray(per))


def _lower_cuda(tier, B, L, n=32, r=14, per_matrix=False):
    x = jax.ShapeDtypeStruct((B, n, L), jnp.float32)
    sm = jax.ShapeDtypeStruct((B, 1, L), jnp.float32)
    cshape = ((B,) if per_matrix else ()) + (2, n - 1, n)
    cols = jax.ShapeDtypeStruct(cshape, jnp.float32)
    u = rp.unroll_for(tier, r, interpret=False)

    def f(a, b, c, d):
        return rp.walk_lanes(a, b, c, d, r=r, u=u, tier=tier,
                             interpret=False)
    return jax.jit(f).trace(x, x, sm, cols).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("name", list(TIERS))
def test_kernel_lowers_to_triton(name):
    """Each tier lowers through Pallas' Triton route for CUDA (this is
    where an unsupported primitive or a non-power-of-two block fails)."""
    txt = _lower_cuda(TIERS[name], B=2, L=256, per_matrix=name == "df64")
    assert "xla.gpu.triton" in txt
    assert "gray_walk" in txt


def test_wrapper_grid_and_lane_padding():
    """The card's grid is (blocks, lanes / 128); a lane count that is not
    a multiple of the program width is padded up and sliced back."""
    txt = _lower_cuda(TIERS["f32"], B=3, L=384)
    grid = tuple(int(re.search(rf"grid_{ax} = (\d+)", txt).group(1))
                 for ax in "xyz")
    assert sorted(grid) == [1, 3, 3]
    txt = _lower_cuda(TIERS["f32"], B=2, L=200)       # pads to 256
    grid = tuple(int(re.search(rf"grid_{ax} = (\d+)", txt).group(1))
                 for ax in "xyz")
    assert sorted(grid) == [1, 2, 2]
    assert "tensor<2x4x200xf32>" in txt               # sliced result


def test_two_prod_is_exact():
    """TwoProd p + e == a * b exactly for f32 operands spread over many
    binades (the error-free transform every df64/tf96 product uses)."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
         ).astype(np.float32)
    p, e = df64.two_prod(jnp.asarray(a), jnp.asarray(b))
    p, e = np.asarray(p, np.float64), np.asarray(e, np.float64)
    assert np.array_equal(p + e, a.astype(np.float64) * b.astype(np.float64))
    assert np.all(np.abs(e) <= np.spacing(np.abs(p).astype(np.float32)))
