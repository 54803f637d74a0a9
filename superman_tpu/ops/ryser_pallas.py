"""Gray-walk kernel for the exact Ryser permanent (Pallas, Triton route).

The Ryser index space is cut into aligned chunks of 2**r subset indices
(ops/gray.py); every lane of the kernel walks one chunk.  Because chunks
are aligned, at inner step m every lane flips the SAME column
k = ctz(m), so one program walks a block of lanes in lock step:

    x_i (+)= s * col_k[i]     # one update per matrix row
    prod  = tree(x_0..x_n-1)  # log-depth product over the rows
    acc  (+)= (-1)^m * prod

Layout on the card: a program owns ``bl`` lanes (one per thread) and
keeps each row's x (and, for the df64/tf96 tiers, its lower words) in
registers as a per-row lane vector; the product tree is a Python-level
tree over those rows, and the 2**r loop runs inside the program.  The
grid is (id blocks, lane blocks), so the walk fills every SM, and every
program writes its lanes' partial sums: the regrouping of those sums
(host f64 sums, or the 32-block halving tree of the sparse path) is
the same for one device and for a mesh, which keeps the two bitwise
equal.

Unrolling: within an aligned block of U = 2**u steps (m = U*b + j) the
flipped column and both signs are compile-time constants for every j
except j = U/2 (sign = parity of b) and j = U (column u + ctz(b+1),
the one dynamic column, loaded directly by index).  The u static
columns are loaded once per program.  Interpret mode uses u = 1 (the
smallest body to trace on the CPU); every u executes the same
floating-point operations, so results do not depend on it.  Chunks
need r >= u + 1 >= 2.

Calc tiers:
  f32  — plain f32 products and accumulation;
  f32k — f32 products, Kahan-compensated accumulation;
  df64 — compensated f32-pair products and accumulator (~2^-48);
  tf96 — triple-f32 products and accumulator (~2^-70), exact-f32 x only;
  amp  — sum of |term| and of the within-line conditioned term (the
         calc="auto" error model), x carried as a df64 pair.
``exact_storage`` marks matrices whose values and half-integer x are
exact in f32 (integer suites): x updates then stay plain f32.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from . import df64
from . import tf96 as tfm

_I32 = jnp.int32
_F32 = jnp.float32

#: output words per lane: the tier's accumulator words, zero-padded
#: (f32/f32k/df64: hi, lo; tf96: three words; amp: amp hi/lo, cond hi/lo)
WORDS = 4

#: lanes per program on the card, and the warps that carry them (one
#: lane per thread)
BLOCK_LANES = 128
NUM_WARPS = 4

#: amp-walk within-line clamp: |x| below 2^-45 (at the unit row scale)
#: reads as 2^-45, so per-line condition saturates at 2^45.  The amp
#: walk carries x as a df64 pair (resolution ~2^-48 * row amplitude)
#: exactly so crossings are resolved this far; conditions beyond 2^45
#: put every float tier's bound at >= 2^-3 relative.
_AMP_EPS = 2.0 ** -45


@dataclasses.dataclass(frozen=True)
class Tier:
    df: bool = False
    exact_storage: bool = True
    kahan: bool = False
    tf: bool = False
    amp: bool = False

    @property
    def full_df(self) -> bool:
        """x carried as a (hi, lo) pair."""
        return (self.df or self.amp) and not self.exact_storage

    @property
    def words(self) -> int:
        return 4 if self.amp else (3 if self.tf else 2)


#: static unroll (log2 of the block of steps with static columns) per
#: tier on the card, capped at r-1 per call.  Chosen on an H100 at n=32
#: (CHANGES.md): f32 gains to u=4; df64 gains to u=3 (u=4: +1%, 2.7x the
#: compile); the pair-x and tf96 bodies are as fast or faster at u=1
#: and compile in half the time.
_UNROLL = {"f32": 4, "df64": 3, "full_df": 1, "tf96": 1, "amp": 1}


def unroll_for(tier: Tier, r: int, interpret: bool) -> int:
    if interpret:
        return 1
    if tier.amp:
        u = _UNROLL["amp"]
    elif tier.tf:
        u = _UNROLL["tf96"]
    elif tier.full_df:
        u = _UNROLL["full_df"]
    elif tier.df:
        u = _UNROLL["df64"]
    else:
        u = _UNROLL["f32"]
    return max(1, min(u, r - 1))


def _ptx(asm, *args):
    sd = [jax.ShapeDtypeStruct(args[0].shape, _F32)]
    cons = ",".join(["=f"] + ["f"] * len(args))
    return pltr.elementwise_inline_asm(asm, args=list(args), constraints=cons,
                                       pack=1, result_shape_dtypes=sd)[0]


def _two_prod_ptx(a, b):
    """TwoProd on the card: mul.rn / fma.rn are PTX instructions no
    compiler fuses with their neighbours (see ops/df64.py)."""
    p = _ptx("mul.rn.f32 $0, $1, $2;", a, b)
    return p, _ptx("fma.rn.f32 $0, $1, $2, $3;", a, b, -p)


def _rounded_ptx(v):
    """v, opaque to the compiler: a product passed through it is rounded
    before any following add (no fma contraction)."""
    return _ptx("mov.b32 $0, $1;", v)


def _ctz(m):
    """Trailing zeros of a positive int32 scalar."""
    return lax.population_count((m & -m) - _I32(1))


def _sign(bit):
    """+1 where the int32 `bit` is 0, -1 where it is 1 (f32)."""
    return _F32(1) - _F32(2) * bit.astype(_F32)


@functools.lru_cache(maxsize=None)
def _static_table(u: int):
    """(j, k, x-sign) for the 2**u - 1 static steps of a block: column
    k = ctz(j); x-sign +1 iff bit k+1 of j is 0, and 0 marks the
    half-block step whose sign is the block parity.  The term sign is
    (-1)^j."""
    steps = []
    for j in range(1, 1 << u):
        k = (j & -j).bit_length() - 1
        if k == u - 1:
            steps.append((j, k, 0))
        else:
            steps.append((j, k, +1 if ((j >> (k + 1)) & 1) == 0 else -1))
    return tuple(steps)


def _amp_terms(xs):
    """(|prod x|, conditioned term) for one step of the amp walk.

    The conditioned term sum_i prod_{j!=i} |x_j| (clamped) weighs the
    walk's WITHIN-LINE rounding error: an x_i that passes near zero
    mid-walk divides its carried absolute error by |x_i|, which the
    plain amplitude sum_m |prod| cannot see.  Computed as
    prod(max(|x|, eps)) * sum(1/max(|x|, eps)) so a line AT zero still
    contributes its prod_{j!=i} term."""
    if isinstance(xs, list):
        ax = [jnp.abs(x) for x in xs]
        axc = [jnp.maximum(a, _F32(_AMP_EPS)) for a in ax]
        sinv = _F32(1) / axc[0]
        for a in axc[1:]:
            sinv = sinv + _F32(1) / a
    else:
        ax = jnp.abs(xs)
        axc = jnp.maximum(ax, _F32(_AMP_EPS))
        sinv = jnp.sum(_F32(1) / axc, axis=0)
    return df64.tree_prod_f32(ax), df64.tree_prod_f32(axc) * sinv


def _walk(xs, xls, smid, col, *, r: int, u: int, tier: Tier, ptx: bool):
    """Walk one lane block through its 2**r-step chunks.

    xs/xls: the rows' x (hi words, and lo words when tier.full_df):
    on the card a list of per-row lane vectors, in the interpreter one
    stacked (rows, lanes) array; smid: the lanes' mid-step signs;
    col(k) -> column k's (hi, lo) in the same form (a list of scalar
    pairs, or two row vectors); ptx: compiled for the card (inline-PTX
    TwoProd), else the interpreter's float64 TwoProd.  Returns WORDS
    lane vectors.
    """
    tp = _two_prod_ptx if ptx else df64.two_prod
    rounded = _rounded_ptx if ptx else (lambda v: v)
    assert 1 <= u < r, (u, r)
    full_df = tier.full_df
    stacked = not isinstance(xs, list)

    def prod_term(xs, xls):
        if tier.tf:
            return tfm.tree_prod_tf96(xs, tp=tp)
        if tier.amp:
            return tuple(rounded(v) for v in _amp_terms(xs))
        if not tier.df:
            p = df64.tree_prod_f32(xs)
            return (rounded(p) if tier.kahan else p), None
        if tier.exact_storage:
            return df64.tree_prod_df64(xs, tp=tp)
        return df64.tree_prod_full_df(xs, xls, tp=tp)

    def acc_add(acc, term, pos: bool):
        if tier.tf:
            t = term if pos else tfm.tf_neg(*term)
            return tfm.tf_add(*acc, *t)
        if tier.amp:
            ahi, e = df64.two_sum(acc[0], term[0])
            chi, e2 = df64.two_sum(acc[2], term[1])
            return (ahi, acc[1] + e, chi, acc[3] + e2)
        phi, plo = term
        if not pos:
            phi = -phi
            plo = None if plo is None else -plo
        if tier.df:
            return df64.df_add(acc[0], acc[1], phi, plo)
        if tier.kahan:
            hi, e = df64.two_sum(acc[0], phi)
            return hi, acc[1] + e
        return acc[0] + phi, acc[1]

    def update_row(x, xl, ch, cl, s):
        """x += s * c for one row (or the stacked rows): s is a static
        +-1, or a traced scalar or lane vector."""
        if isinstance(s, int):
            ch = ch if s > 0 else -ch
            cl = None if cl is None else (cl if s > 0 else -cl)
        else:
            ch = ch * s
            cl = None if cl is None else cl * s
        if full_df:
            return df64.df_add(x, xl, ch, cl)
        return x + ch, xl

    def update(xs, xls, cs, s):
        if stacked:
            ch, cl = cs
            return update_row(xs, xls, ch[:, None],
                              None if cl is None else cl[:, None], s)
        rows = [update_row(x, None if xls is None else xls[i], *cs[i], s)
                for i, x in enumerate(xs)]
        return ([h for h, _ in rows],
                [l for _, l in rows] if full_df else xls)

    static_cols = [col(k) for k in range(u)]

    def static_steps(xs, xls, acc, b_sign):
        for j, k, sgn in _static_table(u):
            xs, xls = update(xs, xls, static_cols[k],
                             b_sign if sgn == 0 else sgn)
            acc = acc_add(acc, prod_term(xs, xls), (j & 1) == 0)
        return xs, xls, acc

    # m = 0 term: the chunk base index is even -> sign +1
    term = prod_term(xs, xls)
    if tier.tf:
        acc = term
    elif tier.amp:
        zero = jnp.zeros_like(term[0])
        acc = (term[0], zero, term[1], zero)
    else:
        acc = (term[0],
               term[1] if tier.df else jnp.zeros_like(term[0]))

    nb = 1 << (r - u)                       # 2**u-step blocks per chunk

    def block(b, carry):
        xs, xls, acc = carry
        xs, xls, acc = static_steps(xs, xls, acc, _sign(b & _I32(1)))
        q = b + _I32(1)
        c = _ctz(q)
        k = c + _I32(u)
        s = _sign((q >> (c + _I32(1))) & _I32(1))
        s_row = jnp.where(k == _I32(r - 1), smid, s)
        xs, xls = update(xs, xls, col(k), s_row)
        acc = acc_add(acc, prod_term(xs, xls), True)
        return xs, xls, acc

    xs, xls, acc = lax.fori_loop(_I32(0), _I32(nb - 1), block,
                                 (xs, xls, acc))
    # last block: static steps only (m = 2**r belongs to the next chunk);
    # its half-block sign is the parity of nb - 1, which is odd
    _, _, acc = static_steps(xs, xls, acc, -1)
    acc = list(acc)
    zero = jnp.zeros_like(acc[0])
    return acc + [zero] * (WORDS - len(acc))


def _kernel(x_ref, xl_ref, smid_ref, cols_ref, out_ref, *, r, u,
            tier: Tier, ptx: bool):
    """One program: on the card (ptx) the rows are separate lane vectors
    and column entries scalar loads; the interpreter stacks them."""
    nrow = x_ref.shape[0]
    lo = tier.full_df
    if ptx:
        xs = [x_ref[i, :] for i in range(nrow)]
        xls = [xl_ref[i, :] for i in range(nrow)] if lo else None

        def col(k):
            return [(cols_ref[0, k, i], cols_ref[1, k, i] if lo else None)
                    for i in range(nrow)]
    else:
        xs = x_ref[...]
        xls = xl_ref[...] if lo else None

        def col(k):
            return cols_ref[0, k, :], cols_ref[1, k, :] if lo else None

    words = _walk(xs, xls, smid_ref[0, :], col, r=r, u=u, tier=tier,
                  ptx=ptx)
    for w, v in enumerate(words):
        out_ref[w, :] = v


@functools.partial(jax.jit, static_argnames=("r", "u", "tier", "interpret"))
def walk_lanes(xhi, xlo, smid, cols, *, r: int, u: int, tier: Tier,
               interpret: bool):
    """The kernel call: (B, n_pad, L) lane x-vectors -> (B, WORDS, L)
    per-lane partial sums.

    cols is (2, n-1, n_pad) — one matrix for every block — or
    (B, 2, n-1, n_pad), a column table per block (the serving batch).
    The grid is (B, L // bl) programs of bl lanes; interpret mode runs
    wide programs instead (all blocks of a shared table in one), which
    keeps the CPU interpreter vectorised.
    """
    B, n_pad, L = xhi.shape
    if interpret and B > 1 and cols.ndim == 3:
        # the CPU interpreter walks one program at a time: fold the
        # blocks that share a column table into one wide lane axis
        def fold(v):
            return v.transpose(1, 0, 2).reshape(1, v.shape[1], B * L)
        out = walk_lanes(fold(xhi), fold(xlo), fold(smid), cols, r=r, u=u,
                         tier=tier, interpret=True)
        return out.reshape(WORDS, B, L).transpose(1, 0, 2)
    if interpret:
        bl = L
    else:
        # Triton blocks are powers of two: pad the lane axis to a
        # multiple of the program width (padded lanes are sliced off)
        bl = min(BLOCK_LANES, 1 << (L - 1).bit_length())
        Lp = -(-L // bl) * bl
        if Lp != L:
            pad = ((0, 0), (0, 0), (0, Lp - L))
            out = walk_lanes(jnp.pad(xhi, pad), jnp.pad(xlo, pad),
                             jnp.pad(smid, pad), cols, r=r, u=u, tier=tier,
                             interpret=interpret)
            return out[..., :L]
    lane_spec = pl.BlockSpec((None, n_pad, bl), lambda b, j: (b, 0, j))
    if cols.ndim == 4:
        col_spec = pl.BlockSpec((None,) + cols.shape[1:],
                                lambda b, j: (b, 0, 0, 0))
    else:
        col_spec = pl.BlockSpec(cols.shape, lambda b, j: (0, 0, 0))
    kern = functools.partial(_kernel, r=r, u=u, tier=tier,
                             ptx=not interpret)
    return pl.pallas_call(
        kern,
        grid=(B, L // bl),
        in_specs=[lane_spec, lane_spec,
                  pl.BlockSpec((None, 1, bl), lambda b, j: (b, 0, j)),
                  col_spec],
        out_specs=pl.BlockSpec((None, WORDS, bl), lambda b, j: (b, 0, j)),
        out_shape=jax.ShapeDtypeStruct((B, WORDS, L), _F32),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=interpret,
        name="gray_walk",
    )(xhi, xlo, smid, cols)


def merge_words(a, b, tier: Tier):
    """Lane-wise compensated sum of two (..., WORDS, L) partials."""
    def w(x, i):
        return x[..., i, :]
    if tier.tf:
        s = tfm.tf_add(w(a, 0), w(a, 1), w(a, 2), w(b, 0), w(b, 1), w(b, 2))
    elif tier.df:
        s = df64.df_add(w(a, 0), w(a, 1), w(b, 0), w(b, 1))
    elif tier.kahan:
        hi, e = df64.two_sum(w(a, 0), w(b, 0))
        s = (hi, w(a, 1) + w(b, 1) + e)
    else:
        s = (w(a, 0) + w(b, 0),)
    return _stack_words(s, a)


def weight_words(o, w_hi, w_lo, tier: Tier):
    """Multiply per-lane partials by per-lane df64 weights (the
    factored-out constant-row products of the sparse path).  tf96
    partials take the weight as a zero-extended triple."""
    if tier.tf:
        s = tfm.tf_mul(o[..., 0, :], o[..., 1, :], o[..., 2, :],
                       w_hi, w_lo, jnp.zeros_like(w_hi))
    elif tier.df or tier.kahan:
        s = df64.df_mul(o[..., 0, :], o[..., 1, :], w_hi, w_lo)
    else:
        s = (o[..., 0, :] * w_hi,)
    return _stack_words(s, o)


def _stack_words(s, like):
    rows = jnp.stack(s, axis=-2)
    pad = jnp.zeros(like.shape[:-2] + (WORDS - rows.shape[-2],)
                    + like.shape[-1:], like.dtype)
    return jnp.concatenate([rows, pad], axis=-2)


#: blocks summed per group by the on-device reduction (sparse path)
REDUCE_GROUP = 32


@functools.partial(jax.jit, static_argnames=(
    "r", "tier", "interpret", "weighted", "reduce"))
def partials(xhi, xlo, smid, cols, w_pair=None, *, r: int, tier: Tier,
             interpret: bool, weighted: bool = False, reduce: bool = False):
    """Kernel over a block of chunks, then the optional on-device
    reduction.

    w_pair: optional (B, 2, L) per-lane df64 chunk factors (the sparse
    path's factored-out constant-row products).
    reduce: weight, then fold each group of REDUCE_GROUP blocks with a
    halving tree of compensated adds; returns (B // 32, WORDS, L).
    Without reduce, returns the per-lane (B, WORDS, L) partials.
    """
    u = unroll_for(tier, r, interpret)
    out = walk_lanes(xhi, xlo, smid, cols, r=r, u=u, tier=tier,
                     interpret=interpret)
    if not reduce:
        return out
    if weighted:
        out = weight_words(out, w_pair[:, 0], w_pair[:, 1], tier)
    B, _, L = out.shape
    grp = out.reshape(B // REDUCE_GROUP, REDUCE_GROUP, WORDS, L)
    k = REDUCE_GROUP
    while k > 1:
        k //= 2
        grp = merge_words(grp[:, :k], grp[:, k:2 * k], tier)
    return grp[:, 0]


def lane_sums(out, tier: Tier):
    """(B, WORDS, L) -> (B, WORDS): per-block compensated halving tree
    over the lane axis (L a power of two)."""
    while out.shape[-1] > 1:
        h = out.shape[-1] // 2
        out = merge_words(out[..., :h], out[..., h:], tier)
    return out[..., 0]
