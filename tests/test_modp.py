"""Z_p modular device engine (ops/modp.py) vs the host/native exact twins.

The walk is plain `lax`, so the CPU run executes the same program the
GPU compiles.  No reference counterpart: the reference has no exact
engine at any scale (its double and __float128 walks disagree by
factors of 40+ on its own corpus).
"""

import numpy as np
import pytest

from superman_tpu.ops import modp
from superman_tpu.ops.exact import (_perman_bigint_dfs, _perman_mod_host,
                                    perman_exact_fraction)


def _rand_int_matrix(rng, n, density=1.0, hi=50):
    m = rng.integers(1, hi, size=(n, n))
    if density < 1.0:
        m = m * (rng.random((n, n)) < density)
    return [[int(v) for v in row] for row in m]


def test_dense_mod_walk_matches_host_twin(rng):
    for n in (2, 3, 5, 8, 13):
        m = _rand_int_matrix(rng, n, density=0.7)
        for p in (modp.PRIME_CEIL, 251):
            assert (modp.perman_core_mod(m, p)
                    == _perman_mod_host(m, p))


def test_glynn_mod_walk_matches_host_twin(rng):
    """Device Glynn tier (perman_core_glynn_mod): the SAME walk under
    the Glynn packing must reproduce the NW host twin at every prime —
    the pin for the algo2 cross-certification engine."""
    for n in (2, 3, 5, 8, 13):
        m = _rand_int_matrix(rng, n, density=0.7)
        for p in (modp.PRIME_CEIL, 251):
            assert (modp.perman_core_glynn_mod(m, p)
                    == _perman_mod_host(m, p))
    # edge: n == 1 / structurally zero column (cancellation-only zero
    # for Glynn — no pruning shortcut may fire)
    assert modp.perman_core_glynn_mod([[7]], 251) == 7
    z = _rand_int_matrix(rng, 5)
    for i in range(5):
        z[i][2] = 0
    assert modp.perman_core_glynn_mod(z, 251) == 0


def test_pruned_mod_walk_matches_exact_dfs(rng):
    tested = 0
    for n in (10, 12):
        for _ in range(4):
            m = _rand_int_matrix(rng, n, density=0.3, hi=30)
            exact = _perman_bigint_dfs(m)
            a2 = modp._doubled_object(m)
            for r in (4, 6):
                ids = modp._live_exact(a2, r)
                if ids is None:
                    continue
                for p in (modp.PRIME_CEIL, 1009):
                    assert (modp.perman_core_mod(m, p, ids=ids, r=r)
                            == exact % p)
                    tested += 1
    assert tested >= 4


def test_live_exact_keeps_every_nonzero_term():
    # entries past the 53-bit mantissa: a rounded f64 zero test would
    # wrongly kill the chunk where 2^60 + 1 + (-2^60) - 1 != 0 under
    # rounding; the exact bigint test must keep it.
    big = 1 << 60
    m = [[big + 1, 1, 1, 1],
         [1, 2, 0, 0],
         [3, 0, 1, 2],
         [2, 1, 1, 1]]
    exact = _perman_bigint_dfs(m)
    a2 = modp._doubled_object(m)
    ids = modp._live_exact(a2, 1)
    p = modp.PRIME_CEIL
    got = modp.perman_core_mod(m, p, ids=ids, r=1) \
        if ids is not None else modp.perman_core_mod(m, p)
    assert got == exact % p


def test_crt_driver_certifies_and_matches_native(rng):
    hits = 0
    for n in (8, 11):
        for _ in range(3):
            a = rng.random((n, n)) * (rng.random((n, n)) < 0.7)
            f_nat, m_nat = perman_exact_fraction(a)
            if m_nat.get("engine") not in ("native_mod", "host_mod"):
                continue
            f_dev, m_dev = perman_exact_fraction(a, engine="device")
            assert f_dev == f_nat
            assert m_dev["engine"] == "device_mod"
            assert m_dev["nprimes"] >= 1
            hits += 1
    assert hits >= 2


def test_crt_driver_integer_core_prunes():
    # small-integer sparse core: the bigint liveness plan engages and
    # the CRT total still matches the exact DFS value.  Fixed seed: a
    # draw with a NONZERO permanent (the shared session rng happened to
    # deal a structurally-zero matrix here and silently skipped).
    local = np.random.default_rng(40)
    m = _rand_int_matrix(local, 12, density=0.3, hi=9)
    exact = _perman_bigint_dfs(m)
    assert exact != 0
    per, meta = modp.crt_perman_core(m)
    assert per == exact
    assert meta["nprimes"] >= 1


def test_crt_checkpoint_resume(rng, tmp_path):
    """A restarted CRT run recomputes only the missing primes."""
    n = 9
    m = _rand_int_matrix(rng, n, density=0.8, hi=25)
    exact = _perman_bigint_dfs(m)
    ck = str(tmp_path / "res.jsonl")
    logs = []
    per1, meta1 = modp.crt_perman_core(m, checkpoint_path=ck,
                                       log=logs.append)
    assert per1 == exact
    n_primes_walked = len(logs)
    assert n_primes_walked == meta1["nprimes"] + 1
    # resume: every residue is already on disk -> zero walks, same value
    logs2 = []
    per2, meta2 = modp.crt_perman_core(m, checkpoint_path=ck,
                                       log=logs2.append)
    assert per2 == exact
    assert logs2 == []            # nothing recomputed
    # partial resume: drop the last line, exactly one prime re-walked
    lines = open(ck).read().splitlines()
    with open(ck, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    logs3 = []
    per3, _ = modp.crt_perman_core(m, checkpoint_path=ck,
                                   log=logs3.append)
    assert per3 == exact
    assert len(logs3) == 1


def test_prime_pool_is_prime_and_descending():
    ps = modp.primes_mod(40)
    assert len(set(ps)) == 40
    assert all(ps[i] > ps[i + 1] for i in range(39))
    assert ps[0] <= modp.PRIME_CEIL
    for p in ps:
        assert p % 2 == 1
        assert all(p % q for q in range(2, int(p ** 0.5) + 1))


def test_sentinel_lanes_masked_when_npad_equals_n(rng):
    """Z_p twin of the float engine's sentinel regression: unmasked dead
    lanes walk to nonzero products that are the SAME garbage integer mod
    every prime — so the CRT held-out verifier cannot catch it and the
    'exact' engine would certify a wrong permanent.  mod_partials must
    mask per lane before the sum."""
    n, p = 16, modp.PRIME_CEIL
    m = _rand_int_matrix(rng, n)
    ref = _perman_mod_host(m, p)
    ids = np.arange(1 << 11, dtype=np.int64)
    assert modp.perman_core_mod(m, p, ids=ids, r=4) == ref
    # two id lists of 1000 and 1048 chunks pad to 1024 and 2048 lanes
    # with sentinels; the walk is linear in its chunks, so their
    # residues still sum to the whole
    part = [modp.perman_core_mod(m, p, ids=ids[sl], r=4)
            for sl in (slice(0, 1000), slice(1000, None))]
    assert sum(part) % p == ref
    # pruned plans emit arbitrary-length id lists: same invariant
    m2 = _rand_int_matrix(rng, n, density=0.35, hi=20)
    from superman_tpu.ops.exact import _perman_bigint_dfs
    exact = _perman_bigint_dfs(m2)
    a2 = modp._doubled_object(m2)
    ids2 = modp._live_exact(a2, 4)
    if ids2 is not None and len(ids2):
        got = modp.perman_core_mod(m2, p, ids=ids2, r=4)
        assert got == exact % p


def test_checkpoint_rejects_other_cores_rows(rng, tmp_path):
    """Residue rows are stamped with the core fingerprint: a checkpoint
    left over from a DIFFERENT matrix passes the held-out verifier (its
    rows are mutually consistent with the old core), so without the
    stamp the engine would return the old matrix's permanent as
    certified-exact for the new one."""
    ck = str(tmp_path / "res.jsonl")
    m1 = _rand_int_matrix(rng, 8, density=0.8, hi=25)
    m2 = _rand_int_matrix(rng, 8, density=0.8, hi=25)
    assert m1 != m2
    per1, _ = modp.crt_perman_core(m1, checkpoint_path=ck)
    assert per1 == _perman_bigint_dfs(m1)
    # same path reused for a different core: every row must be ignored
    logs = []
    per2, _ = modp.crt_perman_core(m2, checkpoint_path=ck,
                                   log=logs.append)
    assert per2 == _perman_bigint_dfs(m2)
    assert any("fingerprint mismatch" in s for s in logs)


def test_prime_ceiling_guarded(rng):
    """Lazy residues are exact only while (2p)^2 < 2^24: a modulus above
    PRIME_CEIL must be a hard error, because rounded products would be
    the SAME wrong value for every prime — invisible to the CRT
    held-out verifier."""
    m = _rand_int_matrix(rng, 5)
    with pytest.raises(ValueError, match="lazy"):
        modp.perman_core_mod(m, 4093)
    assert modp.PRIME_CEIL < 2048
    assert all(q <= modp.PRIME_CEIL for q in modp.primes_mod(20))


def test_invp_down_never_overestimates():
    """floor(v * invp_down(p)) <= floor(v/p) for EVERY exact-f32 product
    v < 4p^2 and the residue stays < 2p — exhaustive over the worst
    (largest) primes and edge v values."""
    for p in modp.primes_mod(3) + [3, 5]:
        inv = float(modp._invp_down(p))
        assert inv < 1.0 / p
        vs = np.concatenate([
            np.arange(0, 5 * p, p // 2 + 1),             # small
            (np.arange(1, 4 * p, max(1, p // 7)) * p),   # exact multiples
            (np.arange(1, 4 * p, max(1, p // 7)) * p - 1),
            (np.arange(1, 4 * p, max(1, p // 7)) * p + 1),
            np.asarray([4 * p * p - 1, 4 * p * p - p, 0, 1, p - 1]),
        ]).astype(np.int64)
        vs = vs[(vs >= 0) & (vs < 4 * p * p)]
        vf = vs.astype(np.float32)
        q = np.floor(vf * np.float32(inv)).astype(np.int64)
        rr = vs - q * p
        assert (q <= vs // p).all()
        assert (rr >= 0).all() and (rr < 2 * p).all(), (p, rr.min(), rr.max())
