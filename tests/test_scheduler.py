"""Hybrid dynamic chunk scheduler: device+CPU overlap, checkpoint/resume,
failure retry (reference multigpucpu_chunks parity, SURVEY.md §2.4.1)."""

import json

import numpy as np
import pytest

import superman_tpu as sp
from superman_tpu.bindings.native import native_available
from superman_tpu.ops.oracle import perman64
from tests.conftest import random_int_matrix


def test_hybrid_matches_single(rng):
    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    ref = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256)
    hyb = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                       hybrid=True, cpu=False)
    # unit-wise regrouping of the f64 sums: 1e-12, not bitwise
    assert hyb.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert hyb.algo_name.startswith("ryser_hybrid")
    assert hyb.meta["hybrid"]["units"] >= 1


@pytest.mark.skipif(not native_available(), reason="no native engine")
def test_hybrid_with_cpu_helper(rng):
    """Mixed device+CPU units: the workers use different arithmetic (df64
    pair vs double/long-double), so the invariant is reference-grade
    relative accuracy, not bitwise equality (that holds only when all
    units run on one engine kind)."""
    a = random_int_matrix(rng, 22, 0.4, vmax=2)
    hyb = sp.permanent(a, calc="df64", chunk_log2=5, lanes=128,
                       hybrid=True, cpu=True, gpu=True, threads=2)
    ref = float(perman64(a))
    assert abs(hyb.permanent - ref) <= 1e-9 * abs(ref)
    h = hyb.meta["hybrid"]
    assert h["device"] + h["cpu"] == h["units"]
    assert h["cpu"] >= 1    # the helper actually participated


@pytest.mark.skipif(not native_available(), reason="no native engine")
def test_native_chunks_matches_kernel_convention(rng):
    """CPU chunk partials and the device kernel share the raw-sum convention:
    running ALL chunks through the native range engine and applying the
    same final sign factor reproduces the permanent."""
    from superman_tpu.bindings.native import perman_dense_chunks
    a = random_int_matrix(rng, 16, 0.6, vmax=1).astype(np.float64)
    n = 16
    r = 5
    ids = np.arange((1 << (n - 1)) >> r, dtype=np.int64)
    raw = perman_dense_chunks(a, ids, r, threads=2)
    # binary matrix: every x is a half-integer <= n/2, every product fits
    # in 2**53 -> the double walk is exact and the match is bitwise
    assert (4 * (n & 1) - 2) * raw == float(perman64(a))


def test_checkpoint_resume(rng, tmp_path):
    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    ck = str(tmp_path / "journal.jsonl")
    full = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                        hybrid=True, checkpoint_path=ck)
    lines = [json.loads(x) for x in open(ck)]
    assert lines[0]["key"]
    pulls = lines[1:]
    assert len(pulls) == full.meta["hybrid"]["units"]
    assert all("start" in rec and "count" in rec for rec in pulls)

    # truncate the journal to half the pulls -> resume computes the rest
    keep = 1 + len(pulls) // 2
    with open(ck, "w") as f:
        for rec in lines[:keep]:
            f.write(json.dumps(rec) + "\n")
    resumed = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                           hybrid=True, checkpoint_path=ck)
    assert resumed.permanent == pytest.approx(full.permanent, rel=1e-12)
    assert resumed.meta["hybrid"]["resumed"] == keep - 1

    # a different matrix invalidates the journal (key mismatch)
    b = random_int_matrix(rng, 21, 0.5, vmax=2)
    other = sp.permanent(b, calc="df64", chunk_log2=6, lanes=256,
                         hybrid=True, checkpoint_path=ck)
    assert other.meta["hybrid"]["resumed"] == 0


def test_failure_retry_then_abort(rng, monkeypatch):
    """A unit that keeps failing aborts the run with its id; transient
    failures are retried."""
    from superman_tpu.parallel import scheduler

    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    ref = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256)

    from superman_tpu.parallel.sharding import compute_partials as real_cp
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:       # fail one unit once
            raise RuntimeError("injected transient fault")
        return real_cp(*args, **kw)

    monkeypatch.setattr("superman_tpu.parallel.sharding.compute_partials",
                        flaky)
    res = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256, hybrid=True)
    assert res.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert res.meta["hybrid"]["retries"] == 1

    def always_fails(*args, **kw):
        raise RuntimeError("injected permanent fault")

    monkeypatch.setattr("superman_tpu.parallel.sharding.compute_partials",
                        always_fails)
    with pytest.raises(RuntimeError, match="blocks at 0 failed"):
        sp.permanent(a, calc="df64", chunk_log2=6, lanes=256, hybrid=True)


def test_hybrid_mesh_checkpoint_combo(tmp_path):
    """All distribution features at once: 4-device mesh, hybrid unit
    queue, checkpoint journal, sparse pruning.

    Deterministic local rng + a nonzero diagonal: the session rng made
    this test's matrix depend on every test added before it, and a
    matrix with an empty row/col takes ryser_exact's legitimate
    trivial-zero early-out, which (correctly) never reaches the hybrid
    scheduler — so meta['hybrid'] asserts here require a structurally
    nonzero matrix."""
    lrng = np.random.default_rng(2024)
    a = random_int_matrix(lrng, 21, 0.35, vmax=2)
    np.fill_diagonal(a, lrng.integers(1, 3, 21))
    ck = str(tmp_path / "combo.jsonl")
    ref = sp.permanent(a, calc="df64", chunk_log2=6, lanes=128)
    got = sp.permanent(a, calc="df64", chunk_log2=6, lanes=128,
                       sparse=True, preprocessing=2, hybrid=True,
                       mesh_shape=(4,), checkpoint_path=ck)
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.meta["hybrid"]["units"] >= 1
    # resume the same combo
    again = sp.permanent(a, calc="df64", chunk_log2=6, lanes=128,
                         sparse=True, preprocessing=2, hybrid=True,
                         mesh_shape=(4,), checkpoint_path=ck)
    assert again.meta["hybrid"]["resumed"] >= 1
    assert again.permanent == pytest.approx(got.permanent, rel=1e-12)


def test_journal_key_pins_layout(rng, tmp_path):
    """A journal written under one block layout must NOT be replayed under
    another (round-1 advisor finding: same (n, r) with different lanes
    reinterprets (start,count) ranges and silently corrupts the result)."""
    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    ck = str(tmp_path / "layout.jsonl")
    first = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                         hybrid=True, checkpoint_path=ck)
    # same n and chunk_log2, different lanes -> different layout
    other = sp.permanent(a, calc="df64", chunk_log2=6, lanes=128,
                         hybrid=True, checkpoint_path=ck)
    assert other.meta["hybrid"]["resumed"] == 0
    assert other.permanent == pytest.approx(first.permanent, rel=1e-12)


def test_failed_unit_handoff_to_cpu(rng, monkeypatch):
    """A unit that persistently fails on the device worker is handed back to
    the queue and completed by the CPU worker; the run still succeeds."""
    pytest.importorskip("ctypes")
    from superman_tpu.bindings.native import native_available
    if not native_available():
        pytest.skip("native engine unavailable")

    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    ref = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256)

    from superman_tpu.parallel.sharding import compute_partials as real_cp
    state = {"first_start": None}

    def poisoned(blk, *args, **kw):
        # permanently fail exactly one unit (identified by its first
        # chunk id) on the device side
        first = int(np.asarray(blk).ravel()[0])
        if state["first_start"] is None:
            state["first_start"] = first
        if first == state["first_start"]:
            raise RuntimeError("injected persistent device fault")
        return real_cp(blk, *args, **kw)

    monkeypatch.setattr("superman_tpu.parallel.sharding.compute_partials",
                        poisoned)
    res = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                       hybrid=True, cpu=True, gpu=True)
    assert res.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert res.meta["hybrid"]["handoffs"] >= 1
    assert res.meta["hybrid"]["cpu"] >= 1
