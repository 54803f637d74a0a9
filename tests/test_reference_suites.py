"""Known-answer regression tests on the reference's bundled matrices.

Mechanism (SURVEY.md §4): cross-algorithm agreement is the primary oracle —
the device engine, the host f64 walk, and the independent native C++ engine
all compute the same scalar.  Matrices are read straight from the
read-only reference checkout; sizes are capped at n=24 so the Pallas
interpret path stays fast on the CPU test backend.
"""

import os

import numpy as np
import pytest

import superman_tpu as sp
from superman_tpu.bindings.native import native_available
from superman_tpu.io.matrixmarket import read_any

REF = "/root/reference"
MATS = f"{REF}/revised_perman/matrices"

SMALL_REAL = [
    "Tina_DisCog_p.mtx",        # 11x11 pattern
    "Trefethen_20_s.mtx",       # 20x20 symmetric real
    "GD02_a_p.mtx",             # 23x23 pattern
    "Ragusa18.mtx",             # 23x23 real
    "Ragusa16.mtx",             # 24x24 real
    "can_24_ps.mtx",            # 24x24 symmetric pattern
    "mycielskian5_ps.mtx",      # 23x23 symmetric pattern
]

needs_ref = pytest.mark.skipif(not os.path.isdir(MATS),
                               reason="reference checkout not present")


@needs_ref
@pytest.mark.parametrize("name", SMALL_REAL)
def test_real_matrices_cross_engine(name):
    path = f"{MATS}/{name}"
    dev = sp.permanent(path, calc="df64")
    host = sp.permanent(path, calc="f64")
    assert dev.permanent == pytest.approx(host.permanent, rel=1e-8), name
    if native_available():
        nat = sp.permanent(path, calc="f64", cpu=True, gpu=False)
        assert nat.permanent == pytest.approx(host.permanent, rel=1e-9)


@needs_ref
def test_v1_triplet_suite_small():
    """v1 triplet format + int storage; n=22 keeps interpret mode fast.
    There is no n<30 triplet suite, so synthesize by reading n=30 and
    cropping is NOT valid — instead check reader parity: int/30 parses
    identically to erdos_int/30 (MatrixMarket twin)."""
    a = sp.read_triplet(f"{REF}/int/30_0.10_0").mat
    b = read_any(f"{REF}/revised_perman/erdos_int/30_0.10_0.mtx").mat
    assert np.array_equal(a != 0, b != 0)


@needs_ref
def test_transform_parity_on_reference_matrix():
    """Repro-script parity: the crash configs the reference pinned
    (scaling+sparse, compression+sparse) must run and agree here."""
    path = f"{MATS}/Ragusa16.mtx"
    base = sp.permanent(path, calc="df64")
    scaled = sp.permanent(path, calc="df64", sparse=True,
                          preprocessing=1, scaling_threshold=2.0)
    assert scaled.permanent == pytest.approx(base.permanent, rel=1e-6)
    compressed = sp.permanent(path, calc="df64", compression=True)
    assert compressed.permanent == pytest.approx(base.permanent, rel=1e-8)
    binary = sp.permanent(path, calc="df64", binary_graph=True)
    pattern = sp.permanent((np.asarray(read_any(path).mat) != 0)
                           .astype(np.int64), calc="df64")
    assert binary.permanent == pytest.approx(pattern.permanent, rel=1e-10)


@needs_ref
@pytest.mark.skipif(not native_available(), reason="no native engine")
def test_erdos_n30_native_vs_host():
    """n=30 is the reference's headline suite size; the native engine
    (seconds on CPU) cross-checks the host f64 walk on one density."""
    path = f"{REF}/int/30_0.70_0"
    nat = sp.permanent(path, calc="f64", cpu=True, gpu=False, threads=4)
    # host XLA walk is too slow at n=30 in tests; check against the
    # native skipper variant instead (independent code path)
    skip = sp.permanent(path, calc="f64", cpu=True, gpu=False, threads=4,
                        sparse=True, preprocessing=2)
    assert skip.permanent == pytest.approx(nat.permanent, rel=1e-9)
