"""Reader/writer parity for both matrix formats + CLI smoke tests."""

import numpy as np
import pytest

import superman_tpu as sp
from superman_tpu.core.matrix import DenseMatrix, matrix2compressed
from superman_tpu.io.triplet import read_triplet, write_triplet
from superman_tpu.io.matrixmarket import read_any, read_matrix_market
from tests.conftest import random_int_matrix


def test_triplet_roundtrip(rng, tmp_path):
    a = random_int_matrix(rng, 8, 0.5)
    p = str(tmp_path / "m.txt")
    write_triplet(p, DenseMatrix(a, "int"))
    dm = read_triplet(p)
    assert dm.type == "int"
    assert (dm.mat == a).all()


def test_triplet_binary_flag(rng, tmp_path):
    a = random_int_matrix(rng, 6, 0.5, vmax=9)
    p = str(tmp_path / "m.txt")
    write_triplet(p, DenseMatrix(a, "int"))
    dm = read_triplet(p, binary_graph=True)
    assert set(np.unique(dm.mat)) <= {0, 1}
    assert ((dm.mat != 0) == (a != 0)).all()


def _erdos(seed, n=30, d=0.10, ints=True):
    """A seeded matrix of the reference's Erdos suite family: n x n,
    density d, integer (1..4) or double (0..1) entries."""
    r = np.random.default_rng(seed)
    mask = r.random((n, n)) < d
    vals = r.integers(1, 5, (n, n)) if ints else r.random((n, n))
    return mask * vals


def _write_mtx(path, a, field="integer", symmetry="general"):
    """MatrixMarket coordinate writer (1-based; lower triangle only for
    symmetric files, values omitted for pattern files)."""
    n = a.shape[0]
    ij = [(i, j) for i, j in zip(*np.nonzero(a))
          if symmetry == "general" or i >= j]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{n} {n} {len(ij)}\n")
        for i, j in ij:
            v = "" if field == "pattern" else f" {a[i, j]}"
            f.write(f"{i + 1} {j + 1}{v}\n")


def test_reference_triplet_files_parse(tmp_path):
    a = _erdos(0)
    write_triplet(str(tmp_path / "int_30"), DenseMatrix(a, "int"))
    dm = read_triplet(str(tmp_path / "int_30"))
    assert dm.nov == 30 and dm.type == "int" and dm.nnz > 0
    assert (dm.mat == a).all()
    d = _erdos(1, ints=False)
    write_triplet(str(tmp_path / "double_30"), DenseMatrix(d, "double"))
    dd = read_triplet(str(tmp_path / "double_30"))
    assert dd.type == "double"
    assert np.allclose(dd.mat, d, rtol=1e-12)


def test_reference_mtx_parse(tmp_path):
    a = _erdos(2)
    _write_mtx(str(tmp_path / "erdos.mtx"), a)
    dm = read_matrix_market(str(tmp_path / "erdos.mtx"))
    assert dm.nov == 30 and dm.type == "int"
    assert (dm.mat == a).all()
    # symmetric pattern file: only the lower triangle is stored
    g = _erdos(3, n=39, d=0.08)
    g = ((g + g.T) != 0).astype(np.int64)
    _write_mtx(str(tmp_path / "graph.mtx"), g, field="pattern",
               symmetry="symmetric")
    sym = read_matrix_market(str(tmp_path / "graph.mtx"))
    assert (sym.mat == sym.mat.T).all()
    assert ((sym.mat != 0) == (g != 0)).all()


def test_mtx_matches_v1_triplet(tmp_path):
    """The MatrixMarket and v1 triplet files of one suite matrix read
    back identically."""
    a = _erdos(4, d=0.20)
    write_triplet(str(tmp_path / "30_0.20_0"), DenseMatrix(a, "int"))
    _write_mtx(str(tmp_path / "30_0.20_0.mtx"), a)
    x = read_triplet(str(tmp_path / "30_0.20_0")).mat
    y = read_matrix_market(str(tmp_path / "30_0.20_0.mtx")).mat
    assert (x == y).all()


def test_ccs_crs_views(rng):
    a = random_int_matrix(rng, 7, 0.4)
    sm = matrix2compressed(DenseMatrix(a, "int"))
    back = np.zeros_like(a)
    for j in range(7):
        for p in range(sm.cptrs[j], sm.cptrs[j + 1]):
            back[sm.rows[p], j] = sm.cvals[p]
    assert (back == a).all()
    back2 = np.zeros_like(a)
    for i in range(7):
        for p in range(sm.rptrs[i], sm.rptrs[i + 1]):
            back2[i, sm.cols[p]] = sm.rvals[p]
    assert (back2 == a).all()


def test_cli_smoke(rng, tmp_path, capsys):
    from superman_tpu.cli import main
    a = random_int_matrix(rng, 10, 0.6)
    np.fill_diagonal(a, 1)
    p = str(tmp_path / "m.txt")
    write_triplet(p, DenseMatrix(a, "int"))
    assert main(["-f", p, "-p", "1"]) == 0
    out = capsys.readouterr().out
    assert "Result ||" in out
    from superman_tpu.ops.oracle import perman_brute
    val = float(out.split("Result ||")[1].split("|")[2].split("in")[0])
    assert val == pytest.approx(perman_brute(a), rel=1e-9)


def test_cli_requires_file(capsys):
    from superman_tpu.cli import main
    assert main([]) == 1


def test_storage_quad_reads_longdouble(tmp_path):
    """-v parity: long-double storage captures >53-bit literals and feeds
    the quad calc path losslessly."""
    p = tmp_path / "q.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 2 4\n"
                 "1 1 1.00000000000000000001\n1 2 1\n2 1 1\n2 2 1\n")
    from superman_tpu.io.matrixmarket import read_any
    dm = read_any(str(p), storage_quad=True)
    assert dm.mat.dtype == np.longdouble
    import superman_tpu as sp
    r = sp.permanent(str(p), storage_quad_precision=True,
                     calculation_quad_precision=True)
    assert r.permanent == pytest.approx(2.0, rel=1e-12)


def test_nonsquare_rejected(tmp_path):
    p = tmp_path / "ns.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 3 2\n1 1 1.0\n2 3 1.0\n")
    from superman_tpu.io.matrixmarket import read_any
    with pytest.raises(ValueError, match="not square"):
        read_any(str(p))


def test_complex_rejected(tmp_path):
    p = tmp_path / "cx.mtx"
    p.write_text("%%MatrixMarket matrix coordinate complex general\n"
                 "2 2 1\n1 1 1.0 2.0\n")
    from superman_tpu.io.matrixmarket import read_any
    with pytest.raises(ValueError, match="complex"):
        read_any(str(p))


def test_unknown_flag_rejected():
    import superman_tpu as sp
    with pytest.raises(TypeError, match="unknown flags"):
        sp.permanent(np.eye(3), not_a_flag=1)


def test_cli_json_output(rng, tmp_path, capsys):
    from superman_tpu.cli import main
    from superman_tpu.core.matrix import DenseMatrix
    from superman_tpu.io.triplet import write_triplet
    import json as _json
    a = (rng.random((8, 8)) < 0.7).astype(np.int64)
    p = tmp_path / "m.txt"
    write_triplet(str(p), DenseMatrix(a, "int"))
    assert main(["-f", str(p), "--json"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = _json.loads(out[-1])
    assert "permanent" in rec and rec["file"] == str(p)


def test_skew_symmetric_mirrors_negated(tmp_path):
    p = tmp_path / "sk.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 5.0\n3 2 -2.0\n")
    from superman_tpu.io.matrixmarket import read_any
    m = read_any(str(p)).mat
    assert m[1, 0] == 5.0 and m[0, 1] == -5.0
    assert m[2, 1] == -2.0 and m[1, 2] == 2.0


def test_mtx_out_of_range_index_rejected(tmp_path):
    """A 0-based entry in a (1-based) MatrixMarket file must raise, not
    wrap to the last row via numpy negative indexing."""
    p = tmp_path / "zero_based.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 3 3\n0 0 1.5\n2 2 2.5\n3 3 3.5\n")
    with pytest.raises(ValueError, match="outside the declared"):
        read_any(str(p), 0, 0, 0)


def test_triplet_out_of_range_line_skipped(tmp_path):
    """v1 triplets skip erroneous lines (reference util.h:351) — an
    out-of-range index is one; a negative index must NOT wrap."""
    p = tmp_path / "bad.mtxzero"
    p.write_text("3 4 double\n0 0 1.0\n-1 2 9.0\n3 0 9.0\n2 2 2.0\n")
    dm = read_any(str(p), 0, 0, 0)
    a = np.asarray(dm.mat, dtype=np.float64)
    assert a[0, 0] == 1.0 and a[2, 2] == 2.0
    assert (a != 0).sum() == 2          # both bad lines ignored


def test_storage_quad_parses_past_f64(tmp_path):
    """-v quad storage must parse literals at long-double precision: a
    float() round-trip would quantize >53-bit values before the quad
    walk sees them (and runner would then route them to the double
    engine as 'exactly representable')."""
    if np.finfo(np.longdouble).nmant <= 52:
        pytest.skip("host long double is f64")
    lit = "1.00000000000000000007"     # differs from 1.0 past 53 bits
    p = tmp_path / "quad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 f"2 2 4\n1 1 {lit}\n1 2 1.0\n2 1 1.0\n2 2 1.0\n")
    dm = read_any(str(p), 0, 0, 1)
    a = dm.mat
    assert a.dtype == np.longdouble
    assert a[0, 0] != np.longdouble(1.0)
    assert a[0, 0] == np.longdouble(lit)
