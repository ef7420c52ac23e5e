"""Native C++ reader vs numpy fallback equivalence."""

import numpy as np
import pytest

from lsbench_tpu.matrix.io import MatrixFormatError, _read_coo_numpy


def _native():
    try:
        from lsbench_tpu.native import reader
        reader._get_lib()
        return reader
    except Exception:
        pytest.skip("native toolchain unavailable")


def test_native_matches_numpy(tiny_matrix_file):
    reader = _native()
    rn, cn, vn, bn = reader.read_coo(str(tiny_matrix_file))
    rp, cp, vp, bp = _read_coo_numpy(str(tiny_matrix_file))
    assert bn == bp
    np.testing.assert_array_equal(rn, rp)
    np.testing.assert_array_equal(cn, cp)
    np.testing.assert_array_equal(vn, vp)


def test_native_reads_reference_matrix(ref_data_dir):
    reader = _native()
    rn, cn, vn, bn = reader.read_coo(str(ref_data_dir / "xn3b_A_18.txt"))
    from conftest import reference_standin
    assert len(vn) == reference_standin("xn3b_A_18.txt").nnz and bn == 1
    rp, cp, vp, bp = _read_coo_numpy(str(ref_data_dir / "xn3b_A_18.txt"))
    np.testing.assert_array_equal(rn, rp)
    np.testing.assert_allclose(vn, vp, rtol=0, atol=0)


@pytest.mark.parametrize("content,exc", [
    ("", MatrixFormatError),
    ("4 2\n", MatrixFormatError),
    ("0 0\n", MatrixFormatError),
    ("2 0\n0 0 1\n", MatrixFormatError),
    ("1 0\n0 x 1\n", MatrixFormatError),
])
def test_native_error_semantics(tmp_path, content, exc):
    reader = _native()
    p = tmp_path / "bad.txt"
    p.write_text(content)
    with pytest.raises(exc):
        reader.read_coo(str(p))


def test_native_missing_file():
    reader = _native()
    with pytest.raises(FileNotFoundError):
        reader.read_coo("/does/not/exist.txt")


def test_read_matrix_uses_native(tiny_matrix_file, monkeypatch):
    # End to end through read_matrix (native path active).
    _native()
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(tiny_matrix_file)
    np.testing.assert_allclose(A.to_dense(), np.diag([1.0, 2, 3, 4, 5]))


def test_native_min_degree_matches_python():
    # Quotient-graph C++ min-degree (native/mindeg.cpp) must produce the
    # exact permutation of the Python clique-update fallback — same exterior
    # degrees, same (degree, node) tie-break.
    import numpy as np
    pytest.importorskip("ctypes")
    from lsbench_tpu.matrix.generate import poisson_2d, random_spd
    from lsbench_tpu.native import NativeUnavailable
    from lsbench_tpu.ordering.amd import min_degree_graph
    from lsbench_tpu.ordering.rcm import _symmetrized_graph

    try:
        from lsbench_tpu.native.mindeg import min_degree
    except NativeUnavailable:
        pytest.skip("no native toolchain")
    for A in [poisson_2d(12), random_spd(150, seed=4)]:
        offs, cols = _symmetrized_graph(A)
        try:
            p_native = min_degree(offs, cols, A.nrows)
        except NativeUnavailable:
            pytest.skip("no native toolchain")
        np.testing.assert_array_equal(
            p_native, min_degree_graph(offs, cols, A.nrows))


def test_native_chol_numeric_matches_python(monkeypatch):
    import numpy as np
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.native import NativeUnavailable
    from lsbench_tpu.solvers import sparse_cholesky as sc

    A = sc.symmetrize(poisson_2d(11))
    parent = sc.elimination_tree(A)
    lo, lc = sc.symbolic_rows(A, parent)
    try:
        cp_n, ci_n, cx_n = sc.numeric_factor(A, lo, lc)
    except NativeUnavailable:
        pytest.skip("no native toolchain")
    import lsbench_tpu.native.spchol as S
    monkeypatch.setattr(S, "chol_numeric", None)  # force Python fallback
    cp_p, ci_p, cx_p = sc.numeric_factor(A, lo, lc)
    np.testing.assert_array_equal(cp_n, cp_p)
    np.testing.assert_array_equal(ci_n, ci_p)
    np.testing.assert_allclose(cx_n, cx_p, rtol=1e-14)


def test_native_chol_numeric_not_spd():
    import numpy as np
    from lsbench_tpu.matrix.csr import CsrMatrix
    from lsbench_tpu.native import NativeUnavailable
    from lsbench_tpu.solvers import sparse_cholesky as sc

    a = np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    A = CsrMatrix.from_dense(a)
    parent = sc.elimination_tree(A)
    lo, lc = sc.symbolic_rows(A, parent)
    try:
        with pytest.raises(np.linalg.LinAlgError):
            sc.numeric_factor(A, lo, lc)
    except NativeUnavailable:
        pytest.skip("no native toolchain")


def test_native_spgemm_matches_numpy_fallback():
    import numpy as np
    from lsbench_tpu.matrix.generate import random_spd
    from lsbench_tpu.ops import spgemm as sg

    A = random_spd(150, nnz_per_row=9, seed=1)
    C_native = sg.spgemm(A, A)
    np.testing.assert_allclose(C_native.to_dense(),
                               A.to_dense() @ A.to_dense(), atol=1e-10)
    # rectangular: A (n x n) @ P (n x nc)
    from lsbench_tpu.matrix.csr import CsrMatrix
    rng = np.random.default_rng(0)
    n, nc = 150, 40
    rows = np.arange(n)
    cols = rng.integers(0, nc, n)
    P = CsrMatrix.from_coo(rows, cols, rng.random(n), nrows=n, ncols=nc)
    C2 = sg.spgemm(A, P)
    np.testing.assert_allclose(C2.to_dense(), A.to_dense() @ P.to_dense(),
                               atol=1e-10)
    assert C2.shape == (n, nc)


def test_native_amd_quality_and_validity():
    # lsb_amd (approximate minimum degree, round 5): a valid permutation
    # whose fill is no worse than ~1.1x the exact-MD fill (measured
    # BETTER: 9.06M vs 12.25M at n=262k) and deterministic.
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.ordering.rcm import _symmetrized_graph
    from lsbench_tpu.solvers.sparse_cholesky import (elimination_tree,
                                                     symbolic_rows,
                                                     symmetrize)
    try:
        from lsbench_tpu.native.mindeg import amd_approx, min_degree
    except Exception:
        pytest.skip("native toolchain unavailable")
    A = poisson_2d(40)
    offs, cols = _symmetrized_graph(A)
    p1 = amd_approx(offs, cols, A.nrows)
    p2 = amd_approx(offs, cols, A.nrows)
    np.testing.assert_array_equal(p1, p2)          # deterministic
    assert sorted(p1) == list(range(A.nrows))      # valid permutation

    def fill(perm):
        Ap = symmetrize(A.permuted(perm))
        lo, _ = symbolic_rows(Ap, elimination_tree(Ap))
        return int(lo[-1])

    f_amd = fill(p1)
    f_md = fill(min_degree(offs, cols, A.nrows))
    assert f_amd <= 1.1 * f_md, (f_amd, f_md)


@pytest.mark.parametrize("make", ["poisson_2d", "random_spd", "sem_2d_rcm"])
def test_native_symbolic_matches_python(monkeypatch, make):
    """Native etree and row patterns (native/spchol.cpp) equal the Python
    implementations they replace when the toolchain is present."""
    import numpy as np
    from lsbench_tpu.matrix.generate import poisson_2d, random_spd, sem_2d
    from lsbench_tpu.native import NativeUnavailable
    from lsbench_tpu.ordering.rcm import rcm_ordering
    from lsbench_tpu.solvers import sparse_cholesky as sc

    if make == "poisson_2d":
        A = poisson_2d(11)
    elif make == "random_spd":
        A = random_spd(150, seed=4)
    else:
        A = sem_2d(6, 2, seed=0)
        A = A.permuted(rcm_ordering(A))
    A = sc.symmetrize(A)
    import lsbench_tpu.native.spchol as S
    try:
        parent_n = S.etree(A.nrows, A.offs, A.cols)
        lo_n, lc_n = S.symbolic_rows(A.nrows, A.offs, A.cols, parent_n)
    except NativeUnavailable:
        pytest.skip("no native toolchain")

    def unavailable(*args):
        raise NativeUnavailable("forced Python fallback")
    monkeypatch.setattr(S, "etree", unavailable)
    monkeypatch.setattr(S, "symbolic_rows", unavailable)
    parent_p = sc.elimination_tree(A)
    lo_p, lc_p = sc.symbolic_rows(A, parent_p)
    np.testing.assert_array_equal(parent_n, parent_p)
    np.testing.assert_array_equal(lo_n, lo_p)
    np.testing.assert_array_equal(lc_n, lc_p)
