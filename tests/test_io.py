import numpy as np
import pytest

from lsbench_tpu.matrix.io import MatrixFormatError, read_matrix, write_matrix


def test_read_diag(tiny_matrix_file):
    A = read_matrix(tiny_matrix_file)
    assert A.nrows == A.ncols == 5
    assert A.nnz == 5
    np.testing.assert_allclose(A.to_dense(), np.diag([1.0, 2, 3, 4, 5]))


def test_base0_base1_equivalent(base_pair_files):
    a0, a1 = base_pair_files
    A0, A1 = read_matrix(a0), read_matrix(a1)
    np.testing.assert_array_equal(A0.to_dense(), A1.to_dense())
    assert A0.nrows == 2


def test_duplicates_summed(tmp_path):
    # Reference sums repeated (row, col) entries (lsbench-csr.c:56-63).
    p = tmp_path / "dup.txt"
    p.write_text("4 0\n0 0 1.5\n0 0 2.5\n1 1 1\n0 1 3\n")
    A = read_matrix(p)
    assert A.nnz == 3
    np.testing.assert_allclose(A.to_dense(), [[4.0, 3.0], [0.0, 1.0]])


def test_unsorted_input_sorted(tmp_path):
    p = tmp_path / "unsorted.txt"
    p.write_text("3 0\n1 1 4\n0 1 2\n0 0 1\n")
    A = read_matrix(p)
    np.testing.assert_allclose(A.to_dense(), [[1.0, 2.0], [0.0, 4.0]])
    assert np.all(np.diff(A.offs) >= 0)


@pytest.mark.parametrize("content,msg", [
    ("", "meta information"),
    ("abc def\n", "meta information"),
    ("4 2\n", "base"),
    ("0 0\n", "zero"),
    ("2 0\n0 0 1\n", "entries"),          # fewer rows than declared nnz
    ("1 0\n0 x 1\n", "entries"),          # unparsable value
])
def test_malformed(tmp_path, content, msg):
    p = tmp_path / "bad.txt"
    p.write_text(content)
    with pytest.raises(MatrixFormatError, match=msg):
        read_matrix(p)


def test_roundtrip(tmp_path):
    from lsbench_tpu.matrix.generate import random_spd
    A = random_spd(50, nnz_per_row=7, seed=3)
    for base in (0, 1):
        f = tmp_path / f"rt{base}.txt"
        write_matrix(A, f, base=base)
        B = read_matrix(f)
        np.testing.assert_allclose(B.to_dense(), A.to_dense(), rtol=0, atol=0)


def test_reference_matrices_parse(ref_data_dir):
    from conftest import reference_standin
    A = read_matrix(ref_data_dir / "I1_05x05.txt")
    np.testing.assert_allclose(A.to_dense(), np.diag([1.0, 2, 3, 4, 5]))
    B = read_matrix(ref_data_dir / "xn3b_A_18.txt")
    S = reference_standin("xn3b_A_18.txt")
    assert B.nrows == S.nrows == 3481 and B.nnz == S.nnz
    np.testing.assert_allclose(B.to_dense(), S.to_dense(), rtol=1e-15)
    assert B.symmetry_error() < 1e-6


def test_matrix_market_general(tmp_path):
    import numpy as np
    from lsbench_tpu.matrix.io import read_matrix
    p = tmp_path / "m.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate real general
% a comment
3 3 5
1 1 2.0
1 2 -1.0
2 2 2.0
3 3 2.0
2 1 -1.0
""")
    A = read_matrix(p)
    D = A.to_dense()
    np.testing.assert_allclose(
        D, [[2, -1, 0], [-1, 2, 0], [0, 0, 2]])


def test_matrix_market_symmetric(tmp_path):
    import numpy as np
    from lsbench_tpu.matrix.io import read_matrix
    p = tmp_path / "s.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 4.0
2 1 -1.0
2 2 4.0
3 2 -2.0
""")
    A = read_matrix(p)
    D = A.to_dense()
    np.testing.assert_allclose(
        D, [[4, -1, 0], [-1, 4, -2], [0, -2, 0]])


def test_matrix_market_pattern_and_errors(tmp_path):
    import pytest
    from lsbench_tpu.matrix.io import MatrixFormatError, read_matrix
    p = tmp_path / "p.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate pattern general
2 2 2
1 1
2 2
""")
    A = read_matrix(p)
    assert A.nnz == 2 and A.vals.sum() == 2.0
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(MatrixFormatError):
        read_matrix(bad)
