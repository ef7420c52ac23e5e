import jax.numpy as jnp
import numpy as np
import pytest

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.generate import poisson_2d, random_spd
from lsbench_tpu.solvers.base import get_solver

from conftest import make_rhs


def make(name, A, **kw):
    cls, params = get_solver(name)
    params.update(kw)
    return cls(A, **params)


def test_bicgstab_spd():
    A = poisson_2d(10)
    b = make_rhs(A.nrows)
    s = make("bicgstab", A, rtol=1e-10)
    res = s.solve(b)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(A.to_dense(), b), rtol=1e-6)


def test_bicgstab_nonsymmetric():
    # CG can't do this; BiCGSTAB covers Ginkgo's general role.
    rng = np.random.default_rng(0)
    n = 120
    d = np.diag(10.0 + rng.random(n))
    m = d + np.triu(rng.random((n, n)) * 0.5, 1) - np.tril(rng.random((n, n)) * 0.3, -1)
    m[np.abs(m) < 0.45] = 0.0
    np.fill_diagonal(m, 10.0 + rng.random(n))
    A = CsrMatrix.from_dense(m)
    b = make_rhs(n)
    res = make("bicgstab", A, rtol=1e-10, maxiter=2000).solve(b)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(m, b),
                               rtol=1e-5)


def test_ginkgo_alias_protocol():
    # ginkgo → bicgstab with 1e-4 implicit reduction (ginkgo.cpp:55-64).
    A = poisson_2d(10)
    b = make_rhs(A.nrows)
    cls, params = get_solver("ginkgo")
    assert params["rtol"] == 1e-4
    res = cls(A, **params).solve(b)
    assert res.converged
    assert res.relres <= 1e-4


@pytest.mark.parametrize("ordering", ["rcm", "amd"])
def test_cg_with_ordering(ordering):
    A = random_spd(150, seed=3)
    b = make_rhs(150)
    s = make("cg", A, rtol=1e-10, ordering=ordering)
    res = s.solve(b)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(A.to_dense(), b), rtol=1e-6)


def test_cg_ir_reaches_fp64_accuracy():
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    s = make("cg_ir", A, rtol=1e-11)
    res = s.solve(b)
    assert res.converged
    assert res.relres <= 1e-11
    assert res.extra["refine_passes"] >= 2  # f32 alone cannot reach 1e-11
    rr = s.residual_norm(res.x, b) / np.linalg.norm(b)
    assert rr < 1e-10


def test_cg_ir_with_bsr_and_rcm():
    A = random_spd(200, seed=5)
    b = make_rhs(200)
    s = make("cg_ir", A, rtol=1e-10, layout="ell", ordering="rcm")
    res = s.solve(b)
    assert res.converged and res.relres <= 1e-10


def test_reference_tolerance_both_families(ref_data_dir):
    # BASELINE north star: reference matrices solved to the direct-solve
    # tolerance 1e-10 (cusparse.c:184) with the native AMG-CG path.
    import numpy as np
    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.solvers.base import get_solver
    from conftest import make_rhs
    for name in ("tj7a_A_18.txt", "xn3b_A_18.txt"):
        A = read_matrix(ref_data_dir / name)
        b = make_rhs(A.nrows)
        cls, params = get_solver("cg")
        params.update(rtol=1e-10, precond="amg_classical")
        res = cls(A, **params).solve(b)
        assert res.converged, (name, res.iters, res.relres)
        x = np.asarray(res.x)
        rr = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
        assert rr < 1e-9, (name, rr)


def test_cli_opt_passthrough(tiny_matrix_file, capsys):
    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(tiny_matrix_file), "--solver", "cg",
               "--trials", "2", "--opt", "precond=none", "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "cg" in out


def test_cli_opt_bad_value(tiny_matrix_file, capsys):
    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(tiny_matrix_file), "--opt", "nonsense",
               "--platform", "cpu"])
    assert rc == 1


def test_gmres_ir_reaches_fp64_accuracy():
    # f32 Arnoldi + f64 residual refinement (refine.py::GmresIrSolver).
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    s = make("gmres_ir", A, rtol=1e-11, restart=40)
    res = s.solve(b)
    assert res.converged
    assert res.relres <= 1e-11
    assert res.extra["refine_passes"] >= 2  # f32 alone cannot reach 1e-11
    rr = s.residual_norm(res.x, b) / np.linalg.norm(b)
    assert rr < 1e-10


def test_gmres_ir_nonsymmetric():
    rng = np.random.default_rng(3)
    n = 120
    m = np.diag(10.0 + rng.random(n))
    m += np.triu(rng.random((n, n)) * 0.5, 1) - np.tril(rng.random((n, n)) * 0.3, -1)
    m[np.abs(m) < 0.45] = 0.0
    np.fill_diagonal(m, 10.0 + rng.random(n))
    A = CsrMatrix.from_dense(m)
    b = make_rhs(n)
    res = make("gmres_ir", A, rtol=1e-10, maxiter=2000).solve(b)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(m, b),
                               rtol=1e-6)


def test_bicgstab_ir_reaches_fp64_accuracy():
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    s = make("bicgstab_ir", A, rtol=1e-11)
    res = s.solve(b)
    assert res.converged
    assert res.relres <= 1e-11
    rr = s.residual_norm(res.x, b) / np.linalg.norm(b)
    assert rr < 1e-10


def test_bicgstab_ir_nonsymmetric():
    rng = np.random.default_rng(7)
    n = 120
    m = np.diag(10.0 + rng.random(n))
    m += np.triu(rng.random((n, n)) * 0.5, 1) - np.tril(rng.random((n, n)) * 0.3, -1)
    m[np.abs(m) < 0.45] = 0.0
    np.fill_diagonal(m, 10.0 + rng.random(n))
    A = CsrMatrix.from_dense(m)
    b = make_rhs(n)
    res = make("bicgstab_ir", A, rtol=1e-10, maxiter=2000).solve(b)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(m, b),
                               rtol=1e-6)


def test_ir_solve_fn_returns_x_only():
    # Contract (base.py): solve_fn() returns ONLY the solution array.
    A = poisson_2d(8)
    b = make_rhs(A.nrows)
    for name in ("cg_ir", "gmres_ir", "bicgstab_ir"):
        fn = make(name, A, rtol=1e-10).solve_fn()
        x = fn(jnp.asarray(b, jnp.float64))
        assert hasattr(x, "astype") and x.shape == (A.nrows,)


def test_bicgstab_ir_breakdown_guard_hard_matrix(ref_data_dir):
    # Regression: f32 BiCGSTAB on the tj7a series used to break down
    # (rho/omega underflow -> NaN x, observed as true_relres=nan). The
    # guarded loop must return a finite x
    # and the ginkgo-protocol tolerance.
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "tj7a_A_18.txt"))
    b = make_rhs(A.nrows)
    res = make("bicgstab_ir", A, rtol=1e-4, maxiter=40000).solve(b)
    x = np.asarray(res.x)
    assert np.isfinite(x).all()
    assert res.converged and res.relres <= 1e-4
