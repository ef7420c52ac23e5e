"""Tests that need the NVIDIA GPU: run on the card with

    python -m pytest tests/ -m gpu -q

Each takes the `gpu` fixture (tests/conftest.py), which skips it on any
other backend. They pin what only the card can show: the SpMV layouts as
compiled for it (the Triton route included) against scipy, and the
native-fp64 solvers at the reference's direct tolerance 1e-10
(cusparse.c:184).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from lsbench_tpu.matrix.generate import sem_2d
from lsbench_tpu.solvers.base import get_solver
from lsbench_tpu.solvers.cg import LAYOUTS, build_matvec, resolve_layout

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def A():
    return sem_2d(64, 2, seed=0)   # n = 16,641


def _solve(name, A, **params):
    cls, base = get_solver(name)
    b = np.arange(A.nrows, dtype=np.float64)
    res = cls(A, **{**base, **params}).solve(b)
    x = np.asarray(res.x, np.float64)
    return res, np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-12),
                                       (jnp.float32, 1e-5)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spmv_layout_on_gpu(gpu, A, layout, dtype, tol):
    x = np.random.default_rng(0).standard_normal(A.ncols)
    apply, op, _ = build_matvec(A, dtype, layout)
    y = np.asarray(jax.jit(apply)(op, jnp.asarray(x, dtype)), np.float64)
    y_ref = sp.csr_matrix((A.vals, A.cols, A.offs), shape=A.shape) @ x
    assert np.linalg.norm(y - y_ref) <= tol * np.linalg.norm(y_ref)


def test_triton_wide_rows_on_gpu(gpu):
    """The Triton kernel as compiled for the card on an arrow matrix whose
    first row holds 2,000 entries (ELL width 2,000): the slot loop keeps
    the program small, and the product matches scipy."""
    from lsbench_tpu.matrix.csr import CsrMatrix
    n = 2000
    r = np.concatenate([np.zeros(n, int), np.arange(1, n), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.zeros(n - 1, int)])
    v = np.random.default_rng(1).standard_normal(r.size)
    W = CsrMatrix.from_coo(r, c, v, nrows=n, ncols=n)
    x = np.random.default_rng(2).standard_normal(n)
    apply, op, _ = build_matvec(W, jnp.float64, "ell_triton")
    y = np.asarray(jax.jit(apply)(op, jnp.asarray(x)))
    y_ref = sp.csr_matrix((W.vals, W.cols, W.offs), shape=W.shape) @ x
    assert np.linalg.norm(y - y_ref) <= 1e-12 * np.linalg.norm(y_ref)


@pytest.mark.parametrize("name", ["amgx", "paralmond"])
def test_amg_triton_levels_on_gpu(gpu, A, name):
    """AMG under the card's "auto" (the Triton SpMV on level operators of
    at most TRITON_MAX_K entries a row, XLA's ELL on wider ones) gives the
    all-XLA-ELL hierarchy's answer."""
    b = np.arange(A.nrows, dtype=np.float64)
    cls, base = get_solver(name)
    x_auto = np.asarray(cls(A, **base).solve(b).x, np.float64)
    x_ell = np.asarray(cls(A, **{**base, "layout": "ell"}).solve(b).x,
                       np.float64)
    assert np.linalg.norm(x_auto - x_ell) <= 1e-10 * np.linalg.norm(x_ell)


def test_auto_layout_is_the_triton_kernel(gpu, A):
    for dtype in (jnp.float64, jnp.float32):
        assert resolve_layout("auto", dtype, A) == "ell_triton"


@pytest.mark.parametrize("name,params", [
    ("cg", {"rtol": 1e-10}),
    ("gmres", {"rtol": 1e-10, "restart": 50}),
    ("bicgstab", {"rtol": 1e-11}),
    ("cholmod", {}),
    ("cusolver", {}),
])
def test_native_fp64_solve_on_gpu(gpu, name, params):
    A = sem_2d(24, 2, seed=1)      # n = 2,401: small enough for dense
    res, rel = _solve(name, A, **params)
    assert rel <= 1e-10, (name, res.iters, rel)
    assert res.extra.get("precision_mode") is None


def test_cg_on_gpu_matches_cpu(gpu, A):
    """Same solve, same iteration count within 2 on the card (Triton
    SpMV) and the host CPU backend (XLA's ELL): summation order differs,
    the algorithm does not."""
    res_gpu, _ = _solve("cg", A, rtol=1e-10)
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu, _ = _solve("cg", A, rtol=1e-10, layout="ell")
    assert abs(res_gpu.iters - res_cpu.iters) <= 2
