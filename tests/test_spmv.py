import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.ell import EllMatrix
from lsbench_tpu.matrix.generate import poisson_2d, random_spd
from lsbench_tpu.ops.spmv import spmv_ell
from lsbench_tpu.solvers.cg import LAYOUTS, build_matvec, resolve_layout


@pytest.mark.parametrize("make", [
    lambda: random_spd(100, nnz_per_row=7, seed=0),
    lambda: poisson_2d(11),
])
def test_spmv_ell_matches_host(make):
    A = make()
    ell = EllMatrix.from_csr(A)
    x = np.random.default_rng(1).random(A.ncols)
    y = np.asarray(spmv_ell(ell, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12)


def test_spmv_f32():
    A = random_spd(64, nnz_per_row=5, seed=2)
    ell = EllMatrix.from_csr(A, dtype=jnp.float32)
    x = np.random.default_rng(3).random(64).astype(np.float32)
    y = np.asarray(spmv_ell(ell, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-5)
    assert y.dtype == np.float32


def test_ell_padding_alignment():
    A = random_spd(100, nnz_per_row=7, seed=0)
    ell = EllMatrix.from_csr(A, row_align=128, width_align=8)
    assert ell.n_pad % 128 == 0
    assert ell.k % 8 == 0
    x = np.random.default_rng(4).random(100)
    np.testing.assert_allclose(np.asarray(spmv_ell(ell, jnp.asarray(x))),
                               A.matvec(x), rtol=1e-12)


def _empty_rows():
    """SPD-pattern matrix whose rows 3, 17, 40 hold no entries."""
    A = random_spd(64, nnz_per_row=7, seed=5)
    r, c, v = A.to_coo()
    keep = ~np.isin(r, [3, 17, 40])
    return CsrMatrix.from_coo(r[keep], c[keep], v[keep], nrows=64, ncols=64)


def _skewed_rows():
    """Arrow matrix: row 0 couples to every column, the rest to <= 3."""
    n = 300
    r = np.concatenate([np.zeros(n, int), np.arange(1, n), np.arange(1, n),
                        np.arange(2, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.zeros(n - 1, int),
                        np.arange(1, n - 1)])
    v = np.random.default_rng(6).standard_normal(r.size)
    return CsrMatrix.from_coo(r, c, v, nrows=n, ncols=n)


def _rectangular():
    """Tall prolongation-like operator: 200 rows, 37 columns, 1-4 per row."""
    rng = np.random.default_rng(8)
    r = np.repeat(np.arange(200), rng.integers(1, 5, 200))
    c = rng.integers(0, 37, r.size)
    return CsrMatrix.from_coo(r, c, rng.standard_normal(r.size),
                              nrows=200, ncols=37)


def _apply(A, layout, dtype, x):
    if layout == "ell_triton":
        from lsbench_tpu.ops.spmv_triton import (EllSlotMajor,
                                                 spmv_ell_triton)
        op = EllSlotMajor.from_csr(A, dtype=dtype)
        return spmv_ell_triton(op, jnp.asarray(x, dtype), interpret=True)
    apply, op, nbytes = build_matvec(A, dtype, layout)
    assert nbytes > 0
    return jax.jit(apply)(op, jnp.asarray(x, dtype))


@pytest.mark.parametrize("make", [_empty_rows, _skewed_rows, _rectangular],
                         ids=["empty_rows", "skewed_rows", "rectangular"])
@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spmv_layouts_match_host(layout, dtype, rtol, make):
    """Every SpMV layout (the Triton kernel in interpret mode) against
    the host fp64 product, on empty rows, strongly skewed rows, and a
    rectangular (AMG transfer-like) operator."""
    A = make()
    x = np.random.default_rng(7).standard_normal(A.ncols)
    y = np.asarray(_apply(A, layout, dtype, x), dtype=np.float64)
    assert y.shape == (A.nrows,)
    y_ref = A.matvec(x)
    assert np.linalg.norm(y - y_ref) <= rtol * np.linalg.norm(y_ref)


def test_resolve_layout_auto_and_rejects_removed():
    # Off the GPU "auto" is XLA's ELL: the Triton kernel lowers only there.
    assert jax.default_backend() != "gpu"
    A = poisson_2d(6)
    assert resolve_layout("auto", jnp.float64, A) == "ell"
    assert resolve_layout("ell_triton", jnp.float32, A) == "ell_triton"
    for gone in ("bsr", "bsr_df64", "bsr_classed", "bsr_xla", "csr", "dense",
                 "nope"):
        with pytest.raises(ValueError, match="unknown SpMV layout"):
            resolve_layout(gone, jnp.float64, A)


def _rows_of(k):
    """64 rows: row 0 holds k entries, the others one."""
    r = np.concatenate([np.zeros(k, int), np.arange(1, 64)])
    c = np.concatenate([np.arange(k), np.arange(1, 64)])
    return CsrMatrix.from_coo(r, c, np.ones(r.size), nrows=64, ncols=64)


@pytest.mark.parametrize("widest,layout", [(1, "ell_triton"),
                                           (32, "ell_triton"),
                                           (33, "ell"), (64, "ell")])
def test_auto_on_gpu_picks_by_widest_row(monkeypatch, widest, layout):
    """On the GPU "auto" gives the Triton kernel rows of at most
    TRITON_MAX_K entries and XLA's ELL wider ones; explicit names stand."""
    import lsbench_tpu.solvers.cg as cg
    assert cg.TRITON_MAX_K == 32
    monkeypatch.setattr(cg.jax, "default_backend", lambda: "gpu")
    A = _rows_of(widest)
    assert resolve_layout("auto", jnp.float64, A) == layout
    assert resolve_layout("ell", jnp.float64, A) == "ell"
    assert resolve_layout("ell_triton", jnp.float64, A) == "ell_triton"


def test_dist_local_spmv_rejects_removed():
    from lsbench_tpu.parallel.dist_spmv import build_dist_matvec
    from lsbench_tpu.parallel.mesh import make_row_mesh
    with pytest.raises(ValueError, match="unknown local_spmv 'bsr'"):
        build_dist_matvec(poisson_2d(8), make_row_mesh(2), jnp.float64,
                          local_spmv="bsr")


def test_cli_rejects_removed_layout(tmp_path, capsys):
    from lsbench_tpu.harness.cli import main
    from lsbench_tpu.matrix.io import write_matrix
    f = tmp_path / "p.txt"
    write_matrix(poisson_2d(6), f)
    rc = main(["--matrix", str(f), "--solver", "cg", "--opt", "layout=bsr",
               "--trials", "1", "--platform", "cpu"])
    assert rc == 1
    assert "unknown SpMV layout 'bsr'" in capsys.readouterr().err


def test_triton_route_is_named():
    """The Pallas call names its GPU route: lowering it for the CPU
    without interpret mode is refused instead of silently interpreted."""
    from lsbench_tpu.ops.spmv_triton import EllSlotMajor, spmv_ell_triton
    A = poisson_2d(8)
    op = EllSlotMajor.from_csr(A)
    with pytest.raises(Exception, match="interpret"):
        jax.jit(spmv_ell_triton)(op, jnp.ones(A.ncols)).block_until_ready()


@pytest.mark.parametrize("name,params", [
    ("cg", {"rtol": 1e-10}),
    ("gmres", {"rtol": 1e-10, "restart": 10}),
    ("bicgstab", {"rtol": 1e-8}),
    ("cg_ir", {"rtol": 1e-10}),
])
def test_solvers_run_the_triton_layout(monkeypatch, name, params):
    """Each Krylov loop with the Triton SpMV inside its jitted while and
    fori loops (interpret mode here) reaches its tolerance."""
    import functools

    import lsbench_tpu.ops.spmv_triton as st
    from lsbench_tpu.solvers.base import get_solver
    monkeypatch.setattr(st, "spmv_ell_triton",
                        functools.partial(st.spmv_ell_triton, interpret=True))
    A = poisson_2d(6)
    b = np.arange(A.nrows, dtype=np.float64)
    cls, base = get_solver(name)
    res = cls(A, **{**base, **params, "layout": "ell_triton"}).solve(b)
    rel = np.linalg.norm(b - A.matvec(np.asarray(res.x))) / np.linalg.norm(b)
    assert rel <= 2 * params["rtol"], (res.iters, rel)


@pytest.mark.parametrize("unroll", [1, 3, None],
                         ids=["unroll1", "unroll3", "no_loop"])
@pytest.mark.parametrize("make", [_empty_rows, _skewed_rows],
                         ids=["empty_rows", "skewed_rows"])
def test_triton_slot_loop_matches_host(make, unroll):
    """The Triton kernel's slot loop (interpret mode), with and without a
    remainder of slots after the last full step, against the host."""
    from lsbench_tpu.ops.spmv_triton import EllSlotMajor, spmv_ell_triton
    A = make()
    x = np.random.default_rng(9).standard_normal(A.ncols)
    op = EllSlotMajor.from_csr(A, tile=128)
    y = np.asarray(spmv_ell_triton(op, jnp.asarray(x), interpret=True,
                                   unroll=unroll))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-12)


def test_triton_program_size_is_bounded_in_k():
    """The kernel lowered for the GPU keeps its size as the ELL width
    grows from 5 to 300 (the slot loop); unrolling every slot makes it
    grow with k, which is what made wide AMG levels slow to compile."""
    from lsbench_tpu.ops.spmv_triton import EllSlotMajor, spmv_ell_triton

    def lowered_size(A, unroll):
        op = EllSlotMajor.from_csr(A)
        f = jax.jit(lambda op, x: spmv_ell_triton(op, x, unroll=unroll))
        low = f.trace(op, jnp.ones(A.ncols)).lower(
            lowering_platforms=("cuda",))
        return len(low.as_text())

    narrow, wide = poisson_2d(8), _skewed_rows()      # k = 5, k = 300
    assert lowered_size(wide, 4) < 1.5 * lowered_size(narrow, 4)
    assert lowered_size(wide, None) > 10 * lowered_size(narrow, None)
