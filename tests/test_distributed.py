"""Distributed CG on a simulated 8-device CPU mesh — golden equality vs the
single-device solver (SURVEY.md §4 item 3)."""

import jax
import numpy as np
import pytest

from lsbench_tpu.matrix.generate import poisson_2d, random_spd
from lsbench_tpu.parallel.dist_cg import DistributedCg
from lsbench_tpu.parallel.mesh import make_row_mesh
from lsbench_tpu.solvers.base import get_solver

from conftest import make_rhs


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_row_mesh(8)


def test_dist_cg_matches_single_device(mesh8):
    A = poisson_2d(13)  # n=169, not divisible by 8 → exercises padding
    b = make_rhs(A.nrows)
    dist = DistributedCg(A, mesh8, rtol=1e-10)
    res = dist.solve(b)
    assert res.converged

    cls, params = get_solver("cg")
    single = cls(A, rtol=1e-10, **params)
    res1 = single.solve(b)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res1.x),
                               rtol=1e-8, atol=1e-10)
    # Same math (fused reductions) → same iteration count.
    assert abs(res.iters - res1.iters) <= 2


def test_dist_cg_residual(mesh8):
    A = random_spd(257, seed=9)
    b = make_rhs(257)
    res = DistributedCg(A, mesh8, rtol=1e-9).solve(b)
    x = np.asarray(res.x)
    rr = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert rr < 1e-8


def test_dryrun_entrypoint(mesh8):
    from lsbench_tpu.parallel.dryrun import run_dryrun
    run_dryrun(8)


def test_graft_entry_single_chip():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_dist_gmres_matches_single(mesh8):
    from lsbench_tpu.parallel.dist_gmres import DistributedGmres
    A = poisson_2d(13)
    b = make_rhs(A.nrows)
    dist = DistributedGmres(A, mesh8, rtol=1e-10)
    res = dist.solve(b)
    assert res.converged, (res.iters, res.relres)
    np.testing.assert_allclose(res.x, np.linalg.solve(A.to_dense(), b),
                               rtol=1e-6)
    cls, params = get_solver("gmres")
    res1 = cls(A, rtol=1e-10, **params).solve(b)
    assert abs(res.iters - res1.iters) <= params.get("restart", 30)


def test_dist_gmres_nonsymmetric(mesh8):
    from lsbench_tpu.parallel.dist_gmres import DistributedGmres
    rng = np.random.default_rng(5)
    n = 120
    from lsbench_tpu.matrix.csr import CsrMatrix
    a = np.eye(n) * 4 + np.diag(rng.random(n - 1), 1) - np.diag(
        rng.random(n - 1) * 0.5, -1)
    A = CsrMatrix.from_dense(a)
    b = make_rhs(n)
    res = DistributedGmres(A, mesh8, rtol=1e-10).solve(b)
    assert res.converged
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b), rtol=1e-6)


def test_dist_bicgstab_matches_single(mesh8):
    from lsbench_tpu.parallel.dist_bicgstab import DistributedBicgstab
    A = poisson_2d(13)
    b = make_rhs(A.nrows)
    dist = DistributedBicgstab(A, mesh8, rtol=1e-10)
    res = dist.solve(b)
    assert res.converged, (res.iters, res.relres)
    np.testing.assert_allclose(res.x, np.linalg.solve(A.to_dense(), b),
                               rtol=1e-5)
    cls, params = get_solver("bicgstab")
    res1 = cls(A, rtol=1e-10, **params).solve(b)
    assert abs(res.iters - res1.iters) <= 3  # same recurrence, same dots


def test_dist_cg_block_jacobi():
    import numpy as np
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    import jax
    if jax.device_count() < 4:
        import pytest
        pytest.skip("needs 4 virtual devices")
    A = poisson_2d(12)
    b = np.arange(A.nrows, dtype=np.float64)
    mesh = make_row_mesh(4)
    res_bj = DistributedCg(A, mesh, rtol=1e-10, precond="block_jacobi").solve(b)
    res_j = DistributedCg(A, mesh, rtol=1e-10, precond="jacobi").solve(b)
    assert res_bj.converged and res_j.converged
    # Comparable strength on a 5-point stencil; must not be much weaker.
    assert res_bj.iters <= res_j.iters + 5
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(res_bj.x), x_ref, rtol=1e-6,
                               atol=1e-8)


def test_dist_bicgstab_gmres_halo_strategy():
    # Halo exchange (O(H) per matvec) must give the same answers as
    # all_gather for banded matrices, across both Krylov families.
    import numpy as np
    import jax
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_bicgstab import DistributedBicgstab
    from lsbench_tpu.parallel.dist_gmres import DistributedGmres
    from lsbench_tpu.parallel.mesh import make_row_mesh
    if jax.device_count() < 4:
        import pytest
        pytest.skip("needs 4 virtual devices")
    A = poisson_2d(12)
    b = np.arange(A.nrows, dtype=np.float64)
    mesh = make_row_mesh(4)
    x_ref = np.linalg.solve(A.to_dense(), b)
    for cls in (DistributedBicgstab, DistributedGmres):
        sols = {}
        for strat in ("halo", "all_gather"):
            s = cls(A, mesh, rtol=1e-10, strategy=strat)
            assert s.strategy == strat
            res = s.solve(b)
            assert res.converged, (cls.__name__, strat)
            sols[strat] = np.asarray(res.x)
            np.testing.assert_allclose(sols[strat], x_ref, rtol=1e-6,
                                       atol=1e-8)


def test_init_distributed_validation():
    # Multi-host seam (SURVEY.md §2.2): argument validation without
    # actually bootstrapping a cluster.
    import pytest
    from lsbench_tpu.parallel.mesh import init_distributed
    with pytest.raises(ValueError, match="host:port"):
        init_distributed("nocolon")
    with pytest.raises(ValueError, match="both"):
        init_distributed("h:1234", num_processes=2)
    with pytest.raises(ValueError, match="out of range"):
        init_distributed("h:1234", num_processes=2, process_id=5)


def test_cli_coordinator_flag_rejects_bad_address(tmp_path):
    from lsbench_tpu.harness.cli import main
    p = tmp_path / "m.txt"
    p.write_text("1 0\n0 0 1.0\n")
    rc = main(["--matrix", str(p), "--coordinator", "badaddress",
               "--platform", "cpu"])
    assert rc == 1
