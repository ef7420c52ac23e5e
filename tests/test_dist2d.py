"""2-D block-partitioned distributed SpMV / CG tests (8 virtual devices)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.generate import poisson_2d, random_spd
from lsbench_tpu.parallel.dist2d import DistributedCg2d, build_2d_plan, spmv_2d
from lsbench_tpu.parallel.mesh import make_mesh_2d

from conftest import make_rhs

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")


@pytest.mark.parametrize("pr,pc", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_spmv_2d_matches_host(pr, pc):
    A = poisson_2d(13)  # n=169, deliberately not divisible by 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.nrows)
    mesh = make_mesh_2d(pr, pc)
    y = spmv_2d(A, mesh, x)
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-12)


def test_spmv_2d_dense_random():
    # Unstructured pattern: exercises cross-block column chunks.
    A = random_spd(97, nnz_per_row=15, seed=7)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.nrows)
    mesh = make_mesh_2d(2, 4)
    y = spmv_2d(A, mesh, x)
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("pr,pc", [(2, 4), (4, 2)])
def test_cg_2d_converges_and_matches(pr, pc):
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    mesh = make_mesh_2d(pr, pc)
    res = DistributedCg2d(A, mesh, rtol=1e-10).solve(b)
    assert res.converged
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


def test_cg_2d_matches_1d_iterates():
    # Same math as the 1-D distributed CG: iteration counts agree.
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    A = poisson_2d(10)
    b = make_rhs(A.nrows)
    res2 = DistributedCg2d(A, make_mesh_2d(2, 4), rtol=1e-9).solve(b)
    res1 = DistributedCg(A, make_row_mesh(8), rtol=1e-9).solve(b)
    assert res2.converged and res1.converged
    assert abs(res2.iters - res1.iters) <= 2
    np.testing.assert_allclose(np.asarray(res2.x), np.asarray(res1.x),
                               rtol=1e-6, atol=1e-8)


def test_plan_covers_all_nnz():
    A = poisson_2d(9)
    plan = build_2d_plan(A, 2, 4, jnp.float64)
    assert float(np.abs(np.asarray(plan.vals)).sum()) == pytest.approx(
        float(np.abs(A.vals).sum()), rel=1e-14)


def test_bicgstab_2d_converges_and_matches():
    from lsbench_tpu.parallel.dist2d import DistributedBicgstab2d
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    res = DistributedBicgstab2d(A, make_mesh_2d(2, 4), rtol=1e-10).solve(b)
    assert res.converged
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-5, atol=1e-7)
    # Ginkgo protocol default: implicit resnorm 1e-4 of initial.
    res2 = DistributedBicgstab2d(A, make_mesh_2d(2, 4)).solve(b)
    assert res2.converged and res2.relres <= 1e-4


def test_bicgstab2d_bsr_path():
    import jax
    import pytest
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    from lsbench_tpu.parallel.dist2d import DistributedBicgstab2d
    from lsbench_tpu.parallel.mesh import make_mesh_2d

    # The block-sparse local kernels are gone; asking for one is an error.
    A = poisson_2d(20)
    with pytest.raises(ValueError, match="unknown local_spmv 'bsr'"):
        DistributedBicgstab2d(A, make_mesh_2d(2, 2), dtype=jnp.float64,
                              rtol=1e-8, local_spmv="bsr")


def test_cg2d_ordering_roundtrip(ref_data_dir):
    """RCM inside the 2-D solver (narrows the gathered-frame band) must
    be invisible outside."""
    import jax
    import pytest
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.parallel.dist2d import DistributedCg2d
    from lsbench_tpu.parallel.mesh import make_mesh_2d

    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = np.arange(A.nrows, dtype=np.float64)
    s = DistributedCg2d(A, make_mesh_2d(2, 2), dtype=jnp.float64,
                        rtol=1e-10, ordering="rcm")
    res = s.solve(b)
    assert res.converged
    rr = np.linalg.norm(b - A.matvec(np.asarray(res.x))) / np.linalg.norm(b)
    assert rr < 1e-9


# ------------------------- 2-D AMG-CG + multi-RHS block CG (r3 next 4)

def test_amg_cg_2d_converges_and_matches_1d():
    """AMG-preconditioned CG on the 2-D partition: every hierarchy
    operator (A/P/R per level) 2-D-sharded. Matches the dense solve and
    the 1-D DistributedAmgCg's iteration count (same hierarchy math)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    from lsbench_tpu.parallel.dist_amg import DistributedAmgCg
    from lsbench_tpu.parallel.dist_amg2d import DistributedAmgCg2d
    from lsbench_tpu.parallel.mesh import make_row_mesh
    A = poisson_2d(13)
    b = make_rhs(A.nrows)
    res2 = DistributedAmgCg2d(A, make_mesh_2d(2, 4), rtol=1e-10,
                              coarse_n=32).solve(b)
    assert res2.converged
    assert res2.extra["true_relres"] <= 1e-10
    np.testing.assert_allclose(np.asarray(res2.x),
                               np.linalg.solve(A.to_dense(), b),
                               rtol=1e-6, atol=1e-8)
    res1 = DistributedAmgCg(A, make_row_mesh(8), rtol=1e-10,
                            coarse_n=32).solve(b)
    assert abs(res2.iters - res1.iters) <= 2


def test_amg_cg_2d_reference_matrix_classical(ref_data_dir):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.parallel.dist_amg2d import DistributedAmgCg2d
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedAmgCg2d(A, make_mesh_2d(2, 2), rtol=1e-8,
                             coarsening="classical", theta=0.5,
                             interp="jacobi", interp_passes=3,
                             interp_omega=0.5, pmax=8).solve(b)
    assert res.converged
    assert res.extra["true_relres"] <= 1e-8


def test_block_cg_2d_matches_1d(ref_data_dir):
    """Multi-RHS block CG on the 2-D partition (--nrhs x --mesh): per-
    column direct tolerance, equality with the 1-D dist block CG."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.parallel.dist2d import DistributedBlockCg2d
    from lsbench_tpu.parallel.dist_block_cg import DistributedBlockCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    rng = np.random.default_rng(0)
    B = np.column_stack([np.arange(A.nrows, dtype=np.float64),
                         rng.standard_normal(A.nrows),
                         rng.standard_normal(A.nrows)])
    res2 = DistributedBlockCg2d(A, make_mesh_2d(2, 4), nrhs=3,
                                rtol=1e-10).solve(B)
    assert res2.converged
    assert res2.extra["true_relres"] <= 1e-10
    assert res2.extra["precision_mode"] == "fp32_ir"
    res1 = DistributedBlockCg(A, make_row_mesh(8), nrhs=3,
                              rtol=1e-10).solve(B)
    nb = np.linalg.norm(np.asarray(res1.x))
    assert (np.linalg.norm(np.asarray(res2.x) - np.asarray(res1.x)) / nb
            < 1e-8)


def test_cli_mesh_amg_and_nrhs_routes(ref_data_dir, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    import json

    from lsbench_tpu.harness.cli import main
    REF = str(ref_data_dir / "xn3b_A_18.txt")
    rc = main(["--matrix", REF, "--solver", "cg", "--precond",
               "amg_classical", "--devices", "4", "--mesh", "2x2",
               "--rtol", "1e-8", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mesh"] == [2, 2]
    assert rec["levels"] >= 2
    assert rec["true_relres"] <= 1e-8

    rc = main(["--matrix", REF, "--solver", "cg", "--nrhs", "2",
               "--devices", "4", "--mesh", "2x2", "--trials", "1",
               "--json", "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver"] == "block_cg"
    assert rec["nrhs"] == 2
    assert rec["mesh"] == [2, 2]
    assert rec["true_relres"] <= 1e-10
