"""Distributed mixed-precision CG (f32 inner + f64 refinement) on the
simulated 8-device mesh — the production fp64 solve mode over a mesh
(parallel/dist_cg_ir.py), plus the host-side ordering round-trip every
1-D distributed solver now supports (cusparse.c:66-96 role)."""

import numpy as np
import pytest

from lsbench_tpu.matrix.io import read_matrix
from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr
from lsbench_tpu.parallel.mesh import make_row_mesh



@pytest.fixture(scope="module")
def A(ref_data_dir):
    return read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))


@pytest.fixture(scope="module")
def mesh():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    return make_row_mesh(8)


def _true_relres(A, x, b):
    return (np.linalg.norm(b - A.matvec(np.asarray(x, np.float64)))
            / np.linalg.norm(b))


def test_dist_cg_ir_reaches_direct_tolerance(A, mesh):
    b = np.arange(A.nrows, dtype=np.float64)
    s = DistributedCgIr(A, mesh, rtol=1e-10)
    res = s.solve(b)
    assert res.converged
    assert res.extra["refine_passes"] <= 4
    assert res.extra["precision_mode"] == "fp32_ir_auto"
    assert _true_relres(A, res.x, b) <= 1e-10


def test_dist_cg_ir_matches_single_device(A):
    """Golden equality across mesh sizes (the race-check role,
    SURVEY.md §4 item 3): same x and same refinement structure."""
    import jax
    b = np.arange(A.nrows, dtype=np.float64)
    xs, passes = [], []
    for ndev in (1, 8):
        if len(jax.devices()) < ndev:
            pytest.skip("needs 8 simulated devices")
        s = DistributedCgIr(A, make_row_mesh(ndev), rtol=1e-10)
        res = s.solve(b)
        xs.append(np.asarray(res.x, np.float64))
        passes.append(res.extra["refine_passes"])
    # Both converged to 1e-10: agreement to that level (collectives
    # reorder f32 sums, so bitwise equality is not expected).
    nb = np.linalg.norm(xs[0])
    assert np.linalg.norm(xs[0] - xs[1]) / nb < 1e-9


def test_dist_cg_ir_ordering_roundtrip(A, mesh):
    """RCM inside the solver must be invisible outside: same solution
    as ordering='none', in the original numbering."""
    b = np.arange(A.nrows, dtype=np.float64)
    x_none = DistributedCgIr(A, mesh, rtol=1e-10, ordering="none").solve(b).x
    res = DistributedCgIr(A, mesh, rtol=1e-10, ordering="rcm").solve(b)
    assert _true_relres(A, res.x, b) <= 1e-10
    nb = np.linalg.norm(np.asarray(x_none))
    assert (np.linalg.norm(np.asarray(res.x) - np.asarray(x_none)) / nb
            < 1e-9)


def test_dist_cg_ordering_roundtrip(A, mesh):
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedCg(A, mesh, dtype="float64", rtol=1e-10,
                        ordering="rcm").solve(b)
    assert _true_relres(A, res.x, b) <= 1e-9


def test_dist_bicgstab_ordering_roundtrip(A, mesh):
    from lsbench_tpu.parallel.dist_bicgstab import DistributedBicgstab
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedBicgstab(A, mesh, dtype="float64", rtol=1e-8,
                              ordering="rcm").solve(b)
    assert _true_relres(A, res.x, b) <= 1e-7


def test_dist_gmres_ordering_roundtrip(A, mesh):
    from lsbench_tpu.parallel.dist_gmres import DistributedGmres
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedGmres(A, mesh, dtype="float64", rtol=1e-8,
                           ordering="rcm").solve(b)
    assert _true_relres(A, res.x, b) <= 1e-7


def test_dist_bicgstab_ir_reaches_direct_tolerance(A, mesh):
    """The ginkgo role over a mesh with honest fp64 semantics: f32
    BiCGSTAB inner + df64 refinement reaches the reference direct
    tolerance (ginkgo.cpp:55-64 + lsbench.c:140-141; VERDICT r3 next 3)."""
    from lsbench_tpu.parallel.dist_cg_ir import DistributedBicgstabIr
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedBicgstabIr(A, mesh, rtol=1e-10).solve(b)
    assert res.converged
    assert res.extra["precision_mode"] == "fp32_ir_auto"
    assert res.extra["true_relres"] <= 1e-10


def test_dist_bicgstab_ir_matches_single_chip(A, mesh):
    from lsbench_tpu.parallel.dist_cg_ir import DistributedBicgstabIr
    from lsbench_tpu.solvers.base import get_solver
    b = np.arange(A.nrows, dtype=np.float64)
    xd = np.asarray(DistributedBicgstabIr(A, mesh, rtol=1e-10).solve(b).x,
                    np.float64)
    cls, _ = get_solver("bicgstab_ir")
    xs = np.asarray(cls(A, rtol=1e-10).solve(b).x, np.float64)
    assert np.linalg.norm(xd - xs) / np.linalg.norm(xs) < 1e-9


def test_dist_gmres_ir_converges(mesh):
    """f32 restarted-GMRES inner + df64 refinement over the mesh (small
    Poisson: GMRES+Jacobi needs many iterations on the SPD reference
    workload, which is CG's job — this pins the nonsymmetric-capable
    path's structure and accuracy)."""
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_cg_ir import DistributedGmresIr
    Ap = poisson_2d(16)
    b = np.arange(Ap.nrows, dtype=np.float64)
    res = DistributedGmresIr(Ap, mesh, rtol=1e-10, restart=25).solve(b)
    assert res.converged
    assert _true_relres(Ap, res.x, b) <= 1e-10


def test_cli_ginkgo_fp32_ir_over_mesh(ref_data_dir, capsys):
    """`--solver ginkgo --precision fp32_ir --devices N` (the r3 cli
    rejection removed): reaches true 1e-10 under the spelled alias."""
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "ginkgo", "--precision",
               "fp32_ir", "--rtol", "1e-10", "--devices", "2",
               "--trials", "1", "--json", "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver"] == "ginkgo"
    assert rec["refine_passes"] >= 1
    assert rec["true_relres"] <= 1e-10
    assert rec["converged"] is True


def test_cli_devices_1_runs_mesh_path(ref_data_dir, capsys):
    """--devices 1 (explicitly given) must run the full shard_map mesh
    plumbing, not the single-chip solver (VERDICT r2 item 1)."""
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "cg_ir", "--devices", "1",
               "--trials", "2", "--json", "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver"] == "cg_ir"
    assert rec["refine_passes"] >= 1       # DistributedCgIr's record
    assert rec["strategy"] in ("halo", "all_gather")
    assert rec["true_relres"] <= 1e-9


def test_cli_devices_passes_ordering(ref_data_dir, capsys):
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "cg", "--devices", "2",
               "--ordering", "rcm", "--precision", "fp64",
               "--rtol", "1e-6", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ordering"] == "rcm"
    assert rec["true_relres"] <= 1e-5


# ------------------------------- 2-D partition IR family (round 5)

def test_dist_cg_ir2d_reaches_direct_tolerance(A, mesh):
    from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr2d
    from lsbench_tpu.parallel.mesh import make_mesh_2d
    b = np.arange(A.nrows, dtype=np.float64)
    s = DistributedCgIr2d(A, make_mesh_2d(2, 4), rtol=1e-10)
    res = s.solve(b)
    assert res.converged
    assert res.extra["refine_passes"] >= 2
    assert _true_relres(A, res.x, b) <= 1e-10


def test_dist_cg_ir2d_matches_1d(A, mesh):
    from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr2d
    from lsbench_tpu.parallel.mesh import make_mesh_2d
    b = np.arange(A.nrows, dtype=np.float64)
    x1 = np.asarray(DistributedCgIr(A, mesh, rtol=1e-10).solve(b).x)
    x2 = np.asarray(DistributedCgIr2d(A, make_mesh_2d(2, 4),
                                      rtol=1e-10).solve(b).x)
    # Both sit at true 1e-10 of the same system.
    np.testing.assert_allclose(x2, x1, rtol=1e-7, atol=1e-7)


def test_dist_gmres_bicgstab_ir2d(A, mesh):
    from lsbench_tpu.parallel.dist_cg_ir import (DistributedBicgstabIr2d,
                                                 DistributedGmresIr2d)
    from lsbench_tpu.parallel.mesh import make_mesh_2d
    b = np.arange(A.nrows, dtype=np.float64)
    m2 = make_mesh_2d(2, 4)
    for cls in (DistributedBicgstabIr2d, DistributedGmresIr2d):
        res = cls(A, m2, rtol=1e-10).solve(b)
        assert res.converged, cls.name
        assert _true_relres(A, res.x, b) <= 1e-10


def test_cli_cg_fp32_ir_over_2d_mesh(ref_data_dir, capsys):
    """`--solver cg --precision fp32_ir --mesh 2x4` (VERDICT r4
    missing 3: this exact invocation was rejected)."""
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "cg", "--precision",
               "fp32_ir", "--rtol", "1e-10", "--devices", "8",
               "--mesh", "2x4", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["refine_passes"] >= 1
    assert rec["true_relres"] <= 1e-10
    assert rec["converged"] is True


def test_cli_gmres_fp32_ir_over_2d_mesh(ref_data_dir, capsys):
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "gmres", "--precision",
               "fp32_ir", "--rtol", "1e-8", "--devices", "8",
               "--mesh", "2x4", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["true_relres"] <= 1e-8
