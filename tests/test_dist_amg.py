"""Distributed AMG on a simulated 8-device CPU mesh — golden equality vs
the single-device hierarchy (SURVEY.md §4 item 3)."""

import jax
import numpy as np
import pytest

from lsbench_tpu.matrix.generate import poisson_2d
from lsbench_tpu.parallel.dist_amg import DistributedAmg, DistributedAmgCg
from lsbench_tpu.parallel.mesh import make_row_mesh
from lsbench_tpu.solvers.base import get_solver

from conftest import make_rhs


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_row_mesh(8)


def test_dist_amg_converges_matches_single(mesh8):
    A = poisson_2d(13)  # n=169, not divisible by 8 → exercises padding
    b = make_rhs(A.nrows)
    dist = DistributedAmg(A, mesh8, rtol=1e-8, maxiter=60, coarse_n=32)
    res = dist.solve(b)
    assert res.converged, (res.iters, res.relres)

    cls, params = get_solver("amg")
    single = cls(A, rtol=1e-8, maxiter=60, coarse_n=32, **params)
    res1 = single.solve(b)
    # Same hierarchy + same cycle math → same iteration count and answer.
    assert abs(res.iters - res1.iters) <= 1
    np.testing.assert_allclose(res.x, np.asarray(res1.x), rtol=1e-6,
                               atol=1e-8)


def test_dist_amg_fixed_cycles(mesh8):
    # The hypre fixed-2-cycle protocol runs distributed too.
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    res = DistributedAmg(A, mesh8, cycles=2, coarse_n=32).solve(b)
    assert res.iters == 2
    assert 0 < res.relres < 1.0


def test_dist_amg_cg_matches_single(mesh8):
    A = poisson_2d(13)
    b = make_rhs(A.nrows)
    dist = DistributedAmgCg(A, mesh8, rtol=1e-10, coarse_n=32)
    res = dist.solve(b)
    assert res.converged
    np.testing.assert_allclose(
        res.x, np.linalg.solve(A.to_dense(), b), rtol=1e-6)

    cls, params = get_solver("cg")
    single = cls(A, rtol=1e-10, precond="amg",
                 precond_params=dict(coarse_n=32), **params)
    res1 = single.solve(b)
    assert abs(res.iters - res1.iters) <= 2


def test_dist_amg_classical_coarsening(mesh8):
    A = poisson_2d(13)
    b = make_rhs(A.nrows)
    res = DistributedAmgCg(A, mesh8, rtol=1e-10, coarsening="classical",
                           coarse_n=32).solve(b)
    assert res.converged
    np.testing.assert_allclose(
        res.x, np.linalg.solve(A.to_dense(), b), rtol=1e-6)


def test_dist_amg_cg_ir_reaches_direct_tolerance(ref_data_dir):
    """Mixed-precision distributed AMG-CG (f32 cycles + df64 refinement):
    true relres <= 1e-10 — the f32-cycle floor (~3e-5 true) removed."""
    import jax
    import pytest

    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.parallel.dist_amg import DistributedAmgCgIr
    from lsbench_tpu.parallel.mesh import make_row_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")

    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = np.arange(A.nrows, dtype=np.float64)
    s = DistributedAmgCgIr(A, make_row_mesh(8), rtol=1e-10,
                           coarsening="classical", theta=0.5,
                           interp="jacobi", interp_passes=3,
                           interp_omega=0.5, pmax=8)
    res = s.solve(b)
    assert res.converged
    assert res.extra["precision_mode"] == "fp32_ir_auto"
    tr = (np.linalg.norm(b - A.matvec(np.asarray(res.x, np.float64)))
          / np.linalg.norm(b))
    assert tr <= 1e-10, tr


def test_dist_f32_converged_implies_true_relres(ref_data_dir, mesh8):
    """Honest stopping (VERDICT r3 weak 6): `converged=True` must imply
    the fp64 TRUE residual meets rtol — an f32 recurrence can report
    ~30x better than truth. On the reference workload at rtol 1e-6, f32
    AMG-CG's recursive residual passes but the true one floors at ~1e-5:
    the solver must now report converged=False (and carry true_relres)."""
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = np.arange(A.nrows, dtype=np.float64)
    res = DistributedAmgCg(A, mesh8, rtol=1e-6, dtype="float32",
                           coarsening="classical", theta=0.5,
                           interp="jacobi", interp_passes=3,
                           interp_omega=0.5, pmax=8).solve(b)
    tr = res.extra["true_relres"]
    assert res.converged == (tr <= 1e-6)
    # The r3 defect scenario: recursive says yes, truth says no.
    if res.relres <= 1e-6 < tr:
        assert not res.converged

    # The invariant holds for the other dist families too (f32 CG).
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    res2 = DistributedCg(A, mesh8, rtol=1e-7, dtype="float32",
                         maxiter=4000).solve(b)
    assert res2.converged == (res2.extra["true_relres"] <= 1e-7)


def test_cli_dist_amg_cg_ir_route(ref_data_dir, capsys):
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"),
               "--solver", "cg_ir", "--precond", "amg_classical",
               "--devices", "2", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["refine_passes"] >= 1
    assert rec["true_relres"] <= 1e-9


def test_dist_kcycle_converges_and_beats_vcycle_iters():
    # The distributed K-cycle (paralmond role, VERDICT r4 missing 5):
    # FCG-accelerated coarse correction converges in fewer cycles than
    # the V-cycle on the same hierarchy.
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    import jax.numpy as jnp

    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_amg import DistributedAmg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    A = poisson_2d(48)
    b = np.arange(A.nrows, dtype=np.float64)
    mesh = make_row_mesh(8)
    it = {}
    for cyc in ("v", "k"):
        res = DistributedAmg(A, mesh, dtype=jnp.float64, cycle=cyc,
                             rtol=1e-8, coarsening="sa").solve(b)
        assert res.converged, cyc
        assert res.extra["true_relres"] <= 1e-8
        it[cyc] = res.iters
    assert it["k"] <= it["v"]


def test_cli_paralmond_devices(ref_data_dir, tmp_path, capsys):
    # `--solver paralmond --devices N` now runs the K-cycle protocol
    # distributed (the "cycle" preset is no longer excluded).
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"),
               "--solver", "paralmond", "--devices", "2",
               "--trials", "1", "--json", "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver"] == "paralmond"
    assert rec["iters"] == 1               # single K-cycle application


@pytest.mark.parametrize("solver", ["hypre", "paralmond"])
def test_cli_amg_devices_match_single_device(ref_data_dir, tmp_path, solver):
    """`--devices N` builds the single-device hierarchy (same ordering,
    same coarse size), so the fixed-cycle result agrees to rounding."""
    from lsbench_tpu.harness.cli import main
    m = str(ref_data_dir / "xn3b_A_10.txt")
    xs = []
    for dev in (["--devices", "4"], []):
        f = tmp_path / f"x{len(dev)}.npy"
        assert main(["--matrix", m, "--solver", solver, "--trials", "1",
                     "--warmups", "0", "--save-x", str(f), *dev,
                     "--platform", "cpu"]) == 0
        xs.append(np.load(f))
    assert np.linalg.norm(xs[0] - xs[1]) <= 1e-10 * np.linalg.norm(xs[1])
