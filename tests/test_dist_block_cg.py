"""Distributed multi-RHS: --nrhs × --devices composing. The k RHS
columns share one halo exchange and one matrix pass per iteration
(parallel/dist_spmv.py::halo_spmm_ell_local)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import make_rhs
from lsbench_tpu.matrix.generate import poisson_2d
from lsbench_tpu.matrix.io import read_matrix
from lsbench_tpu.parallel.dist_block_cg import DistributedBlockCg
from lsbench_tpu.parallel.mesh import ROWS, make_row_mesh


pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs multi-device mesh")


def _block_rhs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([np.arange(n, dtype=np.float64)]
                           + [rng.standard_normal(n) for _ in range(k - 1)])


def test_dist_spmm_ell_matches_host():
    """Raw distributed halo SpMM vs the host product."""
    from lsbench_tpu.parallel.dist_spmv import (build_halo_plan,
                                                halo_spmm_ell_local)
    A = poisson_2d(24)
    mesh = make_row_mesh()
    k = 4
    plan = build_halo_plan(A, mesh.devices.size, jnp.float64)
    assert not plan.needs_all_gather

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROWS, None), P(ROWS, None), P(ROWS, None)),
             out_specs=P(ROWS, None))
    def run(vals_l, cols_l, X_l):
        return halo_spmm_ell_local(plan.halo, vals_l, cols_l, X_l)

    X = np.random.default_rng(0).standard_normal((A.nrows, k))
    Xp = jnp.zeros((plan.n_pad, k)).at[: plan.n].set(jnp.asarray(X))
    Y = np.asarray(run(plan.vals, plan.cols,
                       jax.device_put(Xp, NamedSharding(mesh, P(ROWS, None))))
                   )[: plan.n]
    for j in range(k):
        np.testing.assert_allclose(Y[:, j], A.matvec(X[:, j]), rtol=1e-12)


def test_dist_block_cg_solves_all_columns(ref_data_dir):
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    mesh = make_row_mesh()
    k = 4
    B = _block_rhs(A.nrows, k)
    s = DistributedBlockCg(A, mesh, nrhs=k, rtol=1e-8, ordering="rcm")
    res = s.solve(B)
    assert res.extra["nrhs"] == k
    X = np.asarray(res.x, np.float64)
    for j in range(k):
        tr = (np.linalg.norm(B[:, j] - A.matvec(X[:, j]))
              / np.linalg.norm(B[:, j]))
        assert tr <= 1e-7, (j, tr)


def test_dist_block_cg_matches_single_chip_block_cg(ref_data_dir):
    """Same math as the single-chip simultaneous block CG: equal
    solutions at the solved tolerance."""
    from lsbench_tpu.solvers.block_cg import BlockCgSolver
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    k = 3
    B = _block_rhs(A.nrows, k, seed=2)
    dist = DistributedBlockCg(A, make_row_mesh(), nrhs=k, rtol=1e-8)
    single = BlockCgSolver(A, rtol=1e-8, method="simultaneous")
    Xd = np.asarray(dist.solve(B).x, np.float64)
    Xs = np.asarray(single.solve(B).x, np.float64)
    assert np.linalg.norm(Xd - Xs) / np.linalg.norm(Xs) < 1e-6


def test_cli_nrhs_devices_compose(ref_data_dir, capsys):
    import json

    from lsbench_tpu.harness.cli import main
    rc = main(["--matrix", str(ref_data_dir / "xn3b_A_18.txt"), "--solver", "cg", "--nrhs", "3",
               "--devices", "2", "--trials", "1", "--json",
               "--platform", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver"] == "block_cg"
    assert rec["nrhs"] == 3
    assert rec["true_relres"] <= 1e-7
