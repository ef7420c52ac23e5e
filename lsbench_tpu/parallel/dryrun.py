"""Multi-chip dry run: compile + execute one full distributed solve step
on tiny shapes over an n-device mesh (driver validation hook)."""

from __future__ import annotations

import numpy as np

import jax


def run_dryrun(n_devices: int) -> None:
    import jax.numpy as jnp

    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_amg import DistributedAmgCg
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh

    mesh = make_row_mesh(n_devices)
    A = poisson_2d(8 * max(1, int(np.sqrt(n_devices))))  # tiny but shardable
    b = np.arange(A.nrows, dtype=np.float64)

    # Jacobi-CG: halo/all_gather SpMV + fused-psum iteration.
    solver = DistributedCg(A, mesh, dtype=jnp.float64, rtol=1e-10)
    res = solver.solve(b)
    x = np.asarray(res.x)
    r = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert res.converged and r < 1e-8, (res.iters, res.relres, r)
    jax.block_until_ready(res.x)

    # Flagship: AMG-preconditioned CG — every level row-sharded, V-cycle
    # matvec gathers + one fused psum per iteration.
    amgcg = DistributedAmgCg(A, mesh, dtype=jnp.float64, rtol=1e-10,
                             coarse_n=16, max_levels=3)
    res2 = amgcg.solve(b)
    x2 = np.asarray(res2.x)
    r2 = np.linalg.norm(b - A.matvec(x2)) / np.linalg.norm(b)
    assert res2.converged and r2 < 1e-8, (res2.iters, res2.relres, r2)

    # Distributed GMRES + BiCGSTAB.
    from lsbench_tpu.parallel.dist_bicgstab import DistributedBicgstab
    from lsbench_tpu.parallel.dist_gmres import DistributedGmres
    res_g = DistributedGmres(A, mesh, dtype=jnp.float64, rtol=1e-8,
                             restart=20).solve(b)
    xg = np.asarray(res_g.x)
    rg = np.linalg.norm(b - A.matvec(xg)) / np.linalg.norm(b)
    assert res_g.converged and rg < 1e-6, (res_g.iters, res_g.relres, rg)
    res_s = DistributedBicgstab(A, mesh, dtype=jnp.float64,
                                rtol=1e-6).solve(b)
    xs = np.asarray(res_s.x)
    rs = np.linalg.norm(b - A.matvec(xs)) / np.linalg.norm(b)
    assert res_s.converged and rs < 1e-4, (res_s.iters, res_s.relres, rs)

    # Standalone DistributedAmg fixed-cycle (hypre maxiter=2 protocol).
    from lsbench_tpu.parallel.dist_amg import DistributedAmg
    amg_fixed = DistributedAmg(A, mesh, dtype=jnp.float64, cycles=2,
                               coarse_n=16, max_levels=3)
    res_f = amg_fixed.solve(b)
    assert res_f.iters == 2 and np.isfinite(res_f.relres), (
        res_f.iters, res_f.relres)

    # Distributed K-cycle (the parAlmond protocol over the mesh — FCG
    # coarse correction with fused psums per level, round 5).
    amg_k = DistributedAmg(A, mesh, dtype=jnp.float64, cycles=1,
                           cycle="k", coarse_n=16, max_levels=3)
    res_k1 = amg_k.solve(b)
    assert res_k1.iters == 1 and np.isfinite(res_k1.relres), (
        res_k1.iters, res_k1.relres)

    # Distributed mixed-precision CG (f32 inner + f64 refinement).
    from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr
    res_ir = DistributedCgIr(A, mesh, rtol=1e-8).solve(b)
    xir = np.asarray(res_ir.x)
    rir = np.linalg.norm(b - A.matvec(xir)) / np.linalg.norm(b)
    assert rir < 1e-7, (res_ir.iters, res_ir.relres, rir)

    # Distributed mixed-precision BiCGSTAB + GMRES (f32 inner + f64
    # refinement): the ginkgo-role and gmres-role fp32_ir routes.
    from lsbench_tpu.parallel.dist_cg_ir import (DistributedBicgstabIr,
                                                 DistributedGmresIr)
    res_bir = DistributedBicgstabIr(A, mesh, rtol=1e-8).solve(b)
    rbir = (np.linalg.norm(b - A.matvec(np.asarray(res_bir.x)))
            / np.linalg.norm(b))
    assert rbir < 1e-7, (res_bir.iters, res_bir.relres, rbir)
    res_gir = DistributedGmresIr(A, mesh, rtol=1e-8, restart=20).solve(b)
    rgir = (np.linalg.norm(b - A.matvec(np.asarray(res_gir.x)))
            / np.linalg.norm(b))
    assert rgir < 1e-7, (res_gir.iters, res_gir.relres, rgir)

    # Distributed multi-RHS: k RHS through one halo exchange + one
    # matrix pass per iteration (--nrhs x --devices composing).
    from lsbench_tpu.parallel.dist_block_cg import DistributedBlockCg
    k = 3
    rng = np.random.default_rng(0)
    B = np.column_stack([b] + [rng.standard_normal(A.nrows)
                               for _ in range(k - 1)])
    res_k = DistributedBlockCg(A, mesh, nrhs=k, rtol=1e-6).solve(B)
    Xk = np.asarray(res_k.x)
    for j in range(k):
        rk = (np.linalg.norm(B[:, j] - A.matvec(Xk[:, j]))
              / np.linalg.norm(B[:, j]))
        assert rk < 1e-4, (j, res_k.iters, rk)

    # 2-D block partition (all_gather over rows + psum_scatter over cols).
    if n_devices % 2 == 0 and n_devices >= 4:
        from lsbench_tpu.parallel.dist2d import (DistributedBlockCg2d,
                                                 DistributedCg2d)
        from lsbench_tpu.parallel.mesh import make_mesh_2d
        mesh2 = make_mesh_2d(2, n_devices // 2)
        res3 = DistributedCg2d(A, mesh2, dtype=jnp.float64,
                               rtol=1e-10).solve(b)
        x3 = np.asarray(res3.x)
        r3 = np.linalg.norm(b - A.matvec(x3)) / np.linalg.norm(b)
        assert res3.converged and r3 < 1e-8, (res3.iters, res3.relres, r3)

        # 2-D AMG-preconditioned CG: the fully 2-D-sharded hierarchy
        # (A/P/R per level as rectangular 2-D operators).
        from lsbench_tpu.parallel.dist_amg2d import DistributedAmgCg2d
        res4 = DistributedAmgCg2d(A, mesh2, dtype=jnp.float64, rtol=1e-8,
                                  coarse_n=16, max_levels=3).solve(b)
        r4 = (np.linalg.norm(b - A.matvec(np.asarray(res4.x)))
              / np.linalg.norm(b))
        assert res4.converged and r4 < 1e-7, (res4.iters, res4.relres, r4)

        # 2-D mixed-precision CG-IR (f32 inner on the 2-D schedule +
        # f64 per-pass residual — `--precision fp32_ir --mesh RxC`).
        from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr2d
        res6 = DistributedCgIr2d(A, mesh2, rtol=1e-8).solve(b)
        r6 = (np.linalg.norm(b - A.matvec(np.asarray(res6.x)))
              / np.linalg.norm(b))
        assert r6 < 1e-7, (res6.iters, res6.relres, r6)

        # 2-D multi-RHS block CG (--nrhs k x --mesh RxC composition).
        rng2 = np.random.default_rng(1)
        B2 = np.column_stack([b, rng2.standard_normal(A.nrows)])
        res5 = DistributedBlockCg2d(A, mesh2, nrhs=2, rtol=1e-6).solve(B2)
        X5 = np.asarray(res5.x)
        for j in range(2):
            r5 = (np.linalg.norm(B2[:, j] - A.matvec(X5[:, j]))
                  / np.linalg.norm(B2[:, j]))
            assert r5 < 1e-4, (j, res5.iters, r5)
