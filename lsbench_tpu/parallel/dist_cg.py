"""Distributed (block-row partitioned) preconditioned CG via shard_map.

The replacement for the reference's non-existent multi-device
path (SURVEY.md §2.2): the matrix is partitioned by contiguous row blocks
over a 1-D mesh; vectors are row-sharded. Per iteration:

- search-direction exchange: either a halo `ppermute` ring (O(H) per
  device, banded matrices — parallel/dist_spmv.py) or an `all_gather`
  (O(n), any structure),
- local padded-row SpMV on the owned block,
- ONE fused `psum` for the scalar reductions.

Padded rows are zero so they contribute nothing to dots.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import (build_dist_matvec,
                                            force_global_cols, fused_psum)
from lsbench_tpu.parallel.mesh import ROWS, fetch_global
from lsbench_tpu.solvers.base import SolveResult, Solver

# Back-compat name (dist_gmres/dist_bicgstab used to import it from here).
_force_global_cols = force_global_cols


class DistributedCg(Solver):
    """CG over a row mesh. Usable single-host (many chips) or CPU-simulated."""

    name = "dist_cg"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-8, maxiter=None, strategy="auto", row_align: int = 8,
                 precond: str = "jacobi", block_size: int = 16,
                 local_spmv: str = "auto", ordering: str = "none", **params):
        super().__init__(A, **params)
        # Host-side symmetric reordering (cusparse.c:66-96 role): densifies
        # the band, shrinking the halo.
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        n_dev = mesh.devices.size

        dm = build_dist_matvec(A, mesh, self.dtype, strategy=strategy,
                               local_spmv=local_spmv, row_align=row_align)
        self.strategy = dm.strategy
        self.plan = dm.plan
        self.local_spmv = dm.local_spmv
        self.n = A.nrows
        self.n_pad = dm.n_pad
        plan = dm.plan
        op_args, op_specs = dm.op_args, dm.op_specs

        vec_shard = NamedSharding(mesh, P(ROWS))
        self.vec_shard = vec_shard

        # Preconditioner, padded+sharded. "jacobi": pointwise 1/diag.
        # "block_jacobi": dense diagonal blocks inverted at setup — blocks
        # never cross shard boundaries (block_size divides nloc, a multiple
        # of row_align), so the apply is purely local (no collective).
        self.precond = precond
        if precond == "block_jacobi":
            k = int(block_size)
            while plan.nloc % k:
                k //= 2  # row_align=8 guarantees k ∈ {8,4,2,1} divides nloc
            nb = self.n_pad // k
            blocks = np.zeros((nb, k, k))
            blocks[:, np.arange(k), np.arange(k)] = 1.0
            r_, c_, v_ = A.to_coo()
            same = (r_ // k) == (c_ // k)
            rb, cb_, vb = r_[same], c_[same], v_[same]
            blocks[rb // k, rb % k, cb_ % k] = vb
            pstate = jax.device_put(
                jnp.asarray(np.linalg.inv(blocks), dtype=self.dtype),
                NamedSharding(mesh, P(ROWS, None, None)))
            pspec = P(ROWS, None, None)

            def papply(pstate_l, r_vec):
                z = jnp.einsum("bij,bj->bi", pstate_l,
                               r_vec.reshape(pstate_l.shape[0], k),
                               precision=jax.lax.Precision.HIGHEST)
                return z.reshape(-1)
        elif precond == "jacobi":
            d = np.ones(self.n_pad)
            diag = A.diagonal()
            d[: self.n] = np.where(diag != 0.0, diag, 1.0)
            pstate = jax.device_put(jnp.asarray(1.0 / d, dtype=self.dtype),
                                    vec_shard)
            pspec = P(ROWS)

            def papply(pstate_l, r_vec):
                return pstate_l * r_vec
        else:
            raise ValueError(f"unknown distributed preconditioner '{precond}'"
                             " (jacobi | block_jacobi)")

        rtol_c, maxiter_c = self.rtol, self.maxiter
        local_matvec = dm.matvec

        @partial(shard_map, mesh=mesh,
                 in_specs=(*op_specs, pspec, P(ROWS)),
                 out_specs=(P(ROWS), P(), P()))
        def _cg(*args):
            *op_l, inv_diag_l, b_l = args


            def matvec(p_l):
                return local_matvec(tuple(op_l), p_l)

            (bb,) = fused_psum(jnp.vdot(b_l, b_l))
            tol2 = (rtol_c ** 2) * bb

            x0 = jnp.zeros_like(b_l)
            r0 = b_l
            z0 = papply(inv_diag_l, r0)
            p0 = z0
            rz0, rr0 = fused_psum(jnp.vdot(r0, z0), jnp.vdot(r0, r0))

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, rz, rr, it = s
                Ap = matvec(p)
                (pAp,) = fused_psum(jnp.vdot(p, Ap))
                alpha = rz / pAp
                x = x + alpha * p
                r = r - alpha * Ap
                z = papply(inv_diag_l, r)
                rz_new, rr_new = fused_psum(jnp.vdot(r, z), jnp.vdot(r, r))
                beta = rz_new / rz
                p = z + beta * p
                return (x, r, p, rz_new, rr_new, it + 1)

            x, r, p, rz, rr, it = jax.lax.while_loop(
                cond, body, (x0, r0, p0, rz0, rr0, jnp.int32(0)))
            return x, jnp.sqrt(rr / jnp.where(bb > 0, bb, 1.0)), it

        self._op_args, self._inv_diag = op_args, pstate
        self._jit_cg = jax.jit(_cg)

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=self.dtype)
        if b.shape[0] != self.n:
            raise ValueError(f"b has {b.shape[0]} entries, expected {self.n}")
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, relres, iters = self._jit_cg(*self._op_args,
                                        self._inv_diag, self._pad_b(b))
        relres = float(relres)
        # Slice padding off on host (x is row-sharded; device slicing across
        # shard boundaries would need a resharding collective).
        x_host = self._ord.unpermute_x(fetch_global(x, self.n))
        # Honest convergence: judge against the host fp64 TRUE residual,
        # not the (possibly f32) recurrence.
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"strategy": self.strategy,
                                  "local_spmv": self.local_spmv,
                                  "halo": self.plan.halo,
                                  "true_relres": true_rel})

    def solve_fn(self):
        op_args, inv_diag = self._op_args, self._inv_diag
        jit_cg = self._jit_cg
        pad = self._pad_b
        return lambda b: jit_cg(*op_args, inv_diag, pad(b))[0]


