"""Distributed BiCGSTAB over a block-row mesh — the Ginkgo role, sharded.

Same recurrence as solvers/bicgstab.py (implicit-residual stop at
rtol × initial, ginkgo.cpp:55-64) with the dist_cg.py distribution: ELL
block rows + all_gather matvec, Jacobi preconditioner, and the scalar
reductions fused — two psums per iteration (rho+rr batched with the
previous iteration's tail where the recurrence allows; here: one psum for
(rho, rr) and one each for r0·v and (t·t, t·s))."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import (build_dist_matvec,
                                            fused_psum)
from lsbench_tpu.parallel.mesh import ROWS, fetch_global
from lsbench_tpu.solvers.base import SolveResult, Solver


class DistributedBicgstab(Solver):

    name = "dist_bicgstab"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-4, maxiter=None, strategy="auto",
                 row_align: int = 8, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))

        dm = build_dist_matvec(A, mesh, self.dtype, strategy=strategy,
                               local_spmv=local_spmv, row_align=row_align)
        self.strategy = dm.strategy
        self.local_spmv = dm.local_spmv
        self.n = A.nrows
        self.n_pad = dm.n_pad

        vec_shard = NamedSharding(mesh, P(ROWS))
        self.vec_shard = vec_shard
        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=self.dtype),
                                  vec_shard)

        rtol_c, maxiter_c = self.rtol, self.maxiter
        dt = self.dtype
        local_matvec = dm.matvec

        @partial(shard_map, mesh=mesh,
                 in_specs=(*dm.op_specs, P(ROWS), P(ROWS)),
                 out_specs=(P(ROWS), P(), P(), P()))
        def _run(*args):
            *op_l, inv_diag_l, b_l = args

            def matvec(p_l):
                return local_matvec(tuple(op_l), p_l)


            r0 = b_l
            (r0n2,) = fused_psum(jnp.vdot(r0, r0))
            tol2 = (rtol_c ** 2) * r0n2
            one = jnp.asarray(1.0, dt)
            init = (jnp.zeros_like(b_l), r0, jnp.zeros_like(b_l),
                    jnp.zeros_like(b_l), one, one, one, r0n2, jnp.int32(0))

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, v, rho, alpha, omega, rr, it = s
                (rho_new,) = fused_psum(jnp.vdot(r0, r))
                beta = (rho_new / rho) * (alpha / omega)
                p = r + beta * (p - omega * v)
                ph = inv_diag_l * p
                v = matvec(ph)
                (r0v,) = fused_psum(jnp.vdot(r0, v))
                alpha = rho_new / r0v
                sv = r - alpha * v
                sh = inv_diag_l * sv
                t = matvec(sh)
                tt, ts = fused_psum(jnp.vdot(t, t), jnp.vdot(t, sv))
                omega = jnp.where(tt > 0, ts / tt, jnp.zeros_like(tt))
                x = x + alpha * ph + omega * sh
                r = sv - omega * t
                (rr_new,) = fused_psum(jnp.vdot(r, r))
                return (x, r, p, v, rho_new, alpha, omega, rr_new, it + 1)

            x, r, p, v, rho, alpha, omega, rr, it = jax.lax.while_loop(
                cond, body, init)
            return x, jnp.sqrt(rr), jnp.sqrt(r0n2), it

        self._args = (*dm.op_args, inv_diag)
        self._jit = jax.jit(_run)

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=self.dtype)
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters = self._jit(*self._args, self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = self._ord.unpermute_x(fetch_global(x, self.n))
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters),
                           relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"strategy": self.strategy,
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel})

    def solve_fn(self):
        args, jit, pad = self._args, self._jit, self._pad_b
        return lambda b: jit(*args, pad(b))[0]
