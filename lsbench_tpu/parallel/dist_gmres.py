"""Distributed restarted GMRES(m) over a block-row mesh.

Completes the distributed Krylov family (dist_cg.py, dist_amg.py). Same
math as the single-chip solver (solvers/gmres.py): CGS2 orthogonalization,
replicated (m+1, m) Hessenberg least-squares per restart. Distribution:

- the Arnoldi basis V lives row-sharded as (m+1, nloc) per device;
- each CGS pass is a local (m+1, nloc)·(nloc,) matmul + ONE `psum`
  (3 psums per inner step: two CGS passes + the new-vector norm);
- H is built from psum'd dots, so it is bitwise identical on every
  device; the small QR/triangular solve runs replicated — no gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import build_dist_matvec
from lsbench_tpu.parallel.mesh import ROWS, fetch_global
from lsbench_tpu.solvers.base import SolveResult, Solver

_HP = jax.lax.Precision.HIGHEST  # no TF32 for f32 Arnoldi products


class DistributedGmres(Solver):

    name = "dist_gmres"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-8, maxiter=None, restart=30, strategy="auto",
                 row_align: int = 8, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.restart = int(restart)
        maxiter = (int(maxiter) if maxiter is not None
                   else max(10 * A.nrows, 1000))
        self.max_restarts = max(1, -(-maxiter // self.restart))

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

        rtol_c, mr, m = self.rtol, self.max_restarts, self.restart
        dt = self.dtype
        eps_break = 1e-30
        local_matvec = dm.matvec

        @partial(shard_map, mesh=mesh,
                 in_specs=(*dm.op_specs, P(ROWS), P(ROWS)),
                 out_specs=(P(ROWS), P(), P(), P()))
        def _gmres(*args):
            *op_l, inv_diag_l, b_l = args
            nloc = b_l.shape[0]

            def matvec(p_l):
                return local_matvec(tuple(op_l), p_l)

            def precond(r_l):
                return inv_diag_l * r_l

            def pdot(a, b):
                return jax.lax.psum(jnp.vdot(a, b), ROWS)

            bb = pdot(b_l, b_l)
            bnorm = jnp.sqrt(bb)
            tol = rtol_c * bnorm

            def arnoldi_cycle(x_l):
                r_l = b_l - matvec(x_l)
                beta = jnp.sqrt(pdot(r_l, r_l))
                beta_safe = jnp.where(beta > 0, beta, 1.0)
                V0 = jnp.zeros((m + 1, nloc), dt).at[0].set(r_l / beta_safe)
                H0 = jnp.zeros((m + 1, m), dt)

                def step(j, carry):
                    V, H = carry
                    w = matvec(precond(V[j]))
                    mask = (jnp.arange(m + 1) <= j).astype(dt)
                    h1 = jax.lax.psum(jnp.matmul(V, w, precision=_HP),
                                      ROWS) * mask
                    w = w - jnp.matmul(V.T, h1, precision=_HP)
                    h2 = jax.lax.psum(jnp.matmul(V, w, precision=_HP),
                                      ROWS) * mask
                    w = w - jnp.matmul(V.T, h2, precision=_HP)
                    h = h1 + h2
                    hnext = jnp.sqrt(pdot(w, w))
                    V = V.at[j + 1].set(w / jnp.maximum(hnext, eps_break))
                    H = H.at[:, j].set(h.at[j + 1].set(hnext))
                    return (V, H)

                V, H = jax.lax.fori_loop(0, m, step, (V0, H0))
                # Replicated small least-squares (H identical on all shards).
                e1 = jnp.zeros(m + 1, dt).at[0].set(beta)
                q, rr = jnp.linalg.qr(H, mode="reduced")
                y = jax.scipy.linalg.solve_triangular(
                    rr + eps_break * jnp.eye(m, dtype=dt),
                    jnp.matmul(q.T, e1, precision=_HP),
                    lower=False)
                return x_l + precond(jnp.matmul(V[:m].T, y, precision=_HP))

            def cond(s):
                x, rn, it = s
                return jnp.logical_and(it < mr, rn > tol)

            def body(s):
                x, rn, it = s
                x = arnoldi_cycle(x)
                r = b_l - matvec(x)
                return (x, jnp.sqrt(pdot(r, r)), it + 1)

            x0 = jnp.zeros_like(b_l)
            x, rnorm, restarts = jax.lax.while_loop(
                cond, body, (x0, bnorm, jnp.int32(0)))
            return x, restarts * m, rnorm, bnorm

        self._op_args, self._inv_diag = dm.op_args, inv_diag
        self._jit = jax.jit(_gmres)

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=self.dtype)
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, iters, rnorm, bnorm = self._jit(*self._op_args,
                                           self._inv_diag, self._pad_b(b))
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
        args = (*self._op_args, self._inv_diag)
        jit, pad = self._jit, self._pad_b
        return lambda b: jit(*args, pad(b))[0]
