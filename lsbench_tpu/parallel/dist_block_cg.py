"""Distributed multi-RHS (block) CG: A X = B over a block-row mesh.

`--nrhs k --devices N` composing: the k RHS columns ride the SAME matrix
stream as a single SpMV — the halo exchange moves (H, k) boundary rows
(ppermute), the local SpMM is one ELL gather-multiply-reduce over k
columns (parallel/dist_spmv.py::halo_spmm_ell_local), so effective nnz/s
scales with k for the same matrix traffic per device.

The iteration is the simultaneous-column PCG (per-column alpha/beta,
converged columns frozen by masking — solvers/block_cg.py's fallback
method), NOT the shared-subspace BCGrQ: the shared method's
orthonormalization is a Householder QR, which has no shard_map
decomposition (CholQR would psum the Gram matrix cleanly but is the
variant measured to break at rank collapse). Simultaneous needs more
block iterations, but each is one SpMM + two fused (k,)-vector psums.

Precision structure: f32 inner block CG + f64 per-column residual
refinement (one f64 SpMM per PASS), reaching direct tolerance 1e-10.
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
from lsbench_tpu.parallel.perm import resolve_dist_ordering
from lsbench_tpu.solvers.base import SolveResult, Solver


class DistributedBlockCg(Solver):
    """Simultaneous-column block PCG over a row mesh, f32 + f64 refine."""

    name = "dist_block_cg"

    def __init__(self, A: CsrMatrix, mesh: Mesh, nrhs: int, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6,
                 ordering="none", strategy="auto", local_spmv="auto",
                 row_align: int = 8, dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # fixed structure: f32 SpMM inner / f64 outer
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.nrhs = int(nrhs)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self.n = A.nrows

        dm32 = build_dist_matvec(A, mesh, jnp.float32, strategy=strategy,
                                 local_spmv=local_spmv, row_align=row_align)
        dm64 = build_dist_matvec(A, mesh, jnp.float64, strategy=dm32.strategy,
                                 local_spmv=dm32.local_spmv,
                                 row_align=row_align)
        assert dm32.n_pad == dm64.n_pad
        self.strategy = dm32.strategy
        self.local_spmv = dm32.local_spmv
        self.plan = dm32.plan
        self.n_pad = dm32.n_pad

        blk_shard = NamedSharding(mesh, P(ROWS, None))
        self.blk_shard = blk_shard

        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=jnp.float32),
                                  NamedSharding(mesh, P(ROWS)))

        rtol_c, inner_rtol_c = self.rtol, self.inner_rtol
        maxiter_c, max_refine_c = self.maxiter, self.max_refine
        mm32_local, mm64_local = dm32.matmat, dm64.matmat
        n32 = len(dm32.op_specs)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*dm32.op_specs, *dm64.op_specs, P(ROWS),
                           P(ROWS, None)),
                 out_specs=(P(ROWS, None), P(None), P(None), P(), P()))
        def _solve(*args):
            op32_l = tuple(args[:n32])
            op64_l = tuple(args[n32:-2])
            invd_l, B_l = args[-2:]

            def cdots_psum(*pairs):
                """Fused per-column dots: each pair (u,v) -> psum (k,)."""
                local = jnp.stack([jnp.einsum(
                    "nk,nk->k", u, v, precision=jax.lax.Precision.HIGHEST)
                    for u, v in pairs])
                s = jax.lax.psum(local, ROWS)
                return tuple(s[i] for i in range(len(pairs)))

            def block_cg_inner(R32_l):
                """Simultaneous per-column f32 PCG to inner_rtol."""
                (bn2,) = cdots_psum((R32_l, R32_l))
                tol2 = jnp.asarray(inner_rtol_c**2, jnp.float32) * bn2
                X0 = jnp.zeros_like(R32_l)
                Z0 = invd_l[:, None] * R32_l
                rz0, rr0 = cdots_psum((R32_l, Z0), (R32_l, R32_l))

                def cond(s):
                    *_, rr, it = s
                    return jnp.logical_and(it < maxiter_c,
                                           jnp.any(rr > tol2))

                def body(s):
                    X, R, Pb, rz, rr, it = s
                    active = rr > tol2
                    Q = mm32_local(op32_l, Pb)
                    (pq,) = cdots_psum((Pb, Q))
                    safe_pq = jnp.where(pq != 0, pq, 1.0)
                    alpha = jnp.where(active, rz / safe_pq, 0.0)
                    X = X + Pb * alpha[None, :]
                    R = R - Q * alpha[None, :]
                    Z = invd_l[:, None] * R
                    rz_new, rr_new = cdots_psum((R, Z), (R, R))
                    safe_rz = jnp.where(rz != 0, rz, 1.0)
                    beta = jnp.where(active, rz_new / safe_rz, 0.0)
                    Pb = Z + Pb * beta[None, :]
                    return (X, R, Pb, rz_new, rr_new, it + 1)

                X, R, Pb, rz, rr, it = jax.lax.while_loop(
                    cond, body, (X0, R32_l, Z0, rz0, rr0, jnp.int32(0)))
                return X, it

            B_l = B_l.astype(jnp.float64)
            (bn2,) = cdots_psum((B_l, B_l))
            tol2 = (rtol_c**2) * bn2

            def refine_cond(s):
                X, R, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c,
                                       jnp.any(rr > tol2))

            def refine_body(s):
                X, R, rr, it_total, passes = s
                scale = jnp.sqrt(rr)                                # (k,)
                safe = jnp.where(scale > 0, scale, 1.0)
                R32 = (R.astype(jnp.float32)
                       * (1.0 / safe).astype(jnp.float32)[None, :])
                D32, inner_iters = block_cg_inner(R32)
                D32 = jnp.where(jnp.isfinite(D32), D32, 0.0)
                X = X + (D32 * safe.astype(jnp.float32)[None, :]
                         ).astype(jnp.float64)
                R_new = B_l - mm64_local(op64_l, X)
                (rr_new,) = cdots_psum((R_new, R_new))
                return (X, R_new, rr_new, it_total + inner_iters,
                        passes + 1)

            X0 = jnp.zeros_like(B_l)
            X, R, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (X0, B_l, bn2, jnp.int32(0), jnp.int32(0)))
            return X, jnp.sqrt(rr), jnp.sqrt(bn2), iters, passes

        self._op_args = (*dm32.op_args, *dm64.op_args, inv_diag)
        self._jit_solve = jax.jit(_solve)

    def _pad_b(self, B):
        B = np.asarray(self._ord.permute_b(B), dtype=np.float64)
        if B.ndim == 1:
            B = B[:, None]
        if B.shape != (self.n, self.nrhs):
            raise ValueError(f"B has shape {B.shape}, expected "
                             f"({self.n}, {self.nrhs})")
        Bp = jnp.zeros((self.n_pad, self.nrhs), jnp.float64
                       ).at[: self.n].set(jnp.asarray(B))
        return jax.device_put(Bp, self.blk_shard)

    def solve(self, B) -> SolveResult:
        squeeze = np.asarray(B).ndim == 1
        X, rnorm, bnorm, iters, passes = self._jit_solve(
            *self._op_args, self._pad_b(B))
        rnorm = np.asarray(rnorm)
        bnorm = np.asarray(bnorm)
        relres_cols = np.where(bnorm > 0, rnorm / np.maximum(bnorm, 1e-300),
                               0.0)
        relres = float(relres_cols.max())
        X_host = self._ord.unpermute_x(fetch_global(X, self.n))
        x = X_host[:, 0] if squeeze else X_host
        true_rel = self.true_relres(x, B)
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"refine_passes": int(passes),
                                  "nrhs": self.nrhs,
                                  "method": "simultaneous",
                                  "relres_cols": relres_cols.tolist(),
                                  "strategy": self.strategy,
                                  "local_spmv": self.local_spmv,
                                  "halo": self.plan.halo,
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir"})

    def solve_fn(self):
        op_args = self._op_args
        jit_solve = self._jit_solve
        pad = self._pad_b
        return lambda B: jit_solve(*op_args, pad(B))[0]
