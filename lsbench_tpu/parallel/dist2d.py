"""2-D block-partitioned distributed SpMV and CG.

The 1-D block-row partition (parallel/dist_spmv.py) moves O(n) per device
per matvec on its all_gather path; this is the very-large-matrix scheme
SURVEY.md §5 calls for — a 2-D (rows × cols) mesh where each matvec costs
O(n/Pc) inbound + O(n/Pr) outbound per device (2n/√P on a square mesh):

- the global vector lives in P = Pr·Pc row-major chunks of `csize`
  entries, chunk c on device (c // Pc, c mod Pc) — spec P(("rows","cols"));
- device (i,j) owns row block i (Pc consecutive chunks of rows) × the
  columns whose chunks are ≡ j (mod Pc);
- matvec: `all_gather` over the ROWS axis delivers exactly device (i,j)'s
  column set (chunks j, Pc+j, 2Pc+j, … concatenated in order — column ids
  are remapped to this gathered coordinate system at setup), a local
  padded-row (ELL) SpMV produces the row-block partial, and ONE
  `psum_scatter` over the COLS axis both reduces the Pc partials and
  scatters the result straight back into the vector layout.

No reshuffle collective is needed between iterations because the
reduce-scatter's natural output placement (piece j of row block i =
global chunk i·Pc+j) IS the vector sharding.

The reference has no distributed path at all (its MPI is split into
self-communicators, paralmond.cpp:94-102; SURVEY.md §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import check_local_spmv, fused_psum
from lsbench_tpu.parallel.mesh import COLS, ROWS
from lsbench_tpu.solvers.base import SolveResult, Solver


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class Spmv2dPlan:
    """Host-built plan: (Pr, Pc, rloc, k) ELL blocks with gathered-frame
    column ids. Rectangular operators (AMG's P/R) chunk rows by `csize`
    (the OUTPUT vector layout) and columns by `csize_in` (the INPUT
    vector layout); square operators use one chunk size for both."""
    vals: jax.Array      # (Pr, Pc, rloc, k)
    cols: jax.Array      # (Pr, Pc, rloc, k) int32 into the gathered vector
    n: int
    n_pad: int           # P * csize
    csize: int           # output-vector chunk per device
    rloc: int            # rows per device row-block (= Pc * csize)
    pr: int
    pc: int
    csize_in: int = 0    # input-vector chunk (== csize when square)
    n_gath: int = 0      # Pr * csize_in (gathered x width per device)


def build_2d_plan(A: CsrMatrix, pr: int, pc: int, dtype,
                  align: int = 8, csize_r: int | None = None,
                  csize_c: int | None = None) -> Spmv2dPlan:
    n = A.nrows
    P_ = pr * pc
    if csize_r is None:
        csize_r = _round_up(-(-n // P_), align)
    if csize_c is None:
        csize_c = (csize_r if A.ncols == A.nrows
                   else _round_up(-(-A.ncols // P_), align))
    csize = csize_r
    n_pad = csize * P_
    rloc = csize * pc

    r, c, v = A.to_coo()
    i_dev = r // rloc
    q = c // csize_c                     # global chunk of the column
    j_dev = q % pc
    lrow = r % rloc
    # Gathered frame on device column j: chunks (j, pc+j, 2pc+j, …) in order.
    lcol = (q // pc) * csize_c + (c % csize_c)

    # Slot within each (device, local row) group.
    group = (i_dev * pc + j_dev) * rloc + lrow
    order = np.argsort(group, kind="stable")
    g_sorted = group[order]
    counts = np.bincount(g_sorted, minlength=P_ * rloc)
    k = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(r.size) - starts[g_sorted]

    vals = np.zeros((pr, pc, rloc, k), dtype=np.float64)
    cols = np.zeros((pr, pc, rloc, k), dtype=np.int32)
    gi = g_sorted
    vals[gi // (pc * rloc), (gi // rloc) % pc, gi % rloc, slot] = v[order]
    cols[gi // (pc * rloc), (gi // rloc) % pc, gi % rloc, slot] = lcol[order]

    return Spmv2dPlan(vals=jnp.asarray(vals, dtype=dtype),
                      cols=jnp.asarray(cols), n=n, n_pad=n_pad,
                      csize=csize, rloc=rloc, pr=pr, pc=pc,
                      csize_in=csize_c, n_gath=pr * csize_c)


def spmv_2d_local(vals_l, cols_l, x_l):
    """Inside shard_map over a (ROWS, COLS) mesh: one 2-D matvec.

    vals_l/cols_l: (rloc, k) local block; x_l: (csize,) local chunk.
    Returns (csize,) local y chunk.
    """
    xg = jax.lax.all_gather(x_l, ROWS, tiled=True)   # this device's col set
    partial_y = jnp.sum(vals_l * xg[cols_l], axis=1)  # (rloc,)
    return jax.lax.psum_scatter(partial_y, COLS, scatter_dimension=0,
                                tiled=True)           # (csize,)


def build_2d_matvec(A: CsrMatrix, mesh: Mesh, dtype,
                    local_spmv: str = "auto"):
    """Build the sharded 2-D ELL operator — the 2-D twin of
    dist_spmv.build_dist_matvec. Returns (op_args, op_specs, matvec,
    local_spmv, plan) with `matvec(op_l, x_l)` valid inside shard_map
    over the (ROWS, COLS) mesh."""
    check_local_spmv(local_spmv)
    pr, pc = mesh.shape[ROWS], mesh.shape[COLS]
    dtype = jnp.dtype(dtype)
    plan = build_2d_plan(A, pr, pc, dtype)
    blk_shard4 = NamedSharding(mesh, P(ROWS, COLS, None, None))
    op_args = (jax.device_put(plan.vals, blk_shard4),
               jax.device_put(plan.cols, blk_shard4))
    op_specs = (P(ROWS, COLS, None, None), P(ROWS, COLS, None, None))

    def matvec(op_l, x_l):
        return spmv_2d_local(op_l[0].reshape(op_l[0].shape[2:]),
                             op_l[1].reshape(op_l[1].shape[2:]), x_l)

    return op_args, op_specs, matvec, "ell", plan


class DistributedCg2d(Solver):
    """Jacobi-preconditioned CG over a 2-D (rows × cols) mesh."""

    name = "dist_cg2d"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-8, maxiter=None, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        if set(mesh.axis_names) != {ROWS, COLS}:
            raise ValueError(f"need a ({ROWS},{COLS}) mesh, got {mesh.axis_names}")
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))

        (op_args, op_specs, local_matvec, self.local_spmv,
         plan) = build_2d_matvec(A, mesh, self.dtype, local_spmv)
        self.plan = plan
        self.n, self.n_pad = plan.n, plan.n_pad

        vec_shard = NamedSharding(mesh, P((ROWS, COLS)))
        self.vec_shard = vec_shard

        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=self.dtype),
                                  vec_shard)

        rtol_c, maxiter_c = self.rtol, self.maxiter
        both = (ROWS, COLS)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*op_specs, P(both), P(both)),
                 out_specs=(P(both), P(), P()))
        def _cg(*sm_args):
            *op_l, inv_diag_l, b_l = sm_args

            def matvec(p_l):
                return local_matvec(tuple(op_l), p_l)

            (bb,) = fused_psum(jnp.vdot(b_l, b_l), axis=both)
            tol2 = (rtol_c ** 2) * bb

            x0 = jnp.zeros_like(b_l)
            r0 = b_l
            z0 = inv_diag_l * r0
            p0 = z0
            rz0, rr0 = fused_psum(jnp.vdot(r0, z0), jnp.vdot(r0, r0), axis=both)

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, rz, rr, it = s
                Ap = matvec(p)
                (pAp,) = fused_psum(jnp.vdot(p, Ap), axis=both)
                alpha = rz / pAp
                x = x + alpha * p
                r = r - alpha * Ap
                z = inv_diag_l * r
                rz_new, rr_new = fused_psum(jnp.vdot(r, z), jnp.vdot(r, r), axis=both)
                beta = rz_new / rz
                p = z + beta * p
                return (x, r, p, rz_new, rr_new, it + 1)

            x, r, p, rz, rr, it = jax.lax.while_loop(
                cond, body, (x0, r0, p0, rz0, rr0, jnp.int32(0)))
            return x, jnp.sqrt(rr / jnp.where(bb > 0, bb, 1.0)), it

        self._args = (*op_args, inv_diag)
        self._jit_cg = jax.jit(_cg)

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=self.dtype)
        if b.shape[0] != self.n:
            raise ValueError(f"b has {b.shape[0]} entries, expected {self.n}")
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, relres, iters = self._jit_cg(*self._args, self._pad_b(b))
        relres = float(relres)
        x_host = self._ord.unpermute_x(np.asarray(x)[: self.n])
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"mesh": (self.plan.pr, self.plan.pc),
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel})

    def solve_fn(self):
        args = self._args
        jit_cg, pad = self._jit_cg, self._pad_b
        return lambda b: jit_cg(*args, pad(b))[0]


class DistributedBicgstab2d(Solver):
    """Jacobi-preconditioned BiCGSTAB over a 2-D mesh — the Ginkgo role
    (ginkgo.cpp:55-64 recurrence and stop rule) on the 2-D partition."""

    name = "dist_bicgstab2d"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-4, maxiter=None, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        if set(mesh.axis_names) != {ROWS, COLS}:
            raise ValueError(f"need a ({ROWS},{COLS}) mesh, got {mesh.axis_names}")
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        (op_args, op_specs, local_matvec, self.local_spmv,
         plan) = build_2d_matvec(A, mesh, self.dtype, local_spmv)
        self.plan, self.n, self.n_pad = plan, plan.n, plan.n_pad

        vec_shard = NamedSharding(mesh, P((ROWS, COLS)))
        self.vec_shard = vec_shard
        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=self.dtype),
                                  vec_shard)

        rtol_c, maxiter_c, dt = self.rtol, self.maxiter, self.dtype
        both = (ROWS, COLS)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*op_specs, P(both), P(both)),
                 out_specs=(P(both), P(), P(), P()))
        def _run(*sm_args):
            *op_l, inv_diag_l, b_l = sm_args

            def matvec(p_l):
                return local_matvec(tuple(op_l), p_l)


            r0 = b_l
            (r0n2,) = fused_psum(jnp.vdot(r0, r0), axis=both)
            tol2 = (rtol_c ** 2) * r0n2
            one = jnp.asarray(1.0, dt)
            init = (jnp.zeros_like(b_l), r0, jnp.zeros_like(b_l),
                    jnp.zeros_like(b_l), one, one, one, r0n2, jnp.int32(0))

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, v, rho, alpha, omega, rr, it = s
                (rho_new,) = fused_psum(jnp.vdot(r0, r), axis=both)
                beta = (rho_new / rho) * (alpha / omega)
                p = r + beta * (p - omega * v)
                ph = inv_diag_l * p
                v = matvec(ph)
                (r0v,) = fused_psum(jnp.vdot(r0, v), axis=both)
                alpha = rho_new / r0v
                sv = r - alpha * v
                sh = inv_diag_l * sv
                t = matvec(sh)
                tt, ts = fused_psum(jnp.vdot(t, t), jnp.vdot(t, sv), axis=both)
                omega = jnp.where(tt > 0, ts / tt, jnp.zeros_like(tt))
                x = x + alpha * ph + omega * sh
                r = sv - omega * t
                (rr_new,) = fused_psum(jnp.vdot(r, r), axis=both)
                return (x, r, p, v, rho_new, alpha, omega, rr_new, it + 1)

            x, r, p, v, rho, alpha, omega, rr, it = jax.lax.while_loop(
                cond, body, init)
            return x, jnp.sqrt(rr), jnp.sqrt(r0n2), it

        self._args = (*op_args, inv_diag)
        self._jit = jax.jit(_run)

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=self.dtype)
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters = self._jit(*self._args, self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = self._ord.unpermute_x(np.asarray(x)[: self.n])
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host,
                           iters=int(iters),
                           relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"mesh": (self.plan.pr, self.plan.pc),
                                  "true_relres": true_rel})

    def solve_fn(self):
        args, jit, pad = self._args, self._jit, self._pad_b
        return lambda b: jit(*args, pad(b))[0]


class DistributedBlockCg2d(Solver):
    """Multi-RHS (block) CG on the 2-D partition: the --nrhs k × --mesh RxC
    composition. Same precision structure as the 1-D dist_block_cg (f32
    simultaneous-column inner PCG + f64 per-column residual
    refinement); the k columns ride ONE BATCHED all_gather + psum_scatter
    per operator application (the local matvec vmapped over columns —
    collective batching rules merge the k transfers)."""

    name = "dist_block_cg2d"

    def __init__(self, A: CsrMatrix, mesh: Mesh, nrhs: int, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6,
                 ordering: str = "none", local_spmv: str = "auto",
                 dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # fixed structure: f32 SpMM inner / f64 outer
        if set(mesh.axis_names) != {ROWS, COLS}:
            raise ValueError(f"need a ({ROWS},{COLS}) mesh, "
                             f"got {mesh.axis_names}")
        from lsbench_tpu.parallel.perm import resolve_dist_ordering
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.nrhs = int(nrhs)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)

        (op32_args, op32_specs, mv32, self.local_spmv,
         plan) = build_2d_matvec(A, mesh, jnp.float32, local_spmv)
        (op64_args, op64_specs, mv64, _,
         plan64) = build_2d_matvec(A, mesh, jnp.float64, self.local_spmv)
        assert plan64.n_pad == plan.n_pad
        self.plan = plan
        self.n, self.n_pad = plan.n, plan.n_pad

        both = (ROWS, COLS)
        vec_shard = NamedSharding(mesh, P(both))
        self.blk_shard = NamedSharding(mesh, P(both, None))

        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=jnp.float32),
                                  vec_shard)

        rtol_c, inner_rtol_c = self.rtol, self.inner_rtol
        maxiter_c, max_refine_c = self.maxiter, self.max_refine
        n32 = len(op32_specs)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*op32_specs, *op64_specs, P(both), P(both, None)),
                 out_specs=(P(both, None), P(None), P(None), P(), P()))
        def _solve(*args):
            op32_l = tuple(args[:n32])
            op64_l = tuple(args[n32:-2])
            invd_l, B_l = args[-2:]

            # The k columns through one batched collective pair per apply.
            mm32 = jax.vmap(lambda xc: mv32(op32_l, xc),
                            in_axes=1, out_axes=1)
            mm64 = jax.vmap(lambda xc: mv64(op64_l, xc),
                            in_axes=1, out_axes=1)

            def cdots_psum(*pairs):
                local = jnp.stack([jnp.einsum("nk,nk->k", u, v)
                                   for u, v in pairs])
                s = jax.lax.psum(local, both)
                return tuple(s[i] for i in range(len(pairs)))

            def block_cg_inner(R32_l):
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
                    Q = mm32(Pb)
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
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                R32 = (R.astype(jnp.float32)
                       * (1.0 / safe).astype(jnp.float32)[None, :])
                D32, inner_iters = block_cg_inner(R32)
                D32 = jnp.where(jnp.isfinite(D32), D32, 0.0)
                X = X + (D32 * safe.astype(jnp.float32)[None, :]
                         ).astype(jnp.float64)
                R_new = B_l - mm64(X)
                (rr_new,) = cdots_psum((R_new, R_new))
                return (X, R_new, rr_new, it_total + inner_iters,
                        passes + 1)

            X0 = jnp.zeros_like(B_l)
            X, R, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (X0, B_l, bn2, jnp.int32(0), jnp.int32(0)))
            return X, jnp.sqrt(rr), jnp.sqrt(bn2), iters, passes

        self._op_args = (*op32_args, *op64_args, inv_diag)
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
        X_host = self._ord.unpermute_x(np.asarray(X)[: self.n])
        x = X_host[:, 0] if squeeze else X_host
        true_rel = self.true_relres(x, B)
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"refine_passes": int(passes),
                                  "nrhs": self.nrhs,
                                  "method": "simultaneous",
                                  "relres_cols": relres_cols.tolist(),
                                  "mesh": (self.plan.pr, self.plan.pc),
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir"})

    def solve_fn(self):
        op_args = self._op_args
        jit_solve = self._jit_solve
        pad = self._pad_b
        return lambda B: jit_solve(*op_args, pad(B))[0]


def spmv_2d(A: CsrMatrix, mesh: Mesh, x, dtype=jnp.float64):
    """One-shot 2-D distributed y = A @ x (test/verification entry)."""
    pr, pc = mesh.shape[ROWS], mesh.shape[COLS]
    plan = build_2d_plan(A, pr, pc, dtype)
    vec_shard = NamedSharding(mesh, P((ROWS, COLS)))
    xp = jnp.zeros(plan.n_pad, dtype=dtype).at[: plan.n].set(
        jnp.asarray(x, dtype=dtype))
    xp = jax.device_put(xp, vec_shard)
    vals = jax.device_put(plan.vals, NamedSharding(mesh, P(ROWS, COLS, None, None)))
    cols = jax.device_put(plan.cols, NamedSharding(mesh, P(ROWS, COLS, None, None)))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROWS, COLS, None, None), P(ROWS, COLS, None, None),
                       P((ROWS, COLS))),
             out_specs=P((ROWS, COLS)))
    def _mv(vals_l, cols_l, x_l):
        return spmv_2d_local(vals_l.reshape(vals_l.shape[2:]),
                             cols_l.reshape(cols_l.shape[2:]), x_l)

    y = jax.jit(_mv)(vals, cols, xp)
    return np.asarray(y)[: plan.n]
