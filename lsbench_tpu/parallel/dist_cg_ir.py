"""Distributed mixed-precision Krylov: f32 inner solves + f64 refinement.

The distributed twin of solvers/refine.py::KrylovIrSolver:

- the inner Krylov method iterates entirely in f32 on the halo-exchange
  ELL path (parallel/dist_spmv.py), with fused `psum` reductions;
- once per refinement pass, the f64 residual r = b - A x is computed in
  native f64 and reduced with one more psum;
- each pass gains ~6 digits; 2-3 passes reach the reference's direct
  tolerance 1e-10 (cusparse.c:184) at f32 per-iteration cost.

Everything (outer refinement while_loop + inner Krylov while_loop) runs in
ONE shard_map/jit program — no host round-trips between passes.

The inner method is pluggable, mirroring the single-chip family
(refine.py): CG for the SPD workload (`DistributedCgIr`), BiCGSTAB
(`DistributedBicgstabIr` — the Ginkgo role, ginkgo.cpp:55-64, with honest
fp64 semantics over a mesh) and restarted GMRES (`DistributedGmresIr`)
for nonsymmetric systems.
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
                                            fused_psum)
from lsbench_tpu.parallel.mesh import ROWS, fetch_global
from lsbench_tpu.parallel.perm import resolve_dist_ordering
from lsbench_tpu.solvers.base import SolveResult, Solver

# ----------------------------------------------------------- inner methods
# Each runs INSIDE the shard_map body on local shards: `mv` is the local
# halo-exchange matvec, `invd_l` the local Jacobi diagonal, `rhs_l` the
# local f32 right-hand side. Stop on the recursive residual relative to
# ||rhs|| (the f64 outer loop owns the true-residual contract). Returns
# (local solution shard, iteration count).

_HP = jax.lax.Precision.HIGHEST  # no TF32 for f32 Arnoldi products


def _cg_inner(mv, invd_l, rhs_l, inner_rtol, maxiter, axis=ROWS):
    """f32 Jacobi-CG of A d = rhs to inner_rtol (one fused psum/iter)."""
    (bb,) = fused_psum(jnp.vdot(rhs_l, rhs_l), axis=axis)
    tol2 = jnp.asarray(inner_rtol**2, jnp.float32) * bb
    x0 = jnp.zeros_like(rhs_l)
    z0 = invd_l * rhs_l
    rz0, rr0 = fused_psum(jnp.vdot(rhs_l, z0), jnp.vdot(rhs_l, rhs_l),
                          axis=axis)

    def cond(s):
        *_, rr, it = s
        return jnp.logical_and(it < maxiter, rr > tol2)

    def body(s):
        x, r, p, rz, rr, it = s
        Ap = mv(p)
        (pAp,) = fused_psum(jnp.vdot(p, Ap), axis=axis)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = invd_l * r
        rz_new, rr_new = fused_psum(jnp.vdot(r, z), jnp.vdot(r, r), axis=axis)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, rr_new, it + 1)

    x, r, p, rz, rr, it = jax.lax.while_loop(
        cond, body, (x0, rhs_l, z0, rz0, rr0, jnp.int32(0)))
    return x, it


def _bicgstab_inner(mv, invd_l, rhs_l, inner_rtol, maxiter, axis=ROWS):
    """f32 Jacobi-BiCGSTAB of A d = rhs (the ginkgo.cpp:55-64 recurrence,
    same fused-psum schedule as parallel/dist_bicgstab.py)."""
    r0 = rhs_l
    (r0n2,) = fused_psum(jnp.vdot(r0, r0), axis=axis)
    tol2 = jnp.asarray(inner_rtol**2, jnp.float32) * r0n2
    one = jnp.asarray(1.0, jnp.float32)
    init = (jnp.zeros_like(rhs_l), r0, jnp.zeros_like(rhs_l),
            jnp.zeros_like(rhs_l), one, one, one, r0n2, jnp.int32(0))

    def cond(s):
        *_, rr, it = s
        return jnp.logical_and(it < maxiter, rr > tol2)

    def body(s):
        x, r, p, v, rho, alpha, omega, rr, it = s
        (rho_new,) = fused_psum(jnp.vdot(r0, r), axis=axis)
        # f32 breakdown guard: a vanishing rho/omega would produce inf
        # beta; freeze the step instead (the outer f64 pass absorbs it).
        denom = rho * omega
        beta = jnp.where(denom != 0, (rho_new / rho) * (alpha / omega), 0.0)
        p = r + beta * (p - omega * v)
        ph = invd_l * p
        v = mv(ph)
        (r0v,) = fused_psum(jnp.vdot(r0, v), axis=axis)
        alpha = jnp.where(r0v != 0, rho_new / r0v, 0.0)
        sv = r - alpha * v
        sh = invd_l * sv
        t = mv(sh)
        tt, ts = fused_psum(jnp.vdot(t, t), jnp.vdot(t, sv), axis=axis)
        omega = jnp.where(tt > 0, ts / tt, jnp.zeros_like(tt))
        x = x + alpha * ph + omega * sh
        r = sv - omega * t
        (rr_new,) = fused_psum(jnp.vdot(r, r), axis=axis)
        return (x, r, p, v, rho_new, alpha, omega, rr_new, it + 1)

    x, r, p, v, rho, alpha, omega, rr, it = jax.lax.while_loop(
        cond, body, init)
    return x, it


def _gmres_inner(mv, invd_l, rhs_l, inner_rtol, maxiter, restart,
                 axis=ROWS):
    """f32 restarted GMRES(m) of A d = rhs (CGS2 Arnoldi, replicated
    Hessenberg least-squares — parallel/dist_gmres.py's cycle)."""
    m = restart
    mr = max(1, -(-maxiter // m))
    dt = jnp.float32
    nloc = rhs_l.shape[0]
    eps_break = 1e-30

    def pdot(a, b):
        return jax.lax.psum(jnp.vdot(a, b), axis)

    bb = pdot(rhs_l, rhs_l)
    tol = jnp.asarray(inner_rtol, dt) * jnp.sqrt(bb)

    def arnoldi_cycle(x_l):
        r_l = rhs_l - mv(x_l)
        beta = jnp.sqrt(pdot(r_l, r_l))
        beta_safe = jnp.where(beta > 0, beta, 1.0)
        V0 = jnp.zeros((m + 1, nloc), dt).at[0].set(r_l / beta_safe)
        H0 = jnp.zeros((m + 1, m), dt)

        def step(j, carry):
            V, H = carry
            w = mv(invd_l * V[j])
            mask = (jnp.arange(m + 1) <= j).astype(dt)
            h1 = jax.lax.psum(jnp.matmul(V, w, precision=_HP), axis) * mask
            w = w - jnp.matmul(V.T, h1, precision=_HP)
            h2 = jax.lax.psum(jnp.matmul(V, w, precision=_HP), axis) * mask
            w = w - jnp.matmul(V.T, h2, precision=_HP)
            h = h1 + h2
            hnext = jnp.sqrt(pdot(w, w))
            V = V.at[j + 1].set(w / jnp.maximum(hnext, eps_break))
            H = H.at[:, j].set(h.at[j + 1].set(hnext))
            return (V, H)

        V, H = jax.lax.fori_loop(0, m, step, (V0, H0))
        e1 = jnp.zeros(m + 1, dt).at[0].set(beta)
        q, rr = jnp.linalg.qr(H, mode="reduced")
        y = jax.scipy.linalg.solve_triangular(
            rr + eps_break * jnp.eye(m, dtype=dt),
            jnp.matmul(q.T, e1, precision=_HP), lower=False)
        return x_l + invd_l * jnp.matmul(V[:m].T, y, precision=_HP)

    def cond(s):
        x, rn, it = s
        return jnp.logical_and(it < mr, rn > tol)

    def body(s):
        x, rn, it = s
        x = arnoldi_cycle(x)
        r = rhs_l - mv(x)
        return (x, jnp.sqrt(pdot(r, r)), it + 1)

    x0 = jnp.zeros_like(rhs_l)
    x, rnorm, restarts = jax.lax.while_loop(
        cond, body, (x0, jnp.sqrt(bb), jnp.int32(0)))
    return x, restarts * m


# ------------------------------------------------------------------ solver

class DistributedKrylovIr(Solver):
    """f32 distributed inner Krylov solve + f64 distributed refinement.

    Subclasses pick the inner method via `_make_inner()`; everything else
    (the f64 residual pass, the device-side ordering gathers) is
    shared.
    """

    def __init__(self, A: CsrMatrix, mesh: Mesh, rtol=1e-10, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, ordering="none",
                 strategy="auto", local_spmv="auto", row_align: int = 8,
                 dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # precision structure is fixed: f32 inner / f64 outer
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self.n = A.nrows

        # Same partition for both operators (nloc depends only on
        # n / n_devices / row_align): f32 for the inner iteration, f64
        # for the residual.
        dm32 = build_dist_matvec(A, mesh, jnp.float32, strategy=strategy,
                                 local_spmv=local_spmv, row_align=row_align)
        dm64 = build_dist_matvec(A, mesh, jnp.float64, strategy=dm32.strategy,
                                 local_spmv=dm32.local_spmv,
                                 row_align=row_align)
        assert dm32.n_pad == dm64.n_pad and dm32.nloc == dm64.nloc
        self.strategy = dm32.strategy
        self.local_spmv = dm32.local_spmv
        self.plan = dm32.plan
        self.n_pad = dm32.n_pad

        vec_shard = NamedSharding(mesh, P(ROWS))
        self.vec_shard = vec_shard

        # Jacobi preconditioner for the f32 inner iteration.
        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=jnp.float32),
                                  vec_shard)

        rtol_c, max_refine_c = self.rtol, self.max_refine
        mv32_local, mv64_local = dm32.matvec, dm64.matvec
        n32 = len(dm32.op_specs)
        inner_solve = self._make_inner()

        @partial(shard_map, mesh=mesh,
                 in_specs=(*dm32.op_specs, *dm64.op_specs, P(ROWS), P(ROWS)),
                 out_specs=(P(ROWS), P(), P(), P(), P()))
        def _solve(*args):
            op32_l = tuple(args[:n32])
            op64_l = tuple(args[n32:-2])
            invd_l, b_l = args[-2:]

            def mv(p_l):
                return mv32_local(op32_l, p_l)

            b_l = b_l.astype(jnp.float64)
            (bb,) = fused_psum(jnp.vdot(b_l, b_l))
            tol2 = (rtol_c**2) * bb

            def refine_cond(s):
                x, r, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c, rr > tol2)

            def refine_body(s):
                # One f64 SpMV per PASS, not per iteration
                # — the residual carries across passes.
                x, r, rr, it_total, passes = s
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                rhs32 = (r.astype(jnp.float32)
                         * (1.0 / safe).astype(jnp.float32))
                d32, inner_iters = inner_solve(mv, invd_l, rhs32)
                # A non-finite correction (f32 breakdown) must not poison
                # x; drop it and let the pass cap end the loop.
                d32 = jnp.where(jnp.isfinite(d32), d32, 0.0)
                x = x + (d32 * safe.astype(jnp.float32)).astype(jnp.float64)
                r_new = b_l - mv64_local(op64_l, x)
                (rr_new,) = fused_psum(jnp.vdot(r_new, r_new))
                return (x, r_new, rr_new, it_total + inner_iters, passes + 1)

            x0 = jnp.zeros_like(b_l)
            x, r, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (x0, b_l, bb, jnp.int32(0), jnp.int32(0)))
            return x, jnp.sqrt(rr), jnp.sqrt(bb), iters, passes

        inner = jax.jit(_solve)

        # Device-side ordering: the b-permutation and x-inverse-permutation
        # ride INSIDE the jitted program as sharded gathers (one per SOLVE
        # — on N>1 devices XLA inserts the one-time resharding collective,
        # never in the iteration loop), moving the permute off the host.
        # The indices are runtime ARGUMENTS (not baked constants) so the
        # identity ordering keeps the same program shape.
        shard = vec_shard

        @jax.jit
        def _solve_wrapped(*args):
            *op_and_state, pp_i, ip_i, braw = args
            bp = braw.at[pp_i].get(out_sharding=shard)
            x, rnorm, bnorm, iters, passes = inner(*op_and_state, bp)
            return (x.at[ip_i].get(out_sharding=shard),
                    rnorm, bnorm, iters, passes)

        pp = np.arange(self.n_pad, dtype=np.int32)
        ip = np.arange(self.n_pad, dtype=np.int32)
        if self._ord.perm is not None:
            pp[: self.n] = self._ord.perm
            ip[: self.n] = self._ord.inv
        self._op_args = (*dm32.op_args, *dm64.op_args, inv_diag,
                         jnp.asarray(pp), jnp.asarray(ip))
        self._jit_solve = _solve_wrapped

    def _make_inner(self):
        """Return inner(mv, invd_l, rhs32_l) -> (d32_l, iters)."""
        raise NotImplementedError

    def _pad_b(self, b):
        b = np.asarray(b, dtype=np.float64)
        if b.shape[0] != self.n:
            raise ValueError(f"b has {b.shape[0]} entries, expected {self.n}")
        bp = jnp.zeros(self.n_pad, jnp.float64).at[: self.n].set(
            jnp.asarray(b))
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters, passes = self._jit_solve(
            *self._op_args, self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = fetch_global(x, self.n)
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": int(passes),
                                  "strategy": self.strategy,
                                  "local_spmv": self.local_spmv,
                                  "halo": self.plan.halo,
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir_auto"})

    def solve_fn(self):
        op_args = self._op_args
        jit_solve = self._jit_solve
        pad = self._pad_b
        return lambda b: jit_solve(*op_args, pad(b))[0]


class DistributedCgIr(DistributedKrylovIr):
    """f32 distributed CG inner solve + f64 distributed residual refinement.

    The `--devices N` route for `--solver cg_ir` / `--precision fp32_ir`
    (and the recommended fp64 production path over a mesh).
    """

    name = "dist_cg_ir"

    def _make_inner(self):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        return lambda mv, invd_l, rhs_l: _cg_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter)


class DistributedBicgstabIr(DistributedKrylovIr):
    """f32 distributed BiCGSTAB inner + f64 refinement: the Ginkgo role
    (ginkgo.cpp:55-64) over a mesh with fp64 semantics (lsbench.c:140-141)
    at f32 per-iteration cost — `--solver bicgstab/ginkgo --precision
    fp32_ir --devices N`."""

    name = "dist_bicgstab_ir"

    def _make_inner(self):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        return lambda mv, invd_l, rhs_l: _bicgstab_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter)


class DistributedGmresIr(DistributedKrylovIr):
    """f32 distributed restarted-GMRES inner + f64 refinement —
    `--solver gmres --precision fp32_ir --devices N`."""

    name = "dist_gmres_ir"

    def __init__(self, A: CsrMatrix, mesh: Mesh, restart=30, **kw):
        self.restart = int(restart)
        super().__init__(A, mesh, **kw)

    def _make_inner(self):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        restart = self.restart
        return lambda mv, invd_l, rhs_l: _gmres_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter, restart)


# ------------------------------------------------- 2-D partition variants

class DistributedKrylovIr2d(Solver):
    """fp64 semantics over the 2-D (rows × cols) partition: f32 inner
    Krylov on the all_gather-rows/psum_scatter-cols schedule
    (parallel/dist2d.py) + once-per-pass f64 residual, all in one
    shard_map program — the very-large-matrix axis (SURVEY.md §5
    long-context row) at the reference's 1e-10 tolerance
    (lsbench.c:140-141) and f32 per-iteration cost."""

    def __init__(self, A: CsrMatrix, mesh: Mesh, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6,
                 ordering="none", local_spmv="auto", dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # precision structure fixed: f32 inner / f64 outer
        from lsbench_tpu.parallel.dist2d import build_2d_matvec
        from lsbench_tpu.parallel.mesh import COLS
        if set(mesh.axis_names) != {ROWS, COLS}:
            raise ValueError(
                f"need a ({ROWS},{COLS}) mesh, got {mesh.axis_names}")
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.mesh = mesh
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self.n = A.nrows

        (op32_args, op32_specs, mv32_local, self.local_spmv,
         plan) = build_2d_matvec(A, mesh, jnp.float32, local_spmv)
        (op64_args, op64_specs, mv64_local, _,
         plan64) = build_2d_matvec(A, mesh, jnp.float64, self.local_spmv)
        assert plan.n_pad == plan64.n_pad
        self.plan = plan
        self.n_pad = plan.n_pad

        both = (ROWS, COLS)
        vec_shard = NamedSharding(mesh, P(both))
        self.vec_shard = vec_shard

        d = np.ones(self.n_pad)
        diag = A.diagonal()
        d[: self.n] = np.where(diag != 0.0, diag, 1.0)
        inv_diag = jax.device_put(jnp.asarray(1.0 / d, dtype=jnp.float32),
                                  vec_shard)

        rtol_c, max_refine_c = self.rtol, self.max_refine
        n32 = len(op32_specs)
        inner_solve = self._make_inner(both)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*op32_specs, *op64_specs, P(both), P(both)),
                 out_specs=(P(both), P(), P(), P(), P()))
        def _solve(*args):
            op32_l = tuple(args[:n32])
            op64_l = tuple(args[n32:-2])
            invd_l, b_l = args[-2:]

            def mv(p_l):
                return mv32_local(op32_l, p_l)

            b_l = b_l.astype(jnp.float64)
            (bb,) = fused_psum(jnp.vdot(b_l, b_l), axis=both)
            tol2 = (rtol_c**2) * bb

            def refine_cond(s):
                x, r, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c, rr > tol2)

            def refine_body(s):
                x, r, rr, it_total, passes = s
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                rhs32 = (r.astype(jnp.float32)
                         * (1.0 / safe).astype(jnp.float32))
                d32, inner_iters = inner_solve(mv, invd_l, rhs32)
                d32 = jnp.where(jnp.isfinite(d32), d32, 0.0)
                x = x + (d32 * safe.astype(jnp.float32)).astype(jnp.float64)
                r_new = b_l - mv64_local(op64_l, x)
                (rr_new,) = fused_psum(jnp.vdot(r_new, r_new), axis=both)
                return (x, r_new, rr_new, it_total + inner_iters,
                        passes + 1)

            x0 = jnp.zeros_like(b_l)
            x, r, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (x0, b_l, bb, jnp.int32(0), jnp.int32(0)))
            return x, jnp.sqrt(rr), jnp.sqrt(bb), iters, passes

        self._op_args = (*op32_args, *op64_args, inv_diag)
        self._jit_solve = jax.jit(_solve)

    def _make_inner(self, axis):
        raise NotImplementedError

    def _pad_b(self, b):
        b = jnp.asarray(self._ord.permute_b(b), dtype=jnp.float64)
        if b.shape[0] != self.n:
            raise ValueError(f"b has {b.shape[0]} entries, expected {self.n}")
        bp = jnp.zeros(self.n_pad, jnp.float64).at[: self.n].set(b)
        return jax.device_put(bp, self.vec_shard)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters, passes = self._jit_solve(
            *self._op_args, self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = self._ord.unpermute_x(np.asarray(x)[: self.n])
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": int(passes),
                                  "mesh": (self.plan.pr, self.plan.pc),
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir_auto"})

    def solve_fn(self):
        op_args, jit_solve, pad = self._op_args, self._jit_solve, self._pad_b
        return lambda b: jit_solve(*op_args, pad(b))[0]


class DistributedCgIr2d(DistributedKrylovIr2d):
    """`--solver cg --precision fp32_ir --mesh RxC`."""

    name = "dist_cg_ir2d"

    def _make_inner(self, axis):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        return lambda mv, invd_l, rhs_l: _cg_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter, axis=axis)


class DistributedBicgstabIr2d(DistributedKrylovIr2d):
    """`--solver bicgstab/ginkgo --precision fp32_ir --mesh RxC`."""

    name = "dist_bicgstab_ir2d"

    def _make_inner(self, axis):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        return lambda mv, invd_l, rhs_l: _bicgstab_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter, axis=axis)


class DistributedGmresIr2d(DistributedKrylovIr2d):
    """`--solver gmres --precision fp32_ir --mesh RxC`."""

    name = "dist_gmres_ir2d"

    def __init__(self, A: CsrMatrix, mesh: Mesh, restart=30, **kw):
        self.restart = int(restart)
        super().__init__(A, mesh, **kw)

    def _make_inner(self, axis):
        inner_rtol, maxiter = self.inner_rtol, self.maxiter
        restart = self.restart
        return lambda mv, invd_l, rhs_l: _gmres_inner(
            mv, invd_l, rhs_l, inner_rtol, maxiter, restart, axis=axis)
