"""Batched multi-RHS BiCGSTAB — `--nrhs k` for the Ginkgo role.

The reference's Ginkgo backend is single-RHS BiCGSTAB + Jacobi
(ginkgo.cpp:55-64). k right-hand sides are independent BiCGSTAB
recurrences, so unlike block CG (a shared Krylov subspace, block_cg.py)
the natural multi-RHS form is BATCHED: each column carries its own
scalars (ρ, α, ω) as (k,) vectors while every matvec becomes ONE SpMM
over the same matrix stream, so the k columns amortize the operator
traffic.

Structure mirrors BlockCgSolver (block_cg.py): f32 batched inner loop +
once-per-pass f64 residual, per-column convergence masks
(a finished column freezes — the loop's OR-condition keeps running for
the others), worst-column reporting.
"""

from __future__ import annotations

import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver


def _cdots(A_, B_):
    """Per-column dots: (n,k)·(n,k) → (k,)."""
    return jnp.sum(A_ * B_, axis=0)


def batched_bicgstab_loop(matmat, pc_cols, B, rtol, maxiter, dtype):
    """k independent preconditioned BiCGSTAB recurrences, one SpMM per
    half-step. Per-column breakdown guards match bicgstab_loop
    (solvers/bicgstab.py): a broken/stalled column freezes at its best
    iterate while the others continue."""
    B = B.astype(dtype)
    k = B.shape[1]
    R0 = B
    rr0 = _cdots(R0, R0)                       # (k,)
    tol2 = (rtol ** 2) * rr0
    one = jnp.ones((k,), dtype)

    X0 = jnp.zeros_like(B)
    init = (X0, R0, jnp.zeros_like(B), jnp.zeros_like(B),
            one, one, one, rr0, jnp.int32(0), jnp.zeros((k,), bool))

    def cond(s):
        *_, rr, it, brk = s
        active = jnp.logical_and(rr > tol2, jnp.logical_not(brk))
        return jnp.logical_and(it < maxiter, jnp.any(active))

    def body(s):
        X, R, Pv, V, rho, alpha, omega, rr, it, brk = s
        active = jnp.logical_and(rr > tol2, jnp.logical_not(brk))  # (k,)
        rho_new = _cdots(R0, R)
        safe = lambda num, den: jnp.where(
            den != 0, num / jnp.where(den != 0, den, jnp.ones_like(den)),
            jnp.zeros_like(num))
        beta = safe(rho_new * alpha, rho * omega)
        P_n = R + beta[None, :] * (Pv - omega[None, :] * V)
        Ph = pc_cols(P_n)
        V_n = matmat(Ph)
        alpha_n = safe(rho_new, _cdots(R0, V_n))
        Sv = R - alpha_n[None, :] * V_n
        Sh = pc_cols(Sv)
        T = matmat(Sh)
        tt = _cdots(T, T)
        omega_n = jnp.where(tt > 0, _cdots(T, Sv)
                            / jnp.where(tt > 0, tt, 1.0), 0.0)
        X_n = X + alpha_n[None, :] * Ph + omega_n[None, :] * Sh
        R_n = Sv - omega_n[None, :] * T
        rr_new = _cdots(R_n, R_n)
        stalled = jnp.logical_and(alpha_n == 0, omega_n == 0)
        good = jnp.logical_and(
            jnp.isfinite(rr_new),
            jnp.logical_and(jnp.logical_or(rho_new != 0, rr <= tol2),
                            jnp.logical_not(stalled)))
        take = jnp.logical_and(active, good)   # (k,) columns that step
        pickc = lambda a, b_: jnp.where(take[None, :], a, b_)
        picks = lambda a, b_: jnp.where(take, a, b_)
        return (pickc(X_n, X), pickc(R_n, R), pickc(P_n, Pv),
                pickc(V_n, V), picks(rho_new, rho), picks(alpha_n, alpha),
                picks(omega_n, omega), picks(rr_new, rr), it + 1,
                jnp.logical_or(brk,
                               jnp.logical_and(active,
                                               jnp.logical_not(good))))

    X, R, Pv, V, rho, alpha, omega, rr, iters, brk = jax.lax.while_loop(
        cond, body, init)
    return X, iters, jnp.sqrt(rr), jnp.sqrt(rr0)


@register_solver("batched_bicgstab")
class BatchedBicgstabSolver(Solver):
    """f32 batched BiCGSTAB inner + f64 residual refinement per column
    (the `--solver bicgstab/ginkgo --nrhs k` route). solve(B) takes
    (n, k); reporting is worst-column, like block_cg."""

    def __init__(self, A: CsrMatrix, rtol=1e-4, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, **params):
        super().__init__(A, **params)
        del dtype, layout  # fixed structure: f32 SpMM inner / f64 outer
        self.rtol = float(rtol)
        self.inner_rtol = float(min(inner_rtol, self.rtol * 0.1))
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)

        from lsbench_tpu.ordering import get_ordering
        _t0 = _time.perf_counter()
        perm = get_ordering(ordering, A)
        self.setup_breakdown["ordering_s"] = _time.perf_counter() - _t0
        identity = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if identity else A.permuted(perm)
        self._perm = None if identity else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        self._inv = None if identity else jnp.asarray(inv)

        _t0 = _time.perf_counter()
        from lsbench_tpu.matrix.ell import EllMatrix
        from lsbench_tpu.ops.spmv import spmv_ell
        self._op = EllMatrix.from_csr(Ap, dtype=jnp.float32)
        self._op64 = EllMatrix.from_csr(Ap, dtype=jnp.float64)
        self.stream_bytes = None
        ell_mm = jax.vmap(spmv_ell, in_axes=(None, 1), out_axes=1)
        self.setup_breakdown["layout_s"] = _time.perf_counter() - _t0

        from lsbench_tpu.solvers.preconditioners import get_preconditioner
        self._pstate, papply = get_preconditioner(precond)(
            Ap, jnp.float32, **(precond_params or {}))

        rtol_c, inner_rtol_c = self.rtol, self.inner_rtol
        maxiter_c, max_refine_c = self.maxiter, self.max_refine
        perm_dev, inv_dev = self._perm, self._inv

        @jax.jit
        def _solve(op, op64, pstate, B):
            B = B.astype(jnp.float64)
            Bp = B if perm_dev is None else B[perm_dev]
            bnorm2 = _cdots(Bp, Bp)
            tol2 = (rtol_c ** 2) * bnorm2

            mm = lambda V: ell_mm(op, V)
            pc_cols = jax.vmap(lambda r: papply(pstate, r),
                               in_axes=1, out_axes=1)

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
                D32, inner_iters, _, _ = batched_bicgstab_loop(
                    mm, pc_cols, R32, inner_rtol_c, maxiter_c,
                    jnp.float32)
                D32 = jnp.where(jnp.isfinite(D32), D32, 0.0)
                X = X + (D32 * safe.astype(jnp.float32)[None, :]
                         ).astype(jnp.float64)
                R_new = Bp - ell_mm(op64, X)
                return (X, R_new, _cdots(R_new, R_new),
                        it_total + inner_iters, passes + 1)

            X0 = jnp.zeros_like(Bp)
            X, R, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (X0, Bp, bnorm2, jnp.int32(0), jnp.int32(0)))
            if inv_dev is not None:
                X = X[inv_dev]
            return X, iters, passes, jnp.sqrt(rr), jnp.sqrt(bnorm2)

        self._jit_solve = _solve

    def solve(self, B) -> SolveResult:
        B = jnp.asarray(B)
        squeeze = B.ndim == 1
        if squeeze:
            B = B[:, None]
        X, iters, passes, rnorm, bnorm = self._jit_solve(
            self._op, self._op64, self._pstate, B)
        rnorm, bnorm = np.asarray(rnorm), np.asarray(bnorm)
        relres_cols = np.where(bnorm > 0,
                               rnorm / np.maximum(bnorm, 1e-300), 0.0)
        relres = float(relres_cols.max())
        x = X[:, 0] if squeeze else X
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol,
                           extra={"refine_passes": int(passes),
                                  "nrhs": int(B.shape[1]),
                                  "relres_cols": relres_cols.tolist(),
                                  "precision_mode": "fp32_ir"})

    @staticmethod
    def _solve_x(jit_solve, args, B):
        squeeze = B.ndim == 1
        if squeeze:
            B = B[:, None]
        X = jit_solve(*args, B)[0]
        return X[:, 0] if squeeze else X

    def solve_fn(self):
        args = (self._op, self._op64, self._pstate)
        jit_solve = self._jit_solve
        return lambda B: self._solve_x(jit_solve, args, B)

    def solve_fn_args(self):
        jit_solve = self._jit_solve
        return ((lambda args, B: BatchedBicgstabSolver._solve_x(
            jit_solve, args, B)), (self._op, self._op64, self._pstate))
