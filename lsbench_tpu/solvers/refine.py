"""Mixed-precision iterative refinement: f32 inner solve, f64 residual.

The inner Krylov solve runs in f32; the outer residual r = b − A·x is
computed in native f64 once per refinement pass. Each pass gains ~6
digits; 2–3 passes reach the reference's direct-solve tolerance 1e-10
(cusparse.c:184) with the f64 cost paid per pass, not per iteration.

The structure is generic over the inner Krylov method: CG for the SPD
workload (solver "cg_ir", the `--precision fp32_ir` CLI mode), restarted
GMRES ("gmres_ir") and BiCGSTAB ("bicgstab_ir") for nonsymmetric systems.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.ell import EllMatrix
from lsbench_tpu.ops.spmv import spmv_ell
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu.solvers.cg import build_matvec, cg_loop, resolve_layout
from lsbench_tpu.solvers.preconditioners import get_preconditioner


class KrylovIrSolver(Solver):
    """f32 inner Krylov solve + f64 residual refinement.

    Subclasses provide `_inner_loop(mv32, pc, rhs32) -> (d32, iters)`:
    a jittable f32 solve of A d ≈ rhs32 to `inner_rtol`.
    """

    def __init__(self, A: CsrMatrix, rtol=1e-10, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, **params):
        super().__init__(A, **params)
        del dtype  # precision structure is fixed: f32 inner / f64 outer
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        self.max_refine = int(max_refine)
        self.layout = resolve_layout(layout, jnp.float32, A)

        import time as _time

        from lsbench_tpu.ordering import get_ordering
        _t0 = _time.perf_counter()
        perm = get_ordering(ordering, A)
        self.setup_breakdown["ordering_s"] = _time.perf_counter() - _t0
        identity = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if identity else A.permuted(perm)
        perm_dev = None if identity else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        inv_dev = None if identity else jnp.asarray(inv)

        _t0 = _time.perf_counter()
        apply32, self._op, self.stream_bytes = build_matvec(
            Ap, jnp.float32, self.layout)
        self._mv = lambda v: apply32(self._op, v)
        self._op64 = EllMatrix.from_csr(Ap, dtype=jnp.float64)
        self.setup_breakdown["layout_s"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        self._pstate, papply = get_preconditioner(precond)(
            Ap, jnp.float32, **(precond_params or {}))
        self.setup_breakdown["precond_s"] = _time.perf_counter() - _t0

        rtol_c, max_refine_c = self.rtol, self.max_refine
        inner = self._inner_loop

        @jax.jit
        def _solve(op, op64, pstate, b):
            mv32 = lambda v: apply32(op, v)
            resid_mv = lambda x: spmv_ell(op64, x)
            b = b.astype(jnp.float64)
            bp = b if perm_dev is None else b[perm_dev]
            bnorm = jnp.sqrt(jnp.vdot(bp, bp))
            tol2 = (rtol_c * bnorm) ** 2
            pc = lambda r: papply(pstate, r)

            def refine_cond(s):
                x, r, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c, rr > tol2)

            def refine_body(s):
                # Carry the f64 residual across passes: exactly ONE f64
                # SpMV per pass.
                x, r, rr, it_total, passes = s
                # Scale for f32 range safety, solve A d ≈ r in f32; only
                # the residual and x update stay f64.
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                rhs32 = r.astype(jnp.float32) * (1.0 / safe).astype(jnp.float32)
                d32, inner_iters = inner(mv32, pc, rhs32)
                # Insurance against inner-solver breakdown (e.g. BiCGSTAB
                # rho underflow in f32): a non-finite correction must not
                # poison x — drop it and let the pass cap end the loop.
                d32 = jnp.where(jnp.isfinite(d32), d32, 0.0)
                x = x + (d32 * safe.astype(jnp.float32)).astype(jnp.float64)
                r_new = bp - resid_mv(x)
                rr_new = jnp.vdot(r_new, r_new)
                return (x, r_new, rr_new, it_total + inner_iters, passes + 1)

            x0 = jnp.zeros_like(bp)
            rr0 = jnp.vdot(bp, bp)
            x, r, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (x0, bp, rr0, jnp.int32(0), jnp.int32(0)))
            if inv_dev is not None:
                x = x[inv_dev]
            return x, iters, passes, jnp.sqrt(rr), bnorm

        self._jit_solve = _solve

    def _inner_loop(self, mv32, pc, rhs32):
        raise NotImplementedError

    def solve(self, b) -> SolveResult:
        x, iters, passes, rnorm, bnorm = self._jit_solve(
            self._op, self._op64, self._pstate, jnp.asarray(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": int(passes)})

    def solve_fn(self):
        args = (self._op, self._op64, self._pstate)
        jit_solve = self._jit_solve
        return lambda b: jit_solve(*args, b)[0]

    def solve_fn_args(self):
        jit_solve = self._jit_solve
        return ((lambda args, b: jit_solve(*args, b)[0]),
                (self._op, self._op64, self._pstate))


@register_solver("cg_ir")
class CgIrSolver(KrylovIrSolver):
    """f32 CG inner solve + f64 residual refinement (SPD systems)."""

    def _inner_loop(self, mv32, pc, rhs32):
        d32, inner_iters, _, _ = cg_loop(
            mv32, pc, rhs32, self.inner_rtol, self.maxiter, jnp.float32)
        return d32, inner_iters


@register_solver("gmres_ir")
class GmresIrSolver(KrylovIrSolver):
    """f32 restarted-GMRES inner solve + f64 residual refinement."""

    def __init__(self, A: CsrMatrix, restart=30, max_restarts=None,
                 maxiter=None, **params):
        self.restart = int(restart)
        if max_restarts is None:
            cap = maxiter if maxiter is not None else max(10 * A.nrows, 1000)
            max_restarts = max(int(np.ceil(cap / self.restart)), 1)
        self.max_restarts = int(max_restarts)
        super().__init__(A, maxiter=maxiter, **params)

    def _inner_loop(self, mv32, pc, rhs32):
        from lsbench_tpu.solvers.gmres import gmres_loop
        d32, inner_iters, _, _ = gmres_loop(
            mv32, pc, rhs32, self.inner_rtol, self.max_restarts,
            self.restart, jnp.float32)
        return d32, inner_iters


@register_solver("bicgstab_ir")
class BicgstabIrSolver(KrylovIrSolver):
    """f32 BiCGSTAB inner solve + f64 residual refinement."""

    def _inner_loop(self, mv32, pc, rhs32):
        from lsbench_tpu.solvers.bicgstab import bicgstab_loop
        d32, inner_iters, _, _ = bicgstab_loop(
            mv32, pc, rhs32, self.inner_rtol, self.maxiter, jnp.float32)
        return d32, inner_iters
