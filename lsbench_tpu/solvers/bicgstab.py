"""Preconditioned BiCGSTAB — the Ginkgo-backend role.

The reference's Ginkgo path solves with Bicgstab<double> + Jacobi,
stopping on implicit residual norm ≤ 1e-4 × the initial residual
(ginkgo.cpp:55-64), and logs final residual / iteration count / converged
flag (ginkgo.cpp:103-108). This native version keeps those semantics
(stop uses the recurrence residual ‖r‖, baseline = initial residual) and
handles nonsymmetric systems, which CG does not.

Same design as CG: whole solve in one jit, `lax.while_loop`, layout
and ordering shared via cg.build_matvec.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu.solvers.cg import build_matvec, resolve_layout
from lsbench_tpu.solvers.preconditioners import get_preconditioner


def bicgstab_loop(matvec, precond_apply, b, rtol, maxiter, dtype):
    """Jittable preconditioned BiCGSTAB.

    Returns (x, iters, rnorm, r0norm): stop when ‖r‖ ≤ rtol·‖r0‖ (with
    x0 = 0, r0 = b — matching Ginkgo's initial_resnorm baseline).
    """
    b = b.astype(dtype)
    r0 = b
    r0norm2 = jnp.vdot(r0, r0)
    tol2 = (rtol ** 2) * r0norm2

    x0 = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype)

    # state: x, r, p, v, rho, alpha, omega, rr, it, brk
    init = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
            one, one, one, r0norm2, jnp.int32(0), jnp.bool_(False))

    def cond(s):
        *_, rr, it, brk = s
        return jnp.logical_and(jnp.logical_and(it < maxiter, rr > tol2),
                               jnp.logical_not(brk))

    def body(s):
        # BiCGSTAB's recurrences divide by rho, omega, and (r0, v); in f32
        # any of them can underflow near convergence or on hard systems
        # (tj7a series), turning x into NaN for every later iteration.
        # Guard the divisions and, if the step still broke down, KEEP the
        # previous iterate and stop — the caller (or the IR outer loop)
        # sees the best x reached instead of poison.
        x, r, p, v, rho, alpha, omega, rr, it, brk = s
        rho_new = jnp.vdot(r0, r)
        safe = lambda num, den: jnp.where(den != 0, num / jnp.where(
            den != 0, den, jnp.ones_like(den)), jnp.zeros_like(num))
        beta = safe(rho_new * alpha, rho * omega)
        p_n = r + beta * (p - omega * v)
        ph = precond_apply(p_n)
        v_n = matvec(ph)
        alpha_n = safe(rho_new, jnp.vdot(r0, v_n))
        sv = r - alpha_n * v_n
        sh = precond_apply(sv)
        t = matvec(sh)
        tt = jnp.vdot(t, t)
        omega_n = jnp.where(tt > 0, jnp.vdot(t, sv) / tt, jnp.zeros_like(tt))
        x_n = x + alpha_n * ph + omega_n * sh
        r_n = sv - omega_n * t
        rr_new = jnp.vdot(r_n, r_n)
        # A zero-progress stall — guarded divisions zeroed BOTH alpha
        # (r0·v == 0) and omega (t·t == 0) while rho stayed nonzero — makes
        # x_n == x and would spin to maxiter; treat it as breakdown too.
        stalled = jnp.logical_and(alpha_n == 0, omega_n == 0)
        good = jnp.logical_and(
            jnp.isfinite(rr_new),
            jnp.logical_and(jnp.logical_or(rho_new != 0, rr <= tol2),
                            jnp.logical_not(stalled)))
        pick = lambda a, b_: jnp.where(good, a, b_)
        return (pick(x_n, x), pick(r_n, r), pick(p_n, p), pick(v_n, v),
                pick(rho_new, rho), pick(alpha_n, alpha),
                pick(omega_n, omega), pick(rr_new, rr), it + 1,
                jnp.logical_not(good))

    x, r, p, v, rho, alpha, omega, rr, iters, brk = jax.lax.while_loop(
        cond, body, init)
    return x, iters, jnp.sqrt(rr), jnp.sqrt(r0norm2)


@register_solver("bicgstab")
class BicgstabSolver(Solver):

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, precond="jacobi",
                 rtol=1e-4, maxiter=None, layout="auto", ordering="none",
                 **params):
        super().__init__(A, **params)
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)

        self.layout = resolve_layout(layout, self.dtype, A)

        from lsbench_tpu.ordering import get_ordering
        perm = get_ordering(ordering, A)
        identity = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if identity else A.permuted(perm)
        perm_dev = None if identity else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        inv_dev = None if identity else jnp.asarray(inv)

        apply_mv, self._op, self.stream_bytes = build_matvec(
            Ap, self.dtype, self.layout)
        self._mv = lambda v: apply_mv(self._op, v)
        self._pstate, papply = get_preconditioner(precond)(Ap, self.dtype)

        rtol_c, maxiter_c = self.rtol, self.maxiter
        dt = self.dtype

        @jax.jit
        def _solve(op, pstate, b):
            bp = b if perm_dev is None else b[perm_dev]
            mv = lambda v: apply_mv(op, v)
            pc = lambda r: papply(pstate, r)
            x, iters, rnorm, r0norm = bicgstab_loop(mv, pc, bp, rtol_c,
                                                    maxiter_c, dt)
            if inv_dev is not None:
                x = x[inv_dev]
            return x, iters, rnorm, r0norm

        self._jit_solve = _solve

    def solve(self, b) -> SolveResult:
        x, iters, rnorm, r0norm = self._jit_solve(self._op, self._pstate,
                                                  jnp.asarray(b))
        rnorm, r0norm = float(rnorm), float(r0norm)
        relres = rnorm / r0norm if r0norm > 0 else 0.0
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol or r0norm == 0.0)

    def solve_fn(self):
        op, pstate, jit_solve = self._op, self._pstate, self._jit_solve
        return lambda b: jit_solve(op, pstate, b)[0]
