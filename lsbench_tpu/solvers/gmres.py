"""Restarted GMRES(m) — general nonsymmetric Krylov solver.

Fills the reference's general-Krylov role alongside BiCGSTAB (Ginkgo,
ginkgo.cpp:55-64) for matrices where BiCGSTAB stagnates. Right-
preconditioned, so the residual the stopping test sees is the true
residual.

Design: the Arnoldi basis is a dense (m+1, n) matrix; orthogonalization
is CGS2 (classical Gram-Schmidt, two passes) so each inner step is two
(m+1,n)×(n,) matrix-vector products instead of j sequential dots — masked
to the active columns to keep shapes static. Every product asks for
HIGHEST precision, so an f32 basis never runs in TF32. The small (m+1, m) least-squares
problem is solved once per restart cycle with dense QR on device; the outer
restart loop is a `lax.while_loop` with exact residual recomputation, so
the whole solve stays in one jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu.solvers.cg import build_matvec, resolve_layout
from lsbench_tpu.solvers.preconditioners import get_preconditioner


_HP = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HP)


def gmres_loop(matvec, precond_apply, b, rtol, max_restarts, m, dtype):
    """Jittable restarted GMRES(m). Returns (x, inner_iters, rnorm, bnorm)."""
    b = b.astype(dtype)
    n = b.shape[0]
    bnorm = jnp.sqrt(jnp.vdot(b, b))
    tol = rtol * bnorm
    eps_break = jnp.asarray(1e-30, dtype)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.vdot(r, r))
        beta_safe = jnp.where(beta > 0, beta, 1.0)
        V0 = jnp.zeros((m + 1, n), dtype)
        V0 = V0.at[0].set(r / beta_safe)
        H0 = jnp.zeros((m + 1, m), dtype)

        def step(j, carry):
            V, H = carry
            w = matvec(precond_apply(V[j]))
            # CGS2 against rows 0..j (mask keeps shapes static).
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h1 = _mm(V, w) * mask
            w = w - _mm(V.T, h1)
            h2 = _mm(V, w) * mask
            w = w - _mm(V.T, h2)
            h = h1 + h2
            hnext = jnp.sqrt(jnp.vdot(w, w))
            V = V.at[j + 1].set(w / jnp.maximum(hnext, eps_break))
            H = H.at[:, j].set(h.at[j + 1].set(hnext))
            return (V, H)

        V, H = jax.lax.fori_loop(0, m, step, (V0, H0))
        # Least squares: min ||beta e1 - H y||.
        e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        q, rr = jnp.linalg.qr(H, mode="reduced")
        y = jax.scipy.linalg.solve_triangular(
            rr + eps_break * jnp.eye(m, dtype=dtype), _mm(q.T, e1), lower=False)
        dx = precond_apply(_mm(V[:m].T, y))
        return x + dx

    def cond(s):
        x, rn, it = s
        return jnp.logical_and(it < max_restarts, rn > tol)

    def body(s):
        x, rn, it = s
        x = arnoldi_cycle(x)
        r = b - matvec(x)
        return (x, jnp.sqrt(jnp.vdot(r, r)), it + 1)

    x0 = jnp.zeros_like(b)
    x, rnorm, restarts = jax.lax.while_loop(
        cond, body, (x0, bnorm, jnp.int32(0)))
    return x, restarts * m, rnorm, bnorm


@register_solver("gmres")
class GmresSolver(Solver):

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, precond="jacobi",
                 rtol=1e-8, maxiter=None, restart=30, layout="auto",
                 ordering="none", **params):
        super().__init__(A, **params)
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.restart = int(restart)
        maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        self.max_restarts = max(1, -(-maxiter // self.restart))

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

        rtol_c, mr, m = self.rtol, self.max_restarts, self.restart
        dt = self.dtype

        @jax.jit
        def _solve(op, pstate, b):
            bp = b if perm_dev is None else b[perm_dev]
            mv = lambda v: apply_mv(op, v)
            pc = lambda r: papply(pstate, r)
            x, iters, rnorm, bnorm = gmres_loop(mv, pc, bp, rtol_c, mr, m, dt)
            if inv_dev is not None:
                x = x[inv_dev]
            return x, iters, rnorm, bnorm

        self._jit_solve = _solve

    def solve(self, b) -> SolveResult:
        x, iters, rnorm, bnorm = self._jit_solve(self._op, self._pstate,
                                                 jnp.asarray(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0)

    def solve_fn(self):
        op, pstate, jit_solve = self._op, self._pstate, self._jit_solve
        return lambda b: jit_solve(op, pstate, b)[0]
