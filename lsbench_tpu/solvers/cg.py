"""Preconditioned conjugate gradient — the minimum end-to-end slice.

The reference's Krylov capability is Ginkgo BiCGSTAB+Jacobi with an implicit
residual-norm stop at 1e-4 of the initial residual (ginkgo.cpp:55-64). The
workload is SPD (SURVEY.md §2.1), so CG is the natural native solver; a
BiCGSTAB twin (solvers/bicgstab.py) covers the nonsymmetric role.

The entire iteration runs inside one `jax.jit` via `lax.while_loop` — no
host round-trips per iteration. The two dot products per iteration are
computed from one stacked reduction (`_fused_dots`) so the distributed
version needs exactly one `psum` per iteration. The matvec runs in the
chosen SpMV layout (`build_matvec`), optionally after a host-side
symmetric reordering (the reference applies the same permutation before
its device solve, cusparse.c:66-96).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.ell import EllMatrix
from lsbench_tpu.ops.spmv import spmv_ell
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu.solvers.preconditioners import get_preconditioner


def _fused_dots(*pairs):
    """Compute several dot products with one fused reduction."""
    stacked = jnp.stack([jnp.vdot(a, b) for (a, b) in pairs])
    return tuple(stacked[i] for i in range(len(pairs)))


def cg_loop(matvec, precond_apply, b, rtol, maxiter, dtype):
    """Jittable PCG. Returns (x, iters, rnorm, bnorm)."""
    b = b.astype(dtype)
    bnorm = jnp.sqrt(jnp.vdot(b, b))
    tol2 = (rtol * bnorm) ** 2

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond_apply(r0)
    p0 = z0
    rz0, rr0 = _fused_dots((r0, z0), (r0, r0))

    def cond(state):
        _, _, _, _, rr, it = state
        return jnp.logical_and(it < maxiter, rr > tol2)

    def body(state):
        x, r, p, rz, rr, it = state
        Ap = matvec(p)
        pAp, = _fused_dots((p, Ap))
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond_apply(r)
        rz_new, rr_new = _fused_dots((r, z), (r, r))
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, rr_new, it + 1)

    x, r, p, rz, rr, iters = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, rr0, jnp.int32(0)))
    return x, iters, jnp.sqrt(rr), bnorm


LAYOUTS = ("ell", "ell_triton")

# Widest row (ELL width k) that "auto" gives the Triton kernel. Its
# programs run their k slots one after another, so a wide operator with
# few rows leaves the card waiting on loads, where XLA's fusion spreads
# the slots over the card: on the H100, AMG hierarchies whose coarse
# operators have k = 33-887 solved 1.3x (amgx) and 16x (paralmond) slower
# with every level on Triton, while k = 25 won at every n from 1,089 to
# 263,169 (PERF.md, AMG levels on the Triton kernel).
TRITON_MAX_K = 32


def resolve_layout(layout: str, dtype, A: CsrMatrix) -> str:
    """Map a layout name onto the SpMV layout built for the matrix `A`.

    "auto" is the measured winner where it can run: on the GPU the
    slot-major ELL kernel through Pallas' Triton route (ops/spmv_triton.py;
    PERF.md, SpMV candidates) for rows of at most TRITON_MAX_K entries,
    else and elsewhere XLA's fused ELL gather.
    """
    del dtype  # the same winner in f64 and f32
    if layout == "auto":
        if jax.default_backend() != "gpu":
            return "ell"
        widest = int(np.diff(A.offs).max(initial=0))
        return "ell_triton" if widest <= TRITON_MAX_K else "ell"
    if layout not in LAYOUTS:
        raise ValueError(f"unknown SpMV layout '{layout}' "
                         f"(choose from auto, {', '.join(LAYOUTS)})")
    return layout


def build_matvec(A: CsrMatrix, dtype, layout: str):
    """Return (apply_fn, op_pytree, stream_bytes) for the chosen layout.

    `apply_fn(op, v)` takes the operator pytree explicitly so solvers can
    pass it as a jit ARGUMENT — closing over device arrays turns them into
    captured jit constants, which bloat the executable and add
    per-dispatch cost proportional to their size.
    """
    if layout == "ell_triton":
        from lsbench_tpu.ops.spmv_triton import EllSlotMajor, spmv_ell_triton
        op = EllSlotMajor.from_csr(A, dtype=dtype)
        return (lambda op, v: spmv_ell_triton(op, v)), op, op.bytes_streamed
    ell = EllMatrix.from_csr(A, dtype=dtype)
    stream = ell.vals.size * (ell.vals.dtype.itemsize + 4)
    return (lambda op, v: spmv_ell(op, v)), ell, stream


@register_solver("cg")
class CgSolver(Solver):
    """Jacobi- (or AMG-) preconditioned CG with optional RCM/AMD
    reordering."""

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, precond="jacobi",
                 rtol=1e-8, maxiter=None, layout="auto", ordering="none",
                 precond_params=None, **params):
        super().__init__(A, **params)
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        self.layout = resolve_layout(layout, self.dtype, A)
        self.ordering = ordering

        from lsbench_tpu.ordering import get_ordering
        perm = get_ordering(ordering, A)
        self._identity_perm = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if self._identity_perm else A.permuted(perm)
        self._perm_dev = None if self._identity_perm else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        self._inv_dev = None if self._identity_perm else jnp.asarray(inv)

        apply_mv, self._op, self.stream_bytes = build_matvec(
            Ap, self.dtype, self.layout)
        self._mv = lambda v: apply_mv(self._op, v)
        self._pstate, papply = get_preconditioner(precond)(
            Ap, self.dtype, **(precond_params or {}))

        rtol_c, maxiter_c = self.rtol, self.maxiter
        dt = self.dtype
        perm_dev, inv_dev = self._perm_dev, self._inv_dev

        # Operator + preconditioner state enter as jit ARGUMENTS (captured
        # device-array constants add per-dispatch cost and executable size).
        @jax.jit
        def _solve(op, pstate, b):
            bp = b if perm_dev is None else b[perm_dev]
            mv = lambda v: apply_mv(op, v)
            pc = lambda r: papply(pstate, r)
            x, iters, rnorm, bnorm = cg_loop(mv, pc, bp, rtol_c, maxiter_c, dt)
            if inv_dev is not None:
                x = x[inv_dev]
            return x, iters, rnorm, bnorm

        self._jit_solve = _solve

    def solve(self, b) -> SolveResult:
        b = jnp.asarray(b)
        x, iters, rnorm, bnorm = self._jit_solve(self._op, self._pstate, b)
        rnorm = float(rnorm)
        bnorm = float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0)

    def solve_fn(self):
        op, pstate = self._op, self._pstate
        jit_solve = self._jit_solve
        return lambda b: jit_solve(op, pstate, b)[0]
