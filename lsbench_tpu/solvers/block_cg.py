"""Multi-RHS (block) CG: solve A X = B for k right-hand sides at once.

An extension beyond the reference (every lsbench backend is single-RHS —
lsbench.c:158-160 builds one r): the SpMV is bandwidth-bound on the
matrix stream, so batching k RHS into one SpMM does k× the numerical work
for the same matrix traffic.

Two inner iterations are provided:

- method="shared" (default): TRUE block CG — all k columns share one
  block-Krylov subspace that grows k vectors per iteration, so the
  iteration count approaches the single-RHS count instead of k× it.
  The variant is BCGrQ (Dubrulle's retooled block CG: the residual
  block is kept QR-factored, R = Q·rho with Q orthonormal), which is
  the numerically stable form — plain O'Leary block CG breaks down in
  f32 when direction columns become linearly dependent. Orthonormal-
  ization is two-pass CholQR (two k×k Gram matmuls + triangular
  solves — GEMM-shaped, no Householder loops), with a trace-scaled
  diagonal shift so rank collapse (converged/parallel columns) yields
  fresh orthonormal directions instead of NaNs — the breakdown-free
  behavior. Preconditioning is split Jacobi (A → S·A·S with
  S = diag(d)^{-1/2}), which preserves the orthonormal-residual
  invariant the recurrence relies on.

- method="simultaneous": k independent PCG recurrences vectorized over
  columns (one fused SpMM per iteration, per-column alpha/beta,
  converged columns frozen by masking). Exact per column; used as the
  fallback for non-diagonal preconditioners, where split
  preconditioning is unavailable.

Precision follows solvers/refine.py: f32 inner block-CG + f64 residual
refinement per column, reaching the reference's direct tolerance 1e-10.
"""

from __future__ import annotations

import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver


def _cdots(u, v):
    """Per-column dot products: (n,k),(n,k) -> (k,)."""
    return jnp.einsum("nk,nk->k", u, v, precision=jax.lax.Precision.HIGHEST)


def _cholqr2(Y, eps_rel=1e-6):
    """Two-pass CholQR: Y = Q @ C with Q ~orthonormal (f32-stable).

    One pass is a k×k Gram matmul + Cholesky + triangular solve (all
    small dense ops — no Householder column loop, which XLA serializes);
    the second pass squares away the first's rounding so Q is orthonormal
    to f32 eps even when cond(Y) ~ 1e3. The trace-scaled shift keeps the
    Cholesky alive under rank collapse (a converged column's residual
    ~0): the shifted Gram is SPD, so the factor exists and the deficient
    column comes back as SOME unit vector — a fresh search direction
    rather than a breakdown (the Ji-Li breakdown-free behavior).
    """
    import jax.scipy.linalg as jsl

    k = Y.shape[1]
    eye = jnp.eye(k, dtype=Y.dtype)

    def one_pass(Yc):
        G = Yc.T @ Yc
        shift = eps_rel * (jnp.trace(G) / k) + jnp.asarray(1e-30, Y.dtype)
        C = jnp.linalg.cholesky(G + shift * eye).T  # upper: Yc = Q C
        Cinv = jsl.solve_triangular(C, eye, lower=False)
        return Yc @ Cinv, C

    Q1, C1 = one_pass(Y)
    Q2, C2 = one_pass(Q1)
    return Q2, C2 @ C1


def block_cg_shared_loop(matmat, ihalf, B, rtol, maxiter, dtype,
                         qr="householder"):
    """Jittable shared-subspace block CG (BCGrQ) with split Jacobi.

    Solves A D = B for all columns in ONE block-Krylov space. matmat:
    (n,k)->(n,k) SpMM for A; ihalf: (n,) = diag(A)^{-1/2} (ones for no
    preconditioning). Internally iterates on the split-preconditioned
    Ã = S A S (S = diag(ihalf)), whose residual block is kept factored
    R̃ = Q·rho with Q orthonormal:

        Z   = Ã D
        xi  = (Dᵀ Z)⁺                       (eigh pseudo-inverse, k×k)
        Y  += D (xi rho)
        (Q, gamma) = qr(Q − Z xi)
        rho = gamma rho
        D   = Q + D gammaᵀ

    Breakdown safety needs BOTH guards: the eigh-thresholded
    pseudo-inverse for xi (a deficient direction would otherwise be
    amplified by 1/shift ~ 1e7 in f32 — the Ji-Li breakdown-free
    inverse), and an orthonormalization that stays orthonormal at rank
    collapse. qr="householder" (default) uses jnp.linalg.qr, whose
    reflector completion emits fresh UNIT directions for collapsed
    columns — measured to converge through exact rank-1 RHS blocks.
    qr="cholqr2" is the two-pass CholQR (pure GEMM + k×k Cholesky, no
    Householder column loop) — faster per iteration but its shifted Gram
    leaves collapsed columns at tiny norm, breaking the Q-orthonormal
    invariant the recurrence relies on; only safe for well-conditioned
    full-rank RHS blocks.

    Per-column stopping on the columns of rho (||R̃ e_j|| = ||rho e_j||
    exactly, Q orthonormal). Returns (X, block_iters, rnorm (k,),
    bnorm (k,)) in the ORIGINAL (unscaled) variables; norms are of the
    split-preconditioned residual, which the caller's outer f64
    refinement re-checks in the true norm.

    Every matmul here traces under HIGHEST precision: an f32 product
    that runs in TF32 (about three decimal digits) corrupts the Gram
    products and the orthonormalization enough to multiply the iteration
    count.
    """
    B = B.astype(dtype)
    ihalf = ihalf.astype(dtype)
    orthonormalize = (_cholqr2 if qr == "cholqr2"
                      else lambda Y: jnp.linalg.qr(Y, mode="reduced"))

    with jax.default_matmul_precision("highest"):
        Bt = B * ihalf[:, None]
        Q0, rho0 = orthonormalize(Bt)
        bnorm2 = jnp.sum(rho0 * rho0, axis=0)
        tol2 = (rtol ** 2) * bnorm2
        k = B.shape[1]

        def amat(D):
            return matmat(D * ihalf[:, None]) * ihalf[:, None]

        def cond(state):
            _, _, _, rho, it = state
            return jnp.logical_and(
                it < maxiter,
                jnp.any(jnp.sum(rho * rho, axis=0) > tol2))

        def body(state):
            Y, Q, D, rho, it = state
            Z = amat(D)
            M = D.T @ Z
            lam, V = jnp.linalg.eigh(M)
            lam_max = jnp.maximum(lam[-1], jnp.asarray(1e-30, dtype))
            inv_lam = jnp.where(lam > 1e-5 * lam_max, 1.0 / lam, 0.0)
            xi = (V * inv_lam[None, :]) @ V.T
            Y = Y + D @ (xi @ rho)
            Qn, gamma = orthonormalize(Q - Z @ xi)
            rho = gamma @ rho
            D = Qn + D @ gamma.T
            return (Y, Qn, D, rho, it + 1)

        Y0 = jnp.zeros_like(Bt)
        Y, Q, D, rho, iters = jax.lax.while_loop(
            cond, body, (Y0, Q0, Q0, rho0, jnp.int32(0)))
        X = Y * ihalf[:, None]
        rnorm = jnp.sqrt(jnp.sum(rho * rho, axis=0))
    return X, iters, rnorm, jnp.sqrt(bnorm2)


def block_cg_loop(matmat, pc_cols, B, rtol, maxiter, dtype):
    """Jittable simultaneous PCG over columns.

    matmat: (n,k)->(n,k) SpMM; pc_cols: (n,k)->(n,k) columnwise
    preconditioner apply. Returns (X, iters, rnorm (k,), bnorm (k,)).
    Converged columns are frozen via alpha/beta masking, so their x stops
    changing and their recurrence cannot break down (pAp -> 0).
    """
    B = B.astype(dtype)
    bnorm2 = _cdots(B, B)
    tol2 = (rtol ** 2) * bnorm2

    X0 = jnp.zeros_like(B)
    R0 = B
    Z0 = pc_cols(R0)
    P0 = Z0
    rz0 = _cdots(R0, Z0)
    rr0 = _cdots(R0, R0)

    def cond(state):
        _, _, _, _, rr, it = state
        return jnp.logical_and(it < maxiter, jnp.any(rr > tol2))

    def body(state):
        X, R, P, rz, rr, it = state
        active = rr > tol2
        Q = matmat(P)
        pq = _cdots(P, Q)
        safe_pq = jnp.where(pq != 0, pq, 1.0)
        alpha = jnp.where(active, rz / safe_pq, 0.0)
        X = X + P * alpha[None, :]
        R = R - Q * alpha[None, :]
        Z = pc_cols(R)
        rz_new = _cdots(R, Z)
        rr_new = _cdots(R, R)
        safe_rz = jnp.where(rz != 0, rz, 1.0)
        beta = jnp.where(active, rz_new / safe_rz, 0.0)
        P = Z + P * beta[None, :]
        return (X, R, P, rz_new, rr_new, it + 1)

    X, R, P, rz, rr, iters = jax.lax.while_loop(
        cond, body, (X0, R0, P0, rz0, rr0, jnp.int32(0)))
    return X, iters, jnp.sqrt(rr), jnp.sqrt(bnorm2)


@register_solver("block_cg")
class BlockCgSolver(Solver):
    """Block PCG with f32 SpMM inner + f64 residual outer.

    solve(B) takes B of shape (n, k) (a 1-D b is treated as k=1). The
    reported relres/converged are over the worst column.
    """

    def __init__(self, A: CsrMatrix, rtol=1e-10, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, method="shared", qr="householder",
                 **params):
        super().__init__(A, **params)
        del dtype, layout  # fixed structure: f32 SpMM inner / f64 outer
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        if method not in ("shared", "simultaneous"):
            raise ValueError(f"unknown block_cg method '{method}' "
                             "(shared | simultaneous)")
        # The shared-subspace recurrence needs a SPLIT (symmetric)
        # preconditioner; only diagonal ones split explicitly.
        if method == "shared" and precond not in ("jacobi", "none"):
            method = "simultaneous"
        self.method = method
        if qr not in ("householder", "cholqr2"):
            raise ValueError(f"unknown block_cg qr '{qr}' "
                             "(householder | cholqr2)")
        self.qr = qr

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
        if self.method == "shared":
            # Split Jacobi: S = diag(|d|)^{-1/2} (abs guards indefinite
            # diagonals; zero diagonals fall back to identity scaling).
            d = np.abs(Ap.diagonal())
            ih = np.where(d > 0.0, 1.0 / np.sqrt(np.where(d == 0, 1.0, d)),
                          1.0)
            if precond == "none":
                ih = np.ones_like(ih)
            self._pstate = jnp.asarray(ih, dtype=jnp.float32)
            papply = None
        else:
            self._pstate, papply = get_preconditioner(precond)(
                Ap, jnp.float32, **(precond_params or {}))

        rtol_c, inner_rtol_c = self.rtol, self.inner_rtol
        maxiter_c, max_refine_c = self.maxiter, self.max_refine
        perm_dev, inv_dev = self._perm, self._inv
        method_c, qr_c = self.method, self.qr

        @jax.jit
        def _solve(op, op64, pstate, B):
            B = B.astype(jnp.float64)
            Bp = B if perm_dev is None else B[perm_dev]
            k = Bp.shape[1]
            bnorm2 = _cdots(Bp, Bp)
            tol2 = (rtol_c ** 2) * bnorm2

            mm = lambda V: ell_mm(op, V)
            if method_c == "shared":
                pc_cols = None
            else:
                pc_cols = jax.vmap(lambda r: papply(pstate, r),
                                   in_axes=1, out_axes=1)

            def refine_cond(s):
                X, R, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c,
                                       jnp.any(rr > tol2))

            def refine_body(s):
                X, R, rr, it_total, passes = s
                scale = jnp.sqrt(rr)                       # (k,)
                safe = jnp.where(scale > 0, scale, 1.0)
                R32 = (R.astype(jnp.float32)
                       * (1.0 / safe).astype(jnp.float32)[None, :])
                if method_c == "shared":
                    D32, inner_iters, _, _ = block_cg_shared_loop(
                        mm, pstate, R32, inner_rtol_c, maxiter_c,
                        jnp.float32, qr=qr_c)
                else:
                    D32, inner_iters, _, _ = block_cg_loop(
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
        rnorm = np.asarray(rnorm)
        bnorm = np.asarray(bnorm)
        relres_cols = np.where(bnorm > 0, rnorm / np.maximum(bnorm, 1e-300),
                               0.0)
        relres = float(relres_cols.max())
        x = X[:, 0] if squeeze else X
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol,
                           extra={"refine_passes": int(passes),
                                  "method": self.method,
                                  "nrhs": int(B.shape[1]),
                                  "relres_cols": relres_cols.tolist(),
                                  # Structurally f32 SpMM inner + f64
                                  # residual outer, whatever --precision
                                  # said; surfaced first-class so the
                                  # record's precision column shows it.
                                  "precision_mode": "fp32_ir"})

    @staticmethod
    def _solve_x(jit_solve, args, B):
        """Shared shape shim: promote a 1-D b to (n,1) and squeeze back.

        The jitted solve indexes B.shape[1]; the bench harness calls
        solve_fn with the raw 1-D RHS (r[i]=i, lsbench.c:158-160), so the
        promotion solve() does must happen here too."""
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
        return ((lambda args, B: BlockCgSolver._solve_x(jit_solve, args, B)),
                (self._op, self._op64, self._pstate))
