"""Device-side blocked band Cholesky — dense-panel numeric factorization.

The reference's default backend factors on the host CPU (CHOLMOD,
cholmod.c:68; supernodal dense frontal matrices, cholmod-impl.h:26).
SURVEY.md §7.4 calls for the device equivalent: dense panel factorization.
Its shape here is a *blocked band* factor:

- RCM ordering (ordering/rcm.py) concentrates the matrix inside a band of
  half-width w; Cholesky fill of a banded SPD matrix stays inside the band,
  so the band IS the supernodal structure — one dense panel per block step,
  no symbolic phase at all.
- The factorization is a `lax.scan` over n/nb pivot-block steps carrying a
  dense (w+nb)×(w+nb) working window W. Per step:
      Ld = chol(W[:nb,:nb])            nb×nb dense Cholesky
      Lp = W[nb:,:nb] · Ld⁻ᵀ           w×nb triangular solve
      T  = W[nb:,nb:] − Lp·Lpᵀ          w×w SYRK (the trailing update)
  then the window shifts by nb rows and the next band slab streams in.
  Static shapes, no data-dependent control flow — XLA-friendly by
  construction, and every flop is a dense matrix op.
- Solves are blocked band substitutions: a scan carrying the last w
  entries of x, one nb×nb triangular solve + one w×nb matvec per step.

Cost: n/nb steps × O((w+nb)²·nb) flops = O(n·(w+nb)²) — the classic band
factor cost, all on device. For the reference workload (RCM widths 200–600
at n=3.5k–6.4k) and 2-D-Poisson-type matrices (w ≈ √n), this factors
n≈50k entirely on the device.

f64 protocol: factor in f32 on device + f64-residual iterative
refinement (the CholeskyIrSolver pattern).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_layout(A: CsrMatrix, nb: int = 128):
    """Host: half-bandwidth + dense scan inputs for the banded factor.

    Returns (W0, slabs, nsteps, w, n_pad):
      W0     (m, m)            initial symmetric window, m = w + nb
      slabs  (nsteps, nb, m)   incoming rows per step, strictly-lower +
                               half-diagonal (added as S + Sᵀ in-kernel)
    Rows beyond n get identity diagonal (their solution entries are 0 for
    padded b). Requires pattern-symmetric A (use the symmetric part).
    """
    n = A.nrows
    r, c, v = A.to_coo()
    w = int(np.abs(r - c).max(initial=0))
    w = _round_up(max(w, nb), nb)
    m = w + nb
    n_pad = _round_up(n, nb) + m  # extra window worth of identity tail
    nsteps = (n_pad - m) // nb + 1  # step 0 consumes W0; then slabs

    # Dense band rows: dense[i] holds A[i, i-w .. i] at positions 0..w.
    lower = c <= r
    rl, cl, vl = r[lower], c[lower], v[lower]
    band = np.zeros((n_pad, w + 1))
    band[rl, w - (rl - cl)] = vl
    band[np.arange(n, n_pad), w] = 1.0  # identity tail

    # Initial window: rows 0..m-1, symmetric dense.
    W0 = np.zeros((m, m))
    for t in range(m):
        lo = max(0, t - w)
        W0[t, lo:t + 1] = band[t, w - (t - lo):w + 1]
    W0 = W0 + W0.T - np.diag(np.diag(W0))

    # Slabs: after pivot step j, rows m + j*nb .. m + (j+1)*nb - 1 enter
    # the window (the final step needs none; factor_band appends a zero
    # slab).
    n_slab = nsteps - 1
    slabs = np.zeros((n_slab, nb, m))
    for j in range(n_slab):
        base = m + j * nb
        for t in range(nb):
            i = base + t
            # window row = w + t; cols i-w..i → window cols t..w+t
            row = band[i, :].copy()
            row[-1] *= 0.5  # half diagonal: S + Sᵀ restores it
            slabs[j, t, t:w + t + 1] = row
    return W0, slabs, nsteps, w, n_pad


@jax.tree_util.register_pytree_node_class
class BandFactor:
    """Stacked band factor: Ld (nsteps, nb, nb), Lp (nsteps, w, nb)."""

    def __init__(self, Ld, Lp, n, nb, w, n_pad):
        self.Ld, self.Lp = Ld, Lp
        self.n, self.nb, self.w, self.n_pad = n, nb, w, n_pad

    def tree_flatten(self):
        return (self.Ld, self.Lp), (self.n, self.nb, self.w, self.n_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def factor_band(W0, slabs, *, nb: int):
    """Device blocked band Cholesky (see module docstring). Jittable."""
    m = W0.shape[0]
    w = m - nb

    def step(W, slab):
        Ld = jax.lax.linalg.cholesky(W[:nb, :nb])
        # Lp = P · Ld⁻ᵀ  (solve Ld · Lpᵀ = Pᵀ).
        Lp = jsl.solve_triangular(Ld, W[nb:, :nb].T, lower=True,
                                  trans=0).T
        T = W[nb:, nb:] - jnp.matmul(
            Lp, Lp.T, precision=jax.lax.Precision.HIGHEST)
        Wn = jnp.zeros_like(W)
        Wn = Wn.at[:w, :w].set(T)
        Wn = Wn.at[w:, :].add(slab)
        Wn = Wn.at[:, w:].add(slab.T)
        return Wn, (Ld, Lp)

    # Step j pivots block j out of the carried window, then slab j (the
    # next nb incoming rows) refills it; the last step gets a zero slab.
    slabs_all = jnp.concatenate(
        [slabs, jnp.zeros((1,) + slabs.shape[1:], slabs.dtype)])
    _, (Ld, Lp) = jax.lax.scan(step, W0, slabs_all)
    return Ld, Lp


def solve_band(Ld, Lp, b_pad, *, nb: int):
    """x = (L Lᵀ)⁻¹ b via blocked band substitutions (jittable).

    b_pad length nsteps*nb (the padded system); returns same length.
    """
    nsteps, _, _ = Ld.shape
    w = Lp.shape[1]
    bb = b_pad.reshape(nsteps, nb)

    def fwd(acc, inp):
        Ldj, Lpj, bj = inp
        xj = jsl.solve_triangular(Ldj, bj - acc[:nb], lower=True)
        contrib = jnp.matmul(Lpj, xj,
                             precision=jax.lax.Precision.HIGHEST)
        acc = jnp.concatenate([acc[nb:], jnp.zeros(nb, acc.dtype)]) + contrib
        return acc, xj

    acc0 = jnp.zeros(w, dtype=b_pad.dtype)
    _, y = jax.lax.scan(fwd, acc0, (Ld, Lp, bb))

    def bwd(v, inp):
        Ldj, Lpj, yj = inp
        rhs = yj - jnp.matmul(Lpj.T, v,
                              precision=jax.lax.Precision.HIGHEST)
        xj = jsl.solve_triangular(Ldj, rhs, lower=True, trans=1)
        v = jnp.concatenate([xj, v[:w - nb]])
        return v, xj

    v0 = jnp.zeros(w, dtype=b_pad.dtype)
    _, x = jax.lax.scan(bwd, v0, (Ld, Lp, y), reverse=True)
    return x.reshape(-1)


@register_solver("cholesky_band")
class BandCholeskySolver(Solver):
    """RCM-banded blocked Cholesky with the numeric factor ON DEVICE
    (dense panels) — the CHOLMOD-role direct solver for banded workloads
    (SURVEY.md §7.4). f32 factor + f64 iterative refinement reaches the
    reference 1e-10 tolerance (cusparse.c:184)."""

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, ordering="rcm",
                 rtol=1e-10, max_refine=12, nb: int = 128,
                 max_band_mb: float = 2048.0, **params):
        super().__init__(A, **params)
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.max_refine = int(max_refine)
        self.nb = int(nb)
        n = A.nrows

        import time as _time

        from lsbench_tpu.ordering import get_ordering
        _t0 = _time.perf_counter()
        perm = get_ordering(ordering, A)
        self.setup_breakdown["ordering_s"] = _time.perf_counter() - _t0
        identity = bool(np.all(perm == np.arange(n)))
        Ap = A if identity else A.permuted(perm)
        perm_dev = None if identity else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        inv_dev = None if identity else jnp.asarray(inv)

        _t0 = _time.perf_counter()
        r, c, v = Ap.to_coo()
        sym = CsrMatrix.from_coo(np.concatenate([r, c]),
                                 np.concatenate([c, r]),
                                 np.concatenate([v, v]) * 0.5,
                                 nrows=n, ncols=n)
        W0, slabs, nsteps, w, n_pad = band_layout(sym, nb=self.nb)
        band_mb = (slabs.size + W0.size) * 4 / 1e6
        if band_mb > max_band_mb:
            raise ValueError(
                f"band layout needs {band_mb:.0f} MB (w={w}); matrix is "
                "not banded enough — use sparse_cholesky or cg_ir")
        self.bandwidth = w
        self.setup_breakdown["layout_s"] = _time.perf_counter() - _t0

        # Device factor in f32; jitted so the scan compiles once.
        _t0 = _time.perf_counter()
        f32 = jnp.float32
        Ld, Lp = jax.jit(lambda W, S: factor_band(W, S, nb=self.nb))(
            jnp.asarray(W0, f32), jnp.asarray(slabs, f32))
        jax.block_until_ready(Ld)
        self.setup_breakdown["factor_s"] = _time.perf_counter() - _t0
        self._fac = BandFactor(Ld, Lp, n, self.nb, w, n_pad)

        # f64 residual operator.
        from lsbench_tpu.matrix.ell import EllMatrix
        from lsbench_tpu.ops.spmv import spmv_ell
        self._op64 = EllMatrix.from_csr(Ap, dtype=jnp.float64)

        rtol_c, max_refine_c = self.rtol, self.max_refine
        nb_c, n_c = self.nb, n
        nsol = Ld.shape[0] * self.nb

        @jax.jit
        def _solve(fac, op64, b):
            b = b.astype(jnp.float64)
            bp = b if perm_dev is None else b[perm_dev]
            bnorm = jnp.sqrt(jnp.vdot(bp, bp))
            tol2 = (rtol_c * bnorm) ** 2

            def band_solve32(r32):
                rp = jnp.zeros(nsol, jnp.float32).at[:n_c].set(r32)
                return solve_band(fac.Ld, fac.Lp, rp, nb=nb_c)[:n_c]

            def cond(s):
                x, r, rr, rr_prev, passes = s
                return jnp.logical_and(
                    passes < max_refine_c,
                    jnp.logical_and(rr > tol2, rr < rr_prev))

            def body(s):
                x, r, rr, rr_prev, passes = s
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                r32 = r.astype(jnp.float32) * (1.0 / safe).astype(jnp.float32)
                d32 = band_solve32(r32)
                x = x + (d32 * safe.astype(jnp.float32)).astype(jnp.float64)
                r_new = bp - spmv_ell(op64, x)
                return (x, r_new, jnp.vdot(r_new, r_new), rr, passes + 1)

            x0 = jnp.zeros_like(bp)
            rr0 = jnp.vdot(bp, bp)
            x, r, rr, _, passes = jax.lax.while_loop(
                cond, body, (x0, bp, rr0, jnp.inf, jnp.int32(0)))
            if inv_dev is not None:
                x = x[inv_dev]
            return x, passes, jnp.sqrt(rr), bnorm

        self._jit_solve = _solve

    def solve(self, b) -> SolveResult:
        x, passes, rnorm, bnorm = self._jit_solve(self._fac, self._op64,
                                                  jnp.asarray(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=int(passes), relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra={"precision_mode": "fp32_ir_auto",
                                  "bandwidth": self.bandwidth,
                                  "refine_passes": int(passes)})

    def solve_fn(self):
        fac, op64, js = self._fac, self._op64, self._jit_solve
        return lambda b: js(fac, op64, jnp.asarray(b))[0]

    def solve_fn_args(self):
        js = self._jit_solve
        return ((lambda args, b: js(*args, jnp.asarray(b))[0]),
                (self._fac, self._op64))
