"""Preconditioners for the Krylov solvers.

The reference gets these from vendored libraries (Ginkgo's Jacobi,
ginkgo.cpp:57; Hypre/AmgX/parAlmond AMG). Natively: point Jacobi here;
the AMG V-cycle preconditioner lives in solvers/amg.py.

A preconditioner is `(state, apply)` where `apply(state, r) -> z` is jittable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


def identity_precond(A: CsrMatrix, dtype, **_):
    del A
    return None, lambda state, r: r


def jacobi_precond(A: CsrMatrix, dtype, **_):
    """z = D^{-1} r. Safe for zero diagonals (falls back to identity rows)."""
    d = A.diagonal()
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    inv_dev = jnp.asarray(inv, dtype=dtype)
    return inv_dev, lambda inv_dev, r: inv_dev * r


def block_jacobi_precond(A: CsrMatrix, dtype, block_size: int = 32):
    """z = blockdiag(A)⁻¹ r with dense diagonal blocks of `block_size`.

    The Ginkgo backend's Jacobi preconditioner generalizes to blocks
    (Ginkgo's Jacobi is block-capable); blocks are inverted once at setup
    (batched on device) and applied as one batched (nb,k,k)×(nb,k) matmul
    at HIGHEST precision (no TF32 for f32 blocks). Rows are taken in the solver's current ordering, so
    combining with RCM makes blocks denser.
    """
    n = A.nrows
    k = block_size
    nb = -(-n // k)
    n_pad = nb * k
    # Extract diagonal blocks on host.
    blocks = np.zeros((nb, k, k), dtype=np.float64)
    blocks[:, np.arange(k), np.arange(k)] = 1.0  # identity in padding
    r, c, v = A.to_coo()
    same = (r // k) == (c // k)
    rb, cb, vb = r[same], c[same], v[same]
    blocks[rb // k, rb % k, cb % k] = vb
    inv_blocks = jnp.asarray(np.linalg.inv(blocks), dtype=dtype)

    def apply(inv_blocks, r_vec):
        rp = jnp.zeros(n_pad, r_vec.dtype).at[:n].set(r_vec)
        z = jnp.einsum("bij,bj->bi", inv_blocks,
                       rp.reshape(nb, k).astype(inv_blocks.dtype),
                       precision=jax.lax.Precision.HIGHEST)
        return z.reshape(-1)[:n].astype(r_vec.dtype)

    return inv_blocks, apply


def _amg_precond(A: CsrMatrix, dtype, **amg_params):
    from lsbench_tpu.solvers.amg import amg_precond
    return amg_precond(A, dtype, **amg_params)


def _amg_classical_precond(A: CsrMatrix, dtype, **amg_params):
    """Classical-AMG (PMIS + damped multi-pass Jacobi-improved interp)
    V-cycle — the Hypre/AmgX-family preconditioner (hypre.c:126-188).
    Defaults are the measured-best internals on the reference workload:
    3 damped (ω=0.5) improvement passes toward the ideal -A_FF⁻¹A_FC,
    truncated to 8/row — per-cycle factors 0.15-0.33 across all seven
    reference matrices."""
    amg_params.setdefault("coarsening", "classical")
    amg_params.setdefault("theta", 0.5)
    amg_params.setdefault("interp", "jacobi")
    amg_params.setdefault("interp_passes", 3)
    amg_params.setdefault("interp_omega", 0.5)
    amg_params.setdefault("pmax", 8)
    from lsbench_tpu.solvers.amg import amg_precond
    return amg_precond(A, dtype, **amg_params)


def _ic0_precond(A: CsrMatrix, dtype, **params):
    from lsbench_tpu.solvers.ic0 import ic0_precond
    return ic0_precond(A, dtype, **params)


def chebyshev_precond(A: CsrMatrix, dtype, degree: int = 4,
                      lower: float = 0.30, **_):
    """Fixed-degree Chebyshev polynomial approximation of A⁻¹ on
    [lower·ρ, 1.1·ρ] of D⁻¹A (the Hypre cheby-smoother family,
    hypre.c:137, used here as a CG preconditioner).

    Why it earns a slot: the apply is `degree` SpMVs plus vector ops —
    no dot products, no triangular solves — so it is reduction-free
    (one psum per CG iteration still suffices when distributed) and runs
    entirely on the "auto" SpMV layout. A fixed polynomial is a fixed SPD
    operator, so CG theory holds exactly."""
    from lsbench_tpu.solvers.amg import estimate_rho_dinv_a
    from lsbench_tpu.solvers.cg import build_matvec, resolve_layout

    d = A.diagonal()
    dinv_np = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    rho = estimate_rho_dinv_a(A, dinv_np)
    lmax = 1.1 * rho
    lmin = lower * rho
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta

    apply_mv, op, _ = build_matvec(A, dtype, resolve_layout("auto", dtype, A))
    state = (op, jnp.asarray(dinv_np, dtype=dtype))
    deg = int(degree)

    def apply(state, r):
        op, dinv = state
        mv = lambda v: apply_mv(op, v).astype(r.dtype)
        rho_k = 1.0 / sigma
        res = r
        dvec = (dinv * res) / theta
        z = jnp.zeros_like(r)
        for _ in range(deg - 1):
            z = z + dvec
            res = res - mv(dvec)
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            dvec = (rho_k1 * rho_k) * dvec + (2.0 * rho_k1 / delta) * (dinv * res)
            rho_k = rho_k1
        return z + dvec

    return state, apply


PRECONDITIONERS = {
    "none": identity_precond,
    "jacobi": jacobi_precond,
    "block_jacobi": block_jacobi_precond,
    "ic0": _ic0_precond,
    "chebyshev": chebyshev_precond,
    "amg": _amg_precond,
    "amg_classical": _amg_classical_precond,
}


def get_preconditioner(name: str):
    try:
        return PRECONDITIONERS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown preconditioner '{name}'. Available: {sorted(PRECONDITIONERS)}")
