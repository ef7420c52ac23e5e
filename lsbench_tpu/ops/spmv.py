"""SpMV kernels — the framework's `matmul`.

Every solver iteration in the reference bottoms out in a vendored SpMV
(AMG smoothers, Krylov iterations — SURVEY.md §3 "hot loops"). Here SpMV is
first-party:

- `spmv_ell`: gather-based padded-row SpMV in pure jnp. XLA fuses the
  gather, multiply, and row-sum into one kernel; the op is memory-
  bandwidth bound, which is the roofline for this workload (~23 nnz/row →
  ≈12–20 B/nnz moved).
- solvers/cg.py::build_matvec maps layout names onto SpMV operators.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lsbench_tpu.matrix.ell import EllMatrix


def spmv_ell(A: EllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for a padded-row (ELL) matrix. Returns shape (nrows,).

    x must have A.ncols entries; the result is unpadded.
    """
    # Gather x at every stored column; padding slots gather x[0] but carry
    # val 0, so they contribute nothing.
    xa = x.astype(A.vals.dtype)
    prod = A.vals * xa[A.cols]
    y = jnp.sum(prod, axis=1)
    return y[: A.nrows]


def spmv_ell_padded(A: EllMatrix, x_pad: jax.Array) -> jax.Array:
    """Like spmv_ell but keeps the padded row dimension (for fused pipelines)."""
    prod = A.vals * x_pad.astype(A.vals.dtype)[A.cols]
    return jnp.sum(prod, axis=1)
