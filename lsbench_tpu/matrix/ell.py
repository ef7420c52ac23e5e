"""Padded-CSR (ELL) device layout — the workhorse format.

The reference workload has 22–25 nnz/row with low variance (SURVEY.md §2.1),
so padding every row to the max width wastes little and buys static shapes:
`vals`/`cols` become dense (n_pad, k) arrays, SpMV becomes one gather + one
row reduction, and everything jits with no dynamic shapes. Padding slots hold
col=0 / val=0, so arbitrary gathers stay in-bounds and contribute nothing.

Rows are padded to a multiple of `row_align` (default 8; kernels that
tile rows ask for their tile) and the width k to a multiple of
`width_align`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_pytree_node_class
@dataclass
class EllMatrix:
    """Device-resident padded-row sparse matrix.

    vals:  (n_pad, k) dtype    — padded entries (0 in padding)
    cols:  (n_pad, k) int32    — column of each entry (0 in padding)
    nrows/ncols/nnz are static (aux) data.
    """

    vals: jax.Array
    cols: jax.Array
    nrows: int
    ncols: int
    nnz: int

    # pytree plumbing (static shape metadata goes in aux)
    def tree_flatten(self):
        return (self.vals, self.cols), (self.nrows, self.ncols, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        vals, cols = children
        return cls(vals, cols, *aux)

    @property
    def n_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def k(self) -> int:
        return self.vals.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_csr(
        A: CsrMatrix,
        dtype=jnp.float64,
        row_align: int = 8,
        width_align: int = 1,
    ) -> "EllMatrix":
        n_pad = _round_up(A.nrows, row_align)
        counts = np.diff(A.offs)
        k = _round_up(max(int(counts.max()), 1), width_align)

        cols = np.zeros((n_pad, k), dtype=np.int32)
        vals = np.zeros((n_pad, k), dtype=np.float64)
        # Scatter each nnz to (row, slot) where slot is its index within row.
        r = A.row_indices()
        slot = np.arange(A.nnz) - A.offs[r]
        cols[r, slot] = A.cols
        vals[r, slot] = A.vals
        return EllMatrix(
            vals=jnp.asarray(vals, dtype=dtype),
            cols=jnp.asarray(cols),
            nrows=A.nrows,
            ncols=A.ncols,
            nnz=A.nnz,
        )

    def astype(self, dtype) -> "EllMatrix":
        return EllMatrix(self.vals.astype(dtype), self.cols,
                         self.nrows, self.ncols, self.nnz)

    def matvec(self, x: jax.Array) -> jax.Array:
        from lsbench_tpu.ops.spmv import spmv_ell
        return spmv_ell(self, x)

    def padded_x(self, x: jax.Array) -> jax.Array:
        """Pad an ncols-vector so gathers from padded rows are in-bounds."""
        if x.shape[0] == self.ncols:
            return x
        raise ValueError(f"x has {x.shape[0]} entries, expected {self.ncols}")
