"""Host-side CSR matrix core.

The reference keeps a single C struct ``csr {nrows, base, offs, cols, vals}``
(lsbench-impl.h:22-26) assembled by `lsbench_matrix_read` (lsbench-csr.c:29-92)
with 0-based row offsets but columns left at the file's original base, which
every backend then re-corrects (or forgets to — ginkgo.cpp:26-29). Here the
host container is fully 0-based and NumPy-backed; device layouts are derived
from it (see ell.py and solvers/cg.py::build_matvec).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CsrMatrix:
    """0-based host CSR. `offs` has length nrows+1; cols sorted within rows."""

    nrows: int
    ncols: int
    offs: np.ndarray  # int64 (nrows+1,)
    cols: np.ndarray  # int32  (nnz,)
    vals: np.ndarray  # float64 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.offs[-1])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    # ------------------------------------------------------------------ build

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        nrows: int | None = None,
        ncols: int | None = None,
        sum_duplicates: bool = True,
    ) -> "CsrMatrix":
        """Assemble CSR from 0-based COO triplets.

        Matches the reference assembly semantics: entries are sorted by
        (row, col) and duplicates are *summed* (lsbench-csr.c:54-63).
        Unlike the reference — which sizes the matrix by the number of
        distinct row ids (lsbench-csr.c:65-70), silently mis-sizing matrices
        with empty rows — the row/col counts here default to max-index+1 and
        empty rows are represented correctly.
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError("rows/cols/vals must have identical shapes")
        if rows.size == 0:
            raise ValueError("matrix has zero entries")
        if rows.min() < 0 or cols.min() < 0:
            raise ValueError("negative indices in COO input")

        if nrows is None:
            nrows = int(rows.max()) + 1
        if ncols is None:
            ncols = int(cols.max()) + 1
        if rows.max() >= nrows or cols.max() >= ncols:
            raise ValueError("index exceeds given matrix shape")

        # Sort by a single composite key (faster than lexsort at RAP sizes).
        key = rows * ncols + cols
        order = np.argsort(key, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]

        if sum_duplicates:
            # Segment-sum runs of identical (row, col).
            key = key[order]
            key_change = np.empty(rows.size, dtype=bool)
            key_change[0] = True
            key_change[1:] = key[1:] != key[:-1]
            seg = np.cumsum(key_change) - 1
            uniq = int(seg[-1]) + 1
            vals = np.bincount(seg, weights=vals, minlength=uniq)
            rows = rows[key_change]
            cols = cols[key_change]

        offs = np.zeros(nrows + 1, dtype=np.int64)
        offs[1:] = np.cumsum(np.bincount(rows, minlength=nrows))
        return CsrMatrix(nrows, ncols, offs, cols.astype(np.int32), vals)

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "CsrMatrix":
        a = np.asarray(a, dtype=np.float64)
        r, c = np.nonzero(np.abs(a) > tol)
        return CsrMatrix.from_coo(r, c, a[r, c], nrows=a.shape[0], ncols=a.shape[1])

    # ------------------------------------------------------------ conversions

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        rows = self.row_indices()
        out[rows, self.cols] = self.vals
        return out

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.row_indices(), self.cols.copy(), self.vals.copy()

    def row_indices(self) -> np.ndarray:
        """Expand offs to a per-nnz row index array."""
        return np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(self.offs))

    def transpose(self) -> "CsrMatrix":
        r, c, v = self.to_coo()
        return CsrMatrix.from_coo(c, r, v, nrows=self.ncols, ncols=self.nrows,
                                  sum_duplicates=False)

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), dtype=np.float64)
        r = self.row_indices()
        on_diag = r == self.cols
        d[r[on_diag]] = self.vals[on_diag]
        return d

    # ------------------------------------------------------------- operations

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV (oracle for device kernels)."""
        x = np.asarray(x, dtype=np.float64)
        prod = self.vals * x[self.cols]
        out = np.zeros(self.nrows, dtype=np.float64)
        np.add.at(out, self.row_indices(), prod)
        return out

    def permuted(self, perm: np.ndarray) -> "CsrMatrix":
        """Symmetric permutation B = A[perm, perm] (PAP^T with P rows e_perm).

        This is the reordering step the reference delegates to
        `cusolverSpXcsrpermHost` (cusparse.c:87-96).
        """
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.nrows,) or self.nrows != self.ncols:
            raise ValueError("permutation must match a square matrix")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.nrows)
        r, c, v = self.to_coo()
        return CsrMatrix.from_coo(inv[r], inv[c], v, nrows=self.nrows,
                                  ncols=self.ncols, sum_duplicates=False)

    def symmetry_error(self) -> float:
        """max|A - A^T| — the workload SPD check used by the survey."""
        r, c, v = self.to_coo()
        # Stack A and -A^T as COO and sum duplicates: result holds A - A^T.
        diff = CsrMatrix.from_coo(
            np.concatenate([r, c]), np.concatenate([c, r]),
            np.concatenate([v, -v]),
            nrows=max(self.shape), ncols=max(self.shape))
        return float(np.abs(diff.vals).max()) if diff.nnz else 0.0

    def lower_triangle(self, strict: bool = False) -> "CsrMatrix":
        r, c, v = self.to_coo()
        keep = (c < r) if strict else (c <= r)
        return CsrMatrix.from_coo(r[keep], c[keep], v[keep], nrows=self.nrows,
                                  ncols=self.ncols, sum_duplicates=False)
