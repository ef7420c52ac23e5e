"""Synthetic SPD test matrices.

The reference ships pressure-Poisson-type SPD matrices (tests/tj7a_*,
tests/xn3b_*; measured SPD in SURVEY.md §2.1). These generators produce
structurally similar workloads of any size so benchmarks and tests do not
depend on the reference data files being present.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


def poisson_2d(nx: int, ny: int | None = None) -> CsrMatrix:
    """5-point Laplacian on an nx × ny grid (SPD, 0-based)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return CsrMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), nrows=n, ncols=n)


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None) -> CsrMatrix:
    """7-point Laplacian on an nx × ny × nz grid (SPD, 0-based)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 6.0)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(1, None)
        hi[axis] = slice(None, -1)
        add(idx[tuple(lo)], idx[tuple(hi)], -1.0)
        add(idx[tuple(hi)], idx[tuple(lo)], -1.0)
    return CsrMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), nrows=n, ncols=n)


def sem_2d(ne: int, p: int = 2, shift: float = 1e-3,
           seed: int | None = None) -> CsrMatrix:
    """SEM-type SPD matrix: ne × ne spectral elements of order p on a 2-D
    quad mesh; every element's (p+1)² nodes form a clique (the assembled
    pressure-Poisson pattern of tj7a/xn3b — SURVEY.md §2.1: ~23 nnz/row
    at p=2 with strong row-width skew: interior nodes couple within one
    element, edge nodes within two, corner nodes within four).

    Values: sum of element clique Laplacians (m·I − J per element, PSD)
    + `shift`·I — SPD with the SEM sparsity pattern; conditioning is mild
    (the pattern, skew, and bandwidth are what the scale experiments
    need, not the reference's exact spectrum). With a `seed`, each
    element's clique is scaled by a coefficient drawn uniformly from
    [0.5, 2) (a variable-coefficient operator, reproducible from the
    seed); without one every coefficient is 1."""
    nn = ne * p + 1
    n = nn * nn
    idx = np.arange(n).reshape(nn, nn)
    m = (p + 1) ** 2
    # Node ids of every element: (ne*ne, p+1, p+1) windows.
    ex = np.arange(ne) * p
    wins = idx[ex[:, None, None, None] + np.arange(p + 1)[None, None, :, None],
               ex[None, :, None, None] + np.arange(p + 1)[None, None, None, :]]
    nodes = wins.reshape(ne * ne, m)
    # Clique Laplacian per element: A_e = m·I − 1 (off-diag −1, diag m−1).
    r = np.repeat(nodes, m, axis=1).ravel()
    c = np.tile(nodes, (1, m)).ravel()
    v = np.where(r == c, float(m - 1), -1.0)
    if seed is not None:
        coef = np.random.default_rng(seed).uniform(0.5, 2.0, ne * ne)
        v = v * np.repeat(coef, m * m)
    dr = np.arange(n)
    return CsrMatrix.from_coo(
        np.concatenate([r, dr]), np.concatenate([c, dr]),
        np.concatenate([v, np.full(n, shift)]), nrows=n, ncols=n)


def random_spd(n: int, nnz_per_row: int = 23, seed: int = 0) -> CsrMatrix:
    """Random diagonally-dominant SPD matrix with ~nnz_per_row entries/row.

    Mimics the reference workload statistics (22–25 nnz/row, SURVEY.md §2.1).
    """
    rng = np.random.default_rng(seed)
    k = max(1, (nnz_per_row - 1) // 2)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=rows.size)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = -rng.random(rows.size)
    # Symmetrize.
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals]) * 0.5
    off = CsrMatrix.from_coo(r, c, v, nrows=n, ncols=n)
    # Diagonal dominance: diag = 1 + sum|offdiag| per row.
    rowsum = np.zeros(n)
    np.add.at(rowsum, off.row_indices(), np.abs(off.vals))
    dr = np.arange(n)
    return CsrMatrix.from_coo(
        np.concatenate([off.row_indices(), dr]),
        np.concatenate([off.cols, dr]),
        np.concatenate([off.vals, 1.0 + rowsum]),
        nrows=n, ncols=n)
