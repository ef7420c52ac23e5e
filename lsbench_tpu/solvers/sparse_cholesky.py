"""Sparse direct Cholesky — the scalable CHOLMOD-role path.

The reference's default backend factors on the host CPU (CHOLMOD with
`useGPU=0`, cholmod.c:68) after a fill-reducing ordering chosen inside
`analyze` (cholmod-impl.h:25), then times only the triangular solves
(cholmod-impl.h:44-63). This module mirrors that split natively:

- host symbolic phase: elimination tree (Liu's algorithm with path
  compression), per-row fill pattern by etree reach, behind native
  approximate minimum degree (mindeg.cpp::lsb_amd);
- host numeric phase: left-looking sparse column Cholesky over the exact
  fill pattern (flat CSC arrays; native C++ with a Python fallback);
- solve phase (the timed region, cholmod-impl.h:44-63) — THREE
  schedules (`schedule=`):
  * "host" (the AUTO default when the native lib builds): CSC two-sweep
    substitution on the CPU — exactly where the reference's default
    backend solves (cholmod.c:68 useGPU=0);
  * "block": partitioned-inverse device sweep — rows level-sorted into
    256-blocks, within-block couplings inverted at setup (batched
    triangular solves on device from compact ~nnz uploads), ~n/256
    sequential steps of gather + segment-sum + one HIGHEST-precision
    (256,256)@(256,k) matmul; multi-RHS rides natively and amortizes
    the gathers over the k columns;
  * "level": the round-4 level-scheduled `lax.scan` (segmented flat
    packing), kept for comparison and as ic0.py's apply machinery.

The dense Cholesky (solvers/direct.py) remains the faster choice at
reference scale (n ≤ ~10⁴ dense fits comfortably); this path removes the
O(n²) memory wall for larger problems.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.native import NativeUnavailable
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver


# ----------------------------------------------------------- symbolic phase

def elimination_tree(A: CsrMatrix) -> np.ndarray:
    """Liu's etree with path compression; A square, pattern symmetric.
    Runs natively (native/spchol.cpp) when the toolchain is available,
    with this Python implementation as the fallback (identical result)."""
    n = A.nrows
    try:
        from lsbench_tpu.native.spchol import etree
        return etree(n, A.offs, A.cols)
    except NativeUnavailable:
        pass
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    offs, cols = A.offs, A.cols
    for i in range(n):
        for k in cols[offs[i]:offs[i + 1]]:
            k = int(k)
            if k >= i:
                continue
            # Walk up the (compressed) ancestor chain from k to i.
            while True:
                a = ancestor[k]
                ancestor[k] = i
                if a == -1:
                    if parent[k] == -1:
                        parent[k] = i
                    break
                if a == i:
                    break
                k = a
    return parent


def symbolic_rows(A: CsrMatrix, parent: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Fill pattern of L by rows (strictly-lower part), via etree reach:
    row i's pattern is the union of paths k→…→i in the etree for each
    k < i with A[i,k] ≠ 0. Returns CSR-style (offs, cols), cols ascending.
    Native when available, like `elimination_tree`."""
    n = A.nrows
    try:
        from lsbench_tpu.native.spchol import symbolic_rows as native_rows
        return native_rows(n, A.offs, A.cols, parent)
    except NativeUnavailable:
        pass
    offs, cols = A.offs, A.cols
    mark = np.full(n, -1, dtype=np.int64)
    rows: list[np.ndarray] = []
    counts = np.zeros(n + 1, dtype=np.int64)
    for i in range(n):
        pat = []
        for k in cols[offs[i]:offs[i + 1]]:
            k = int(k)
            if k >= i:
                continue
            while k != -1 and k < i and mark[k] != i:
                mark[k] = i
                pat.append(k)
                k = int(parent[k])
        p = np.sort(np.asarray(pat, dtype=np.int64))
        rows.append(p)
        counts[i + 1] = p.size
    loffs = np.cumsum(counts)
    lcols = (np.concatenate(rows) if loffs[-1] else
             np.zeros(0, dtype=np.int64))
    return loffs, lcols


# ------------------------------------------------------------ numeric phase

def symmetrize(A: CsrMatrix) -> CsrMatrix:
    """(A + Aᵀ)/2 — the operator the direct path factorizes, equivalent to
    CHOLMOD's one-triangle stype=-1 build (cholmod-impl.h:5-18)."""
    r, c, v = A.to_coo()
    return CsrMatrix.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                              np.concatenate([v, v]) * 0.5,
                              nrows=A.nrows, ncols=A.ncols)


def numeric_factor(A: CsrMatrix, loffs: np.ndarray, lcols: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left-looking column Cholesky over the symbolic pattern.

    `A` must be symmetric (use `symmetrize` first); returns CSC arrays
    (cp, ci, cx) of L including the diagonal, rows ascending within each
    column. Column j's initial values come from A's row-j slice at
    cols ≥ j (equal to the lower column by symmetry). The numeric loop
    runs natively (native/spchol.cpp) when the toolchain is available,
    with this Python implementation as the fallback (identical math).
    """
    n = A.nrows
    # CSC pattern of L (incl. diagonal): column j holds {j} ∪ {i : j ∈ row_i}.
    col_counts = np.ones(n, dtype=np.int64)
    np.add.at(col_counts, lcols, 1)
    cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(col_counts, out=cp[1:])
    ci = np.empty(cp[-1], dtype=np.int64)
    diag = np.zeros(cp[-1], dtype=bool)
    diag[cp[:-1]] = True
    ci[diag] = np.arange(n)  # diagonal first in each column
    # Below it, column j's rows ascending: a stable sort of the row-major
    # pattern by column keeps rows in scan order.
    row_of = np.repeat(np.arange(n), np.diff(loffs))
    ci[~diag] = row_of[np.argsort(lcols, kind="stable")]
    cx = np.zeros(cp[-1])

    try:
        from lsbench_tpu.native.spchol import chol_numeric
        cx = chol_numeric(n, A.offs, A.cols, A.vals, cp, ci, loffs, lcols)
        return cp, ci, cx
    except np.linalg.LinAlgError:
        raise
    except Exception:
        pass  # no native toolchain — fall through to Python

    # Dense accumulator for the current column.
    w = np.zeros(n)
    sym = A

    # Row-pattern cursor: for the left-looking update of column j we need
    # the ks with L[j,k] != 0, i.e. row j's symbolic pattern.
    for j in range(n):
        pj = ci[cp[j]:cp[j + 1]]          # rows ≥ j of column j (asc)
        w[pj] = 0.0
        sl = slice(sym.offs[j], sym.offs[j + 1])
        ac, av = sym.cols[sl], sym.vals[sl]
        low = ac >= j
        w[ac[low]] = av[low]
        for t in range(loffs[j], loffs[j + 1]):
            k = lcols[t]
            ck = ci[cp[k]:cp[k + 1]]
            # Entries of column k with row ≥ j (rows ascending).
            s = int(np.searchsorted(ck, j))
            ljk = cx[cp[k] + s]            # L[j,k] (row j present by pattern)
            w[ck[s:]] -= ljk * cx[cp[k] + s: cp[k + 1]]
        dj = w[j]
        if dj <= 0.0:
            raise np.linalg.LinAlgError(
                f"matrix not positive definite at column {j} (d={dj:.3e})")
        dj = np.sqrt(dj)
        vals = w[pj] / dj
        vals[0] = dj
        cx[cp[j]:cp[j + 1]] = vals
    return cp, ci, cx


# ---------------------------------------------------- device solve schedule

def _level_schedule(n, row_offs, row_cols):
    """Dependency levels for a lower-triangular solve: level[i] =
    1 + max(level[j]) over js row i references (0 if none)."""
    level = np.zeros(n, dtype=np.int64)
    for i in range(n):
        js = row_cols[row_offs[i]:row_offs[i + 1]]
        if js.size:
            level[i] = level[js].max() + 1
    return level


def _segment_levels(sizes: np.ndarray, max_factor: float = 1.5):
    """Partition the ordered level sequence into contiguous segments so
    each segment's flat padding (seg_len · max_size_in_seg) stays within
    `max_factor` of its true content — level sizes span 4+ orders of
    magnitude (a few wide levels, thousands of tiny tail levels), so
    one global pad width wastes ~20× at n=262k."""
    segs = []
    start, T, s = 0, 0, 0.0
    for l, sz in enumerate(sizes):
        T2, s2 = max(T, int(sz)), s + float(sz)
        if l > start and T2 * (l - start + 1) > max_factor * s2:
            segs.append((start, l))
            start, T, s = l, int(sz), float(sz)
        else:
            T, s = T2, s2
    segs.append((start, len(sizes)))
    return segs


def _pack_levels(n, row_offs, row_cols, row_vals, diag, level, dtype):
    """Flatten the ragged (level → rows → nnz) structure into scan-ready
    flat-per-level arrays (one segment-sum per level, not [R,K] padding),
    SEGMENTED so padding stays bounded: levels are grouped into contiguous
    runs of similar size (_segment_levels) and each run is packed with its
    own (T, R):
      per segment: rows [L,R] (pad → dummy slot n), slot [L,T] (pad → R),
                   cols/vals [L,T] (pad → col n, val 0), dinv [L,R]
    Returns (segments, total_padded, max_R) where `segments` is a list of
    (rows, slot, cols, vals, dinv, R) pytrees executed in order."""
    nlev = int(level.max()) + 1 if n else 1
    lens = np.diff(row_offs)
    order = np.argsort(level, kind="stable")
    lvl_sorted = level[order]
    counts = np.bincount(lvl_sorted, minlength=nlev)
    level_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of_row = np.arange(n) - level_start[lvl_sorted]

    lens_sorted = lens[order]
    level_nnz = np.zeros(nlev, dtype=np.int64)
    np.add.at(level_nnz, lvl_sorted, lens_sorted)
    nnz_cum = np.cumsum(lens_sorted) - lens_sorted      # global excl. cumsum
    level_nnz_start = np.zeros(nlev, dtype=np.int64)
    np.cumsum(level_nnz, out=level_nnz_start[:])        # inclusive
    level_nnz_start = np.concatenate([[0], level_nnz_start[:-1]])
    t_off = nnz_cum - level_nnz_start[lvl_sorted]       # within-level offset

    # Segment on the combined row+nnz footprint per level.
    segs = _segment_levels(level_nnz + counts)

    row_cum = np.concatenate([[0], np.cumsum(counts)])  # rows before level l
    segments = []
    seg_R = []      # static per-segment row pad (NOT in the traced pytree)
    total_padded = 0
    for (l0, l1) in segs:
        L = l1 - l0
        T = max(1, int(level_nnz[l0:l1].max()))
        R = max(1, int(counts[l0:l1].max()))
        r_sel = slice(row_cum[l0], row_cum[l1])         # rows of these levels
        lv_loc = lvl_sorted[r_sel] - l0
        sl_loc = slot_of_row[r_sel]
        rows = np.full((L, R), n, dtype=np.int32)
        dinv = np.zeros((L, R))
        rows[lv_loc, sl_loc] = order[r_sel]
        dinv[lv_loc, sl_loc] = 1.0 / diag[order[r_sel]]

        cols = np.full(L * T, n, dtype=np.int32)
        vals = np.zeros(L * T)
        slot = np.full(L * T, R, dtype=np.int32)
        lens_seg = lens_sorted[r_sel]
        total = int(lens_seg.sum())
        if total:
            nnz_cum_seg = nnz_cum[r_sel]
            intra = (np.arange(total)
                     - np.repeat(nnz_cum_seg - nnz_cum_seg[0], lens_seg))
            dest = np.repeat(lv_loc * T + t_off[r_sel], lens_seg) + intra
            src = (np.repeat(row_offs[order[r_sel]], lens_seg) + intra)
            cols[dest] = row_cols[src]
            vals[dest] = row_vals[src]
            slot[dest] = np.repeat(sl_loc, lens_seg)
        segments.append((rows, slot, cols, vals, dinv))
        seg_R.append((L, T, R))
        total_padded += L * T

    # Ship FIVE flat device arrays (one per field), not 5 per segment:
    # thousands of levels pack into up to ~100 segments, and each eager
    # host→device transfer is a separate copy. The per-segment views are
    # re-sliced with STATIC offsets inside the jitted sweep (free under
    # XLA).
    flat = {
        "rows": jnp.asarray(np.concatenate(
            [s[0].ravel() for s in segments])),
        "slot": jnp.asarray(np.concatenate([s[1] for s in segments])),
        "cols": jnp.asarray(np.concatenate([s[2] for s in segments])),
        "vals": jnp.asarray(np.concatenate([s[3] for s in segments]),
                            dtype=dtype),
        "dinv": jnp.asarray(np.concatenate(
            [s[4].ravel() for s in segments]), dtype=dtype),
    }
    return flat, seg_R, total_padded


def pack_tri(cp, ci, cx, n, dtype):
    """Pack CSC L (incl. diagonal) into level-scheduled forward/backward
    sweep arrays. Returns (state, meta): `state` is a pytree of device
    arrays (safe to pass as a jit ARGUMENT), `meta` holds the static ints
    the apply function needs (segment counts, level counts, pad waste)."""
    # Row-wise strictly-lower CSR of L from CSC.
    row_of = ci
    col_of = np.repeat(np.arange(n), np.diff(cp))
    off_diag = row_of != col_of
    r, c, v = row_of[off_diag], col_of[off_diag], cx[off_diag]
    diag = cx[cp[:-1]]

    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    roffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=roffs[1:])

    lev_f = _level_schedule(n, roffs, c)
    packed_f, rs_f, pad_f = _pack_levels(n, roffs, c, v, diag, lev_f, dtype)

    # Backward solve rows: row i of Lᵀ references j > i where L[j,i] ≠ 0 —
    # i.e. the CSC column i of L minus the diagonal.
    uoffs = np.zeros(n + 1, dtype=np.int64)
    ucols = np.empty(r.size, dtype=np.int64)
    uvals = np.empty(r.size)
    # Column-major (already CSC): column i entries are rows > i.
    np.cumsum(np.bincount(col_of[off_diag], minlength=n), out=uoffs[1:])
    ord_u = np.lexsort((row_of[off_diag], col_of[off_diag]))
    ucols = row_of[off_diag][ord_u]
    uvals = cx[off_diag][ord_u]
    # Levels must respect reverse dependencies (row i needs rows j > i).
    lev_b = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        js = ucols[uoffs[i]:uoffs[i + 1]]
        if js.size:
            lev_b[i] = lev_b[js].max() + 1
    packed_b, rs_b, pad_b = _pack_levels(n, uoffs, ucols, uvals, diag, lev_b,
                                         dtype)

    state = {"f": packed_f, "b": packed_b}
    meta = {"nlev_f": int(lev_f.max()) + 1, "nlev_b": int(lev_b.max()) + 1,
            "rs_f": rs_f, "rs_b": rs_b,
            "n_segments": len(rs_f) + len(rs_b),
            "waste": (pad_f + pad_b) / max(1, 2 * (r.size + n))}
    return state, meta


def _sweep(flat, seg_meta, n, b):
    """One level-scheduled triangular sweep over the packed SEGMENTS (run
    in order). `flat` holds the five concatenated field arrays; `seg_meta`
    the STATIC per-segment (L, T, R) shapes — segment views are static
    slices of the flat arrays (free inside jit). b is length n+1 (pad
    slot)."""
    x = jnp.zeros(n + 1, dtype=b.dtype)
    o_lr = 0   # offset into rows/dinv (L*R elements per segment)
    o_lt = 0   # offset into slot/cols/vals (L*T elements per segment)
    for (L, T, R) in seg_meta:
        rw_s = flat["rows"][o_lr:o_lr + L * R].reshape(L, R)
        di_s = flat["dinv"][o_lr:o_lr + L * R].reshape(L, R)
        sl_s = flat["slot"][o_lt:o_lt + L * T].reshape(L, T)
        cl_s = flat["cols"][o_lt:o_lt + L * T].reshape(L, T)
        vl_s = flat["vals"][o_lt:o_lt + L * T].reshape(L, T)
        o_lr += L * R
        o_lt += L * T

        def step(x, lv, R=R):
            rw, sl, cl, vl, di = lv
            contrib = vl * x[cl]
            s = jax.ops.segment_sum(contrib, sl, num_segments=R + 1,
                                    indices_are_sorted=True)[:R]
            xi = (b[rw] - s) * di
            return x.at[rw].set(xi), None

        x, _ = jax.lax.scan(step, x, (rw_s, sl_s, cl_s, vl_s, di_s))
    return x[:n]


def apply_tri(state, b, *, n, rs_f, rs_b):
    """x = (L Lᵀ)⁻¹ b via the packed level schedules (jittable; `state`
    flows through as a pytree ARGUMENT — closing over it would bake the
    O(fill) arrays into the executable as constants — gigabytes at
    n=262k)."""
    dtype = state["f"]["vals"].dtype
    b = b.astype(dtype)
    bp = jnp.concatenate([b, jnp.zeros(1, dtype)])
    y = _sweep(state["f"], rs_f, n, bp)
    yp = jnp.concatenate([y, jnp.zeros(1, dtype)])
    return _sweep(state["b"], rs_b, n, yp)


def build_level_solver(cp, ci, cx, n, dtype):
    """Return (state, apply) with x = apply(state, b) applying L then Lᵀ
    by segmented level schedule — callers must thread `state` through
    their own jit as an argument (the static R pads are closed over)."""
    state, meta = pack_tri(cp, ci, cx, n, dtype)
    rs_f, rs_b = meta["rs_f"], meta["rs_b"]

    def apply_fn(state, b):
        return apply_tri(state, b, n=n, rs_f=rs_f, rs_b=rs_b)

    return state, apply_fn, meta["nlev_f"], meta["nlev_b"], meta["waste"]


# ------------------------------------------- blocked (partitioned-inverse)

def _pack_blocks(n, row_offs, row_cols, row_vals, diag, level, B, dtype):
    """Blocked partitioned-inverse schedule for one triangular sweep.

    The level schedule's critical path is its LEVEL COUNT (3215 forward
    levels at n=262k, ~2 latency-bound kernel steps per level). This
    pack collapses it to ~n/B
    sequential steps: rows are sorted by dependency level, chunked into
    blocks of B consecutive positions, and each block's WITHIN-block
    couplings (a lower-triangular B×B in sweep order — dependencies
    always point to earlier positions) are inverted at setup (batched
    `solve_triangular` against I, on device). Per sweep step:

        s   = segment_sum(vals · x[cols])      (off-block gather, ELL-flat)
        x_b = W_b @ (b_b − s)                  (one (B,B)@(B,k) matmul)

    — the generalization of band_cholesky.py's dense-panel trick to
    arbitrary sparse patterns. Multi-RHS rides the same schedule with
    (B,k) matmuls (the cusparse.c:183-194 role factors once and solves
    repeatedly; k RHS amortize every W load). The explicit block inverse
    is the classical partitioned-inverse method; its f32 rounding is
    absorbed by the outer f64 refinement loop (measured true
    relres identical to the level path).

    Returns (host_arrays, seg_meta(L,T tuples), nb, waste) — host_arrays
    hold COMPACT (≈nnz-sized) pieces; `_expand_blocks` pads and inverts
    on device so only compact data crosses the host→device link."""
    order = np.argsort(level, kind="stable")          # position -> row
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    nb = max(1, -(-n // B))
    npad = nb * B
    rows_pad = np.full(npad, n, dtype=np.int32)
    rows_pad[:n] = order

    row_of = np.repeat(np.arange(n), np.diff(row_offs))
    j = np.asarray(row_cols, dtype=np.int64)
    v = np.asarray(row_vals)
    pi, pj = pos[row_of], pos[j]
    bi, bj = pi // B, pj // B
    inblk = bi == bj

    # Dense in-block entries (strictly lower in sweep order) + diagonal.
    d_flat = (bi[inblk] * B + pi[inblk] % B) * B + pj[inblk] % B
    pall = np.arange(n)  # diagonal of row order[p] sits at position p
    d_diag = (pall // B * B + pall % B) * B + pall % B
    d_idx = np.concatenate([d_flat, d_diag]).astype(np.int64)
    d_val = np.concatenate([v[inblk], diag[order]])

    # Off-block entries grouped by sweep position (ascending).
    off = ~inblk
    so = np.argsort(pi[off], kind="stable")
    o_col = j[off][so].astype(np.int32)      # gather id into x (row space)
    o_val = v[off][so]
    o_pi = pi[off][so]
    lens = np.bincount(o_pi, minlength=npad).astype(np.int64)
    blk_nnz = lens.reshape(nb, B).sum(axis=1)

    segs = _segment_levels(blk_nnz)
    seg_meta = [(b1 - b0, max(1, int(blk_nnz[b0:b1].max())))
                for b0, b1 in segs]

    # Per-entry destination inside its segment's (L, T) pad — compact.
    blk_start = np.concatenate([[0], np.cumsum(blk_nnz)[:-1]])
    blk_of = o_pi // B
    t_off = np.arange(o_pi.size) - blk_start[blk_of]
    seg_T = np.empty(nb, dtype=np.int64)
    seg_base = np.empty(nb, dtype=np.int64)   # flat base of each block
    base = 0
    for (b0, b1), (L, T) in zip(segs, seg_meta):
        seg_T[b0:b1] = T
        seg_base[b0:b1] = base + (np.arange(b0, b1) - b0) * T
        base += L * T
    o_dest = (seg_base[blk_of] + t_off).astype(np.int64)
    o_slot = (o_pi % B).astype(np.int32)
    total_padded = base

    host = {"d_idx": d_idx, "d_val": d_val, "o_col": o_col,
            "o_val": o_val, "o_dest": o_dest, "o_slot": o_slot,
            "rows": rows_pad, "nb": nb, "total_padded": total_padded}
    waste = total_padded / max(1, o_pi.size)
    return host, seg_meta, nb, waste


def _expand_blocks(host, seg_meta, n, B, dtype):
    """Device-side expansion: compact arrays → padded sweep state + the
    batched block inverses W. Runs as ONE jitted program so the padded
    (L·T) arrays and the (nb,B,B) inverses never cross the host link."""
    nb = host["nb"]
    total = host["total_padded"]

    d_idx = jnp.asarray(host["d_idx"])
    d_val = jnp.asarray(host["d_val"], dtype=dtype)
    o_col = jnp.asarray(host["o_col"])
    o_val = jnp.asarray(host["o_val"], dtype=dtype)
    o_dest = jnp.asarray(host["o_dest"])
    o_slot = jnp.asarray(host["o_slot"])

    @jax.jit
    def expand(d_idx, d_val, o_col, o_val, o_dest, o_slot):
        dense = jnp.zeros(nb * B * B, dtype).at[d_idx].set(d_val)
        dense = dense.reshape(nb, B, B)
        # Padding positions have empty rows: unit diagonal keeps the
        # batched triangular solve nonsingular (their x stays 0 because
        # b and the gathers are 0 there).
        dd = jnp.diagonal(dense, axis1=1, axis2=2)
        fix = (dd == 0).astype(dtype)
        dense = dense + fix[:, :, None] * jnp.eye(B, dtype=dtype)[None]
        import jax.scipy.linalg as jsl
        W = jsl.solve_triangular(dense, jnp.broadcast_to(
            jnp.eye(B, dtype=dtype), (nb, B, B)), lower=True)
        cols = jnp.full(total, n, jnp.int32).at[o_dest].set(o_col)
        vals = jnp.zeros(total, dtype).at[o_dest].set(o_val)
        slot = jnp.full(total, B, jnp.int32).at[o_dest].set(o_slot)
        return {"W": W.reshape(nb * B * B), "cols": cols, "vals": vals,
                "slot": slot, "rows": jnp.asarray(host["rows"])}

    return expand(d_idx, d_val, o_col, o_val, o_dest, o_slot)


def _sweep_blocks(flat, seg_meta, n, B, bp):
    """One blocked triangular sweep. bp: (n+1, k) padded RHS (pad row 0).
    Sequential steps = number of blocks (~n/B), each one gather +
    segment-sum + (B,B)@(B,k) matmul + scatter."""
    k = bp.shape[1]
    x = jnp.zeros((n + 1, k), dtype=bp.dtype)
    oW = 0
    o_lt = 0
    ob = 0
    for (L, T) in seg_meta:
        W = flat["W"][oW:oW + L * B * B].reshape(L, B, B)
        cols = flat["cols"][o_lt:o_lt + L * T].reshape(L, T)
        vals = flat["vals"][o_lt:o_lt + L * T].reshape(L, T)
        slot = flat["slot"][o_lt:o_lt + L * T].reshape(L, T)
        rows = flat["rows"][ob * B:(ob + L) * B].reshape(L, B)
        oW += L * B * B
        o_lt += L * T
        ob += L

        def step(x, lv):
            rw, cl, vl, sl, Wb = lv
            contrib = vl[:, None] * x[cl]                     # (T, k)
            s = jax.ops.segment_sum(contrib, sl, num_segments=B + 1,
                                    indices_are_sorted=False)[:B]
            # HIGHEST: a reduced-precision product (TF32 for f32
            # operands) loses ~3 digits PER BLOCK, amplified through the
            # ~n/B sequential substitutions.
            xb = jnp.matmul(Wb, bp[rw] - s,
                            precision=jax.lax.Precision.HIGHEST)  # (B, k)
            return x.at[rw].set(xb), None

        x, _ = jax.lax.scan(step, x, (rows, cols, vals, slot, W))
    return x[:n]


def pack_tri_blocked(cp, ci, cx, n, dtype, block=256):
    """Blocked counterpart of `pack_tri`: build forward/backward blocked
    schedules from CSC L. Returns (state, meta)."""
    row_of = ci
    col_of = np.repeat(np.arange(n), np.diff(cp))
    off_diag = row_of != col_of
    r, c, v = row_of[off_diag], col_of[off_diag], cx[off_diag]
    diag = cx[cp[:-1]]

    order = np.lexsort((c, r))
    r_s, c_s, v_s = r[order], c[order], v[order]
    roffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r_s, minlength=n), out=roffs[1:])
    lev_f = _level_schedule(n, roffs, c_s)
    host_f, meta_f, nb, waste_f = _pack_blocks(
        n, roffs, c_s, v_s, diag, lev_f, block, dtype)

    uoffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=uoffs[1:])
    ord_u = np.lexsort((r, c))
    ucols = r[ord_u]
    uvals = v[ord_u]
    lev_b = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        js = ucols[uoffs[i]:uoffs[i + 1]]
        if js.size:
            lev_b[i] = lev_b[js].max() + 1
    host_b, meta_b, _, waste_b = _pack_blocks(
        n, uoffs, ucols, uvals, diag, lev_b, block, dtype)

    state = {"f": _expand_blocks(host_f, meta_f, n, block, dtype),
             "b": _expand_blocks(host_b, meta_b, n, block, dtype)}
    meta = {"rs_f": meta_f, "rs_b": meta_b, "block": block, "nb": nb,
            "nlev_f": int(lev_f.max()) + 1, "nlev_b": int(lev_b.max()) + 1,
            "waste": (waste_f + waste_b) / 2}
    return state, meta


def apply_tri_blocked(state, b, *, n, rs_f, rs_b, block):
    """x = (L Lᵀ)⁻¹ b via the blocked schedules. b: (n,) or (n, k)."""
    dtype = state["f"]["vals"].dtype
    squeeze = b.ndim == 1
    b2 = (b[:, None] if squeeze else b).astype(dtype)
    k = b2.shape[1]
    bp = jnp.concatenate([b2, jnp.zeros((1, k), dtype)])
    y = _sweep_blocks(state["f"], rs_f, n, block, bp)
    yp = jnp.concatenate([y, jnp.zeros((1, k), dtype)])
    x = _sweep_blocks(state["b"], rs_b, n, block, yp)
    return x[:, 0] if squeeze else x


# ------------------------------------------------------------------- solver

@register_solver("sparse_cholesky")
class SparseCholeskySolver(Solver):
    """Host symbolic+numeric sparse Cholesky (CHOLMOD's CPU split,
    cholmod.c:68) with device level-scheduled triangular solves."""

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, ordering="amd",
                 rtol=1e-10, max_refine=12, schedule="auto", block=256,
                 **params):
        super().__init__(A, **params)
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        if schedule == "auto":
            # The host CSC substitution is where the reference's default
            # backend solves too (cholmod.c:68 useGPU=0). Auto picks host
            # when the native library is buildable; the device schedules
            # remain selectable (`--opt schedule=block`).
            try:
                from lsbench_tpu.native.spchol import tri_solve as _p
                del _p
                schedule = "host"
            except Exception:
                schedule = "block"
        if schedule not in ("block", "level", "host"):
            raise ValueError(
                f"unknown schedule '{schedule}' (auto | block | level | "
                "host)")
        self.schedule = schedule
        self.dtype = jnp.dtype(dtype)
        self.ordering = ordering
        self.rtol = float(rtol)
        self.max_refine = int(max_refine)
        n = A.nrows
        level_dtype = self.dtype

        import time as _time

        from lsbench_tpu.ordering import get_ordering
        _t0 = _time.perf_counter()
        perm = get_ordering(ordering, A)
        self.setup_breakdown["ordering_s"] = _time.perf_counter() - _t0
        identity = bool(np.all(perm == np.arange(n)))
        Ap = A if identity else A.permuted(perm)
        self._perm = None if identity else jnp.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        self._inv = None if identity else jnp.asarray(inv)

        from lsbench_tpu.harness import cache
        key = None
        if cache.is_enabled():
            key = cache.key_of(cache.fingerprint_csr(A), ordering, "v1")
            hit = cache.load_arrays("spchol", key)
        else:
            hit = None
        if hit is not None:
            cp, ci, cx = hit["cp"], hit["ci"], hit["cx"]
        else:
            _t0 = _time.perf_counter()
            As = symmetrize(Ap)
            parent = elimination_tree(As)
            loffs, lcols = symbolic_rows(As, parent)
            self.setup_breakdown["symbolic_s"] = _time.perf_counter() - _t0
            _t0 = _time.perf_counter()
            cp, ci, cx = numeric_factor(As, loffs, lcols)
            self.setup_breakdown["factor_s"] = _time.perf_counter() - _t0
            if key is not None:
                cache.store_arrays("spchol", key,
                                   {"cp": cp, "ci": ci, "cx": cx})
        self.fill_nnz = int(cp[-1])
        if schedule == "host":
            # The reference's default backend solves ON THE HOST CPU
            # (cholmod.c:68 useGPU=0; the timed region is the solve,
            # cholmod-impl.h:44-63). Native CSC two-sweep substitution
            # (native/spchol.cpp::lsb_tri_solve) + refinement against
            # the raw permuted operator.
            from lsbench_tpu.native.spchol import tri_solve as _probe
            del _probe  # import error here = no toolchain; fail loudly
            self._cp, self._ci, self._cx = cp, ci, cx
            self._Ap_host = Ap
            self.n_levels_f = self.n_levels_b = None
            self.n_blocks = None
            self.pad_waste = 0.0
            self.setup_breakdown["level_build_s"] = 0.0
            return
        _t0 = _time.perf_counter()
        if schedule == "block":
            tri_state, meta = pack_tri_blocked(cp, ci, cx, n, level_dtype,
                                               block=block)
            rs_f, rs_b, blk = meta["rs_f"], meta["rs_b"], meta["block"]

            def tri_apply(tri, b):
                return apply_tri_blocked(tri, b, n=n, rs_f=rs_f,
                                         rs_b=rs_b, block=blk)

            self.n_levels_f, self.n_levels_b = meta["nlev_f"], meta["nlev_b"]
            self.n_blocks = meta["nb"]
            self.pad_waste = meta["waste"]
        else:
            (tri_state, tri_apply, self.n_levels_f, self.n_levels_b,
             self.pad_waste) = build_level_solver(cp, ci, cx, n, level_dtype)
            self.n_blocks = None
        self.setup_breakdown["level_build_s"] = _time.perf_counter() - _t0
        self._tri_state = tri_state

        perm_dev, inv_dev = self._perm, self._inv

        # fp64 sweeps directly — but the factor is of the SYMMETRIZED
        # operator while the workload is symmetric only to ~1e-7
        # relative (SURVEY §2.1), which floors the raw-matrix residual
        # at ~1e-6. Refine against the raw operator like the dense
        # path does (direct.py), until rtol or stagnation.
        from lsbench_tpu.matrix.ell import EllMatrix
        from lsbench_tpu.ops.spmv import spmv_ell
        ell_true = EllMatrix.from_csr(Ap, dtype=self.dtype)
        rtol_c, max_refine_c = self.rtol, self.max_refine

        if schedule == "block":
            tri_apply_nk = tri_apply
        else:
            def tri_apply_nk(tri, R):
                return jax.vmap(lambda c: tri_apply(tri, c),
                                in_axes=1, out_axes=1)(R)

        def _cdots(A_, B_):
            return jnp.sum(A_ * B_, axis=0)

        @jax.jit
        def _solve(tri, ell_true, b):
            bp = (b if perm_dev is None else b[perm_dev]).astype(dtype)
            k = bp.shape[1]
            tol2 = (rtol_c ** 2) * _cdots(bp, bp)

            def mm(X):
                return jnp.stack([spmv_ell(ell_true, X[:, j])
                                  for j in range(k)], axis=1)

            def cond(s):
                x, r, rr, rr_prev, passes = s
                return jnp.logical_and(
                    passes < max_refine_c,
                    jnp.any(jnp.logical_and(rr > tol2, rr < rr_prev)))

            def body(s):
                x, r, rr, rr_prev, passes = s
                active = jnp.logical_and(rr > tol2, rr < rr_prev)
                x = jnp.where(active[None, :],
                              x + tri_apply_nk(tri, r), x)
                r_new = jnp.where(active[None, :], bp - mm(x), r)
                rr_new = jnp.where(active, _cdots(r_new, r_new), rr)
                rr_prev_new = jnp.where(active, rr, rr_prev)
                return (x, r_new, rr_new, rr_prev_new, passes + 1)

            x0 = tri_apply_nk(tri, bp)
            r0 = bp - mm(x0)
            rr0 = _cdots(r0, r0)
            x, _, _, _, _ = jax.lax.while_loop(
                cond, body, (x0, r0, rr0,
                             jnp.full((k,), jnp.inf, dtype),
                             jnp.int32(0)))
            return x if inv_dev is None else x[inv_dev]

        self._solve_args = (tri_state, ell_true)

        self._jit_solve = _solve

    def _host_solve(self, b):
        """Host CPU solve + refinement (schedule='host'): the CHOLMOD-
        role baseline. b (n,) or (n,k)."""
        from lsbench_tpu.native.spchol import tri_solve
        b = np.asarray(b, dtype=np.float64)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        perm = None if self._perm is None else np.asarray(self._perm)
        inv = None if self._inv is None else np.asarray(self._inv)
        bp = b2 if perm is None else b2[perm]
        x = tri_solve(self._cp, self._ci, self._cx, bp)
        bn = np.linalg.norm(bp, axis=0)
        for _ in range(self.max_refine):
            r = bp - np.stack([self._Ap_host.matvec(x[:, j])
                               for j in range(x.shape[1])], axis=1)
            if np.all(np.linalg.norm(r, axis=0)
                      <= self.rtol * np.maximum(bn, 1e-300)):
                break
            x = x + tri_solve(self._cp, self._ci, self._cx, r)
        if inv is not None:
            x = x[inv]
        return x[:, 0] if squeeze else x

    def _apply_solve(self, b):
        """Vector or multi-RHS dispatch: 2-D b is vmapped over columns
        (the refinement while_loop runs until every column converges) —
        the delegation path from direct.py must accept the same shapes
        the dense path does (cholmod factors once, solves repeatedly)."""
        if self.schedule == "host":
            return self._host_solve(b)
        if b.ndim == 2:
            return self._jit_solve(*self._solve_args, b)
        return self._jit_solve(*self._solve_args, b[:, None])[:, 0]

    def solve(self, b) -> SolveResult:
        b = jnp.asarray(b)
        x = self._apply_solve(b)
        relres = self.true_relres(x, b)
        return SolveResult(x=x, iters=1, relres=relres,
                           converged=bool(np.isfinite(relres)),
                           extra={"fill_nnz": self.fill_nnz,
                                  "schedule": self.schedule,
                                  "blocks": self.n_blocks,
                                  "levels": (self.n_levels_f,
                                             self.n_levels_b)})

    def solve_fn(self):
        return self._apply_solve

    def solve_fn_args(self):
        jit_solve = self._jit_solve
        return ((lambda args, b: jit_solve(*args, b)), self._solve_args)
