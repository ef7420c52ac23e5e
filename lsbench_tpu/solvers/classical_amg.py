"""Classical (Ruge-Stüben family) AMG coarsening — the Hypre/AmgX algorithms.

The reference configures Hypre BoomerAMG with coarsening type 8 = PMIS and
interpolation 6 = extended+i at strong threshold 0.25 (hypre.c:126-188), and
AmgX with CLASSICAL selector, strength 0.25, D2 interpolator (amgx.c:78-86).
This module implements that family natively on the host (AMG *setup* is
host-side by design — SURVEY.md §7.5; the cycle itself runs on device):

- classical strength-of-connection (signed, M-matrix convention),
- PMIS parallel-maximal-independent-set C/F splitting (De Sterck, Yang &
  Heys 2006 — the algorithm behind Hypre coarsening 8),
- direct interpolation with positive/negative coupling split plus a
  C-promotion fixup for F-points left without strong C-neighbours (the role
  Hypre's distance-2 "extended+i" interpolation plays for PMIS grids).

Everything is vectorized NumPy over CSR arrays; no SciPy.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.ops.spgemm import spgemm

UNDECIDED, FPOINT, CPOINT = -1, 0, 1


def classical_strength(A: CsrMatrix, theta: float, mode: str = "classical"
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strength of connection.

    mode="classical": j is a strong dependency of i iff
    -a_ij·sign(a_ii) >= theta · max_k (-a_ik·sign(a_ii)) over off-diagonal
    k (Ruge-Stüben measure; matches Hypre's default for the 0.25
    threshold, hypre.c:167). Positive off-diagonals can never be strong —
    the M-matrix assumption.

    mode="abs": |a_ij| >= theta · max_k |a_ik| — the absolute-value
    measure for matrices OUTSIDE the M-matrix class (the reference
    workload carries 32% positive off-diagonal mass; a positive coupling
    as large as the negative ones is a real dependency the classical
    measure ignores).

    Returns (rows, cols) of the strong-dependency edge set S (i depends on
    j), plus the per-edge index into A's nnz arrays.
    """
    r = A.row_indices()
    c = A.cols
    v = A.vals
    d = A.diagonal()
    off = r != c
    if mode == "abs":
        m = np.where(off, np.abs(v), -np.inf)
    elif mode == "classical":
        # m_ij = -a_ij * sign(a_ii): positive for "good" (M-matrix)
        # couplings.
        sign = np.where(d[r] >= 0, 1.0, -1.0)
        m = np.where(off, -v * sign, -np.inf)
    else:
        raise ValueError(f"unknown strength mode '{mode}' (classical|abs)")
    rowmax = np.full(A.nrows, -np.inf)
    np.maximum.at(rowmax, r, m)
    ok = rowmax > 0
    strong = off & ok[r] & (m >= theta * rowmax[r]) & (m > 0)
    idx = np.flatnonzero(strong)
    return r[idx], c[idx], idx


def pmis_splitting(n: int, s_rows: np.ndarray, s_cols: np.ndarray,
                   seed: int = 0) -> np.ndarray:
    """PMIS C/F splitting on the strength graph.

    Weights w_i = (# points strongly depending on i) + rand[0,1); repeat:
    undecided points whose weight beats every undecided neighbour (in the
    symmetrized strength graph) become C; undecided points adjacent to a new
    C become F. Points with no strong connections at all become F
    immediately (smoother-only points).
    """
    rng = np.random.default_rng(seed)
    w = np.bincount(s_cols, minlength=n).astype(np.float64) + rng.random(n)
    state = np.full(n, UNDECIDED, dtype=np.int8)

    has_edge = np.zeros(n, dtype=bool)
    has_edge[s_rows] = True
    has_edge[s_cols] = True
    state[~has_edge] = FPOINT

    # Symmetrized edge list for independence / F-assignment.
    ea = np.concatenate([s_rows, s_cols])
    eb = np.concatenate([s_cols, s_rows])

    while True:
        und = state == UNDECIDED
        if not und.any():
            break
        live = und[ea] & und[eb]
        neigh_max = np.full(n, -1.0)
        np.maximum.at(neigh_max, ea[live], w[eb[live]])
        new_c = und & (w > neigh_max)
        if not new_c.any():  # cannot happen with distinct random weights
            state[und] = CPOINT
            break
        state[new_c] = CPOINT
        # Undecided neighbours of new C points → F.
        mark = (state[ea] == UNDECIDED) & new_c[eb]
        state[ea[mark]] = FPOINT
    return state


def promote_uninterpolable(state: np.ndarray, s_rows: np.ndarray,
                           s_cols: np.ndarray) -> np.ndarray:
    """Promote to C any F-point with strong dependencies but no strong
    C-neighbour to interpolate from.

    PMIS alone leaves such points (its independent set is distance-1);
    Hypre pairs PMIS with distance-2 interpolation (interp 6, hypre.c:128)
    instead. Promotion keeps interpolation direct while guaranteeing
    feasibility; grids come out slightly larger than ext+i would give.
    """
    state = state.copy()
    while True:
        has_c_dep = np.zeros(state.size, dtype=bool)
        edge = state[s_cols] == CPOINT
        has_c_dep[s_rows[edge]] = True
        has_dep = np.zeros(state.size, dtype=bool)
        has_dep[s_rows] = True
        bad = (state == FPOINT) & has_dep & ~has_c_dep
        if not bad.any():
            return state
        # Promote the worst offenders one independent wave at a time is
        # unnecessary — promoting all of them at once only adds C points.
        state[bad] = CPOINT


def promote_uninterpolable_d2(state: np.ndarray, s_rows: np.ndarray,
                              s_cols: np.ndarray) -> np.ndarray:
    """Distance-2-aware promotion for ext+i interpolation: promote to C
    only F-points with strong dependencies but no C-point within distance
    2 of the strength graph (no strong C-neighbour AND no strong
    F-neighbour that itself has a strong C-neighbour). Far rarer than the
    distance-1 criterion of `promote_uninterpolable`, so grids stay the
    size PMIS intended (the reason Hypre pairs PMIS with distance-2
    interpolation, hypre.c:127-128)."""
    state = state.copy()
    while True:
        has_c_dep = np.zeros(state.size, dtype=bool)
        edge_c = state[s_cols] == CPOINT
        has_c_dep[s_rows[edge_c]] = True
        # Distance 2: i --strong--> k (F) --strong--> j (C).
        edge_ff = state[s_cols] == FPOINT
        reach2 = np.zeros(state.size, dtype=bool)
        reach2[s_rows[edge_ff & has_c_dep[s_cols]]] = True
        has_dep = np.zeros(state.size, dtype=bool)
        has_dep[s_rows] = True
        bad = (state == FPOINT) & has_dep & ~(has_c_dep | reach2)
        if not bad.any():
            return state
        state[bad] = CPOINT


def _truncate_rows(nrows: int, wr: np.ndarray, wc: np.ndarray,
                   wv: np.ndarray, pmax: int):
    """Keep the pmax largest-|value| entries per row, rescaling to
    preserve row sums (Hypre's P truncation with Pmax)."""
    if not pmax or wr.size == 0:
        return wr, wc, wv
    order = np.lexsort((-np.abs(wv), wr))
    wr_s = wr[order]
    rank = np.arange(wr_s.size) - np.searchsorted(wr_s, wr_s)
    keep = order[rank < pmax]
    rowsum_all = np.zeros(nrows)
    np.add.at(rowsum_all, wr, wv)
    kr, kc, kv = wr[keep], wc[keep], wv[keep]
    rowsum_kept = np.zeros(nrows)
    np.add.at(rowsum_kept, kr, kv)
    scale = np.divide(rowsum_all, rowsum_kept,
                      out=np.ones(nrows), where=rowsum_kept != 0)
    return kr, kc, kv * scale[kr]


def extended_i_interpolation(A: CsrMatrix, s_idx: np.ndarray,
                             state: np.ndarray, pmax: int = 4) -> CsrMatrix:
    """Extended+i distance-2 interpolation — Hypre's interp type 6
    (hypre.c:128; De Sterck, Falgout, Nolting & Yang 2008).

    For an F-point i with strong C-set C_i, strong F-set F_i^s, and
    extended set Ĉ_i = C_i ∪ (∪_{k∈F_i^s} C_k):

        w_ij = -(1/ã_ii) [ a_ij + Σ_{k∈F_i^s} a_ik ā_kj / D_ik ]
        D_ik = Σ_{l∈Ĉ_i∪{i}} ā_kl
        ã_ii = a_ii + Σ_{n∈N_i^w, n∉Ĉ_i} a_in + Σ_{k∈F_i^s} a_ik ā_ki / D_ik

    where ā_kl keeps only entries of opposite sign to a_kk (zero
    otherwise), the "+i" being i's membership in the distribution set
    (the ā_ki / D_ik terms). Strong F-neighbours whose distribution
    weight D_ik vanishes are lumped into the diagonal (Hypre's fallback).
    Truncated to `pmax` entries/row with row-sum rescaling.
    """
    n = A.nrows
    r = A.row_indices()
    c = A.cols
    v = A.vals
    d = A.diagonal()
    off = r != c
    fpt = state == FPOINT

    in_s = np.zeros(A.nnz, dtype=bool)
    in_s[s_idx] = True
    sC = in_s & (state[c] == CPOINT)            # strong →C edges
    sFF = in_s & (state[c] == FPOINT) & fpt[r]  # strong F→F edges
    sign_d = np.where(d >= 0, 1.0, -1.0)
    abar = off & (v * sign_d[r] < 0)            # ā: opposite sign to diag

    # Strong-C adjacency in CSR order (rows sorted — CSR guarantees it).
    scI = np.flatnonzero(sC)
    sc_r, sc_c = r[scI], c[scI]
    sc_cnt = np.bincount(sc_r, minlength=n)
    sc_start = np.concatenate([[0], np.cumsum(sc_cnt)])
    # ā adjacency.
    abI = np.flatnonzero(abar)
    ab_r, ab_c, ab_v = r[abI], c[abI], v[abI]
    ab_cnt = np.bincount(ab_r, minlength=n)
    ab_start = np.concatenate([[0], np.cumsum(ab_cnt)])

    # Strong F→F edges from F rows: e = (i_e, k_e, a_ik).
    eI = np.flatnonzero(sFF)
    i_e, k_e, v_e = r[eI], c[eI], v[eI]
    nE = i_e.size

    def _expand(edge_rows, cnt, start):
        """Per edge e, indices into the adjacency arrays of row
        edge_rows[e]; returns (rep_edge_id, adjacency_pos)."""
        cnts = cnt[edge_rows]
        rep = np.repeat(np.arange(edge_rows.size), cnts)
        base = np.concatenate([[0], np.cumsum(cnts)])[:-1]
        pos = (np.arange(rep.size) - np.repeat(base, cnts)
               + start[edge_rows[rep]])
        return rep, pos

    # T_i = {i} ∪ C_i ∪ ∪_{k∈F_i^s} C_k, as sorted i*n+l keys.
    f_idx = np.flatnonzero(fpt)
    keys_self = f_idx.astype(np.int64) * n + f_idx
    selC = fpt[sc_r]
    keys_c1 = sc_r[selC].astype(np.int64) * n + sc_c[selC]
    rep2, pos2 = _expand(k_e, sc_cnt, sc_start)
    keys_c2 = i_e[rep2].astype(np.int64) * n + sc_c[pos2]
    T_keys = np.unique(np.concatenate([keys_self, keys_c1, keys_c2]))

    # Denominators D_e = Σ_{l∈T_i} ā_kl and the ā_ki terms.
    repA, posA = _expand(k_e, ab_cnt, ab_start)
    lA = ab_c[posA]
    keyA = i_e[repA].astype(np.int64) * n + lA
    member = np.isin(keyA, T_keys, assume_unique=False)
    D = np.zeros(nE)
    np.add.at(D, repA[member], ab_v[posA[member]])
    a_ki = np.zeros(nE)
    sel_self = member & (lA == i_e[repA])
    np.add.at(a_ki, repA[sel_self], ab_v[posA[sel_self]])

    ok_e = D != 0.0

    # Diagonal ã_ii accumulators (indexed by fine i).
    diag_eff = d.copy()
    # D==0 edges: lump a_ik (Hypre fallback).
    np.add.at(diag_eff, i_e[~ok_e], v_e[~ok_e])
    # "+i" terms: a_ik ā_ki / D_ik.
    np.add.at(diag_eff, i_e[ok_e], v_e[ok_e] * a_ki[ok_e] / D[ok_e])

    # Weak neighbours of F rows not in Ĉ_i lump into diag; those IN Ĉ_i
    # contribute their a_ij directly (handled below by the membership
    # test on ALL off-diagonal entries of F rows).
    offF = np.flatnonzero(off & fpt[r] & ~sFF)
    keyF = r[offF].astype(np.int64) * n + c[offF]
    memF = np.isin(keyF, T_keys, assume_unique=False)
    np.add.at(diag_eff, r[offF[~memF]], v[offF[~memF]])

    # Numerator: direct a_ij for j ∈ Ĉ_i ...
    dirI = offF[memF]
    num_r = [r[dirI]]
    num_c = [c[dirI]]
    num_v = [v[dirI]]
    # ... plus distributed distance-2 terms a_ik ā_kl / D_ik for l ∈ Ĉ_i.
    selN = member & (lA != i_e[repA]) & ok_e[repA]
    num_r.append(i_e[repA[selN]])
    num_c.append(lA[selN])
    num_v.append(v_e[repA[selN]] * ab_v[posA[selN]] / D[repA[selN]])

    wr = np.concatenate(num_r)
    wc = np.concatenate(num_c)
    de = np.where(diag_eff != 0, diag_eff, 1.0)
    wv = -np.concatenate(num_v) / de[wr]

    # Sum duplicates (a_ij may coincide with a distributed target).
    key_w = wr.astype(np.int64) * n + wc
    uk, inv_map = np.unique(key_w, return_inverse=True)
    wv_sum = np.zeros(uk.size)
    np.add.at(wv_sum, inv_map, wv)
    wr = (uk // n).astype(np.int64)
    wc = (uk % n).astype(np.int64)

    # Truncate per F row (row ids are fine indices; compact to F-local).
    fmap = np.full(n, -1, dtype=np.int64)
    fmap[f_idx] = np.arange(f_idx.size)
    kr, kc, kv = _truncate_rows(f_idx.size, fmap[wr], wc, wv_sum, pmax)

    cmap = np.cumsum(state == CPOINT) - 1
    ncoarse = int(cmap[-1]) + 1 if n else 0
    crows = np.flatnonzero(state == CPOINT)
    rows = np.concatenate([f_idx[kr], crows])
    cols = np.concatenate([cmap[kc], cmap[crows]])
    vals = np.concatenate([kv, np.ones(crows.size)])
    return CsrMatrix.from_coo(rows, cols, vals, nrows=n, ncols=ncoarse,
                              sum_duplicates=True)


def direct_interpolation(A: CsrMatrix, s_idx: np.ndarray, state: np.ndarray
                         ) -> CsrMatrix:
    """Classical direct interpolation P (F-rows) + identity (C-rows).

    For an F-point i with strong C-set C_i (split by coupling sign):
        alpha_i = sum_{j in N_i, a_ij<0} a_ij / sum_{j in C_i, a_ij<0} a_ij
        beta_i  = likewise over positive couplings
        w_ij = -alpha_i a_ij / d_i   (a_ij < 0)
        w_ij = -beta_i  a_ij / d_i   (a_ij > 0)
    where positive couplings with no positive C-neighbour are lumped into
    the diagonal d_i instead (Stüben 2001, eq. (31)-(33) family).
    """
    n = A.nrows
    r = A.row_indices()
    c = A.cols
    v = A.vals
    d = A.diagonal().copy()
    off = r != c

    in_s = np.zeros(A.nnz, dtype=bool)
    in_s[s_idx] = True
    to_c = in_s & (state[c] == CPOINT)

    neg = off & (v < 0)
    pos = off & (v > 0)
    sum_neg_all = np.zeros(n); np.add.at(sum_neg_all, r[neg], v[neg])
    sum_pos_all = np.zeros(n); np.add.at(sum_pos_all, r[pos], v[pos])
    sum_neg_c = np.zeros(n); np.add.at(sum_neg_c, r[neg & to_c], v[neg & to_c])
    sum_pos_c = np.zeros(n); np.add.at(sum_pos_c, r[pos & to_c], v[pos & to_c])

    alpha = np.divide(sum_neg_all, sum_neg_c,
                      out=np.zeros(n), where=sum_neg_c != 0)
    # Positive couplings: scale if C has positive entries, else lump into d.
    has_pos_c = sum_pos_c != 0
    beta = np.divide(sum_pos_all, sum_pos_c,
                     out=np.zeros(n), where=has_pos_c)
    d_eff = np.where(has_pos_c, d, d + sum_pos_all)
    d_eff = np.where(d_eff != 0, d_eff, 1.0)

    cmap = np.cumsum(state == CPOINT) - 1  # fine C index → coarse index
    ncoarse = int(cmap[-1]) + 1 if n else 0

    # F rows.
    fsel = to_c & (state[r] == FPOINT)
    fr = r[fsel]
    scale = np.where(v[fsel] < 0, alpha[fr], beta[fr])
    pw = -scale * v[fsel] / d_eff[fr]
    # C rows: identity.
    crows = np.flatnonzero(state == CPOINT)

    rows = np.concatenate([fr, crows])
    cols = np.concatenate([cmap[c[fsel]], cmap[crows]])
    vals = np.concatenate([pw, np.ones(crows.size)])
    return CsrMatrix.from_coo(rows, cols, vals, nrows=n, ncols=ncoarse,
                              sum_duplicates=True)


def jacobi_improve_interpolation(A: CsrMatrix, P: CsrMatrix,
                                 state: np.ndarray, passes: int = 1,
                                 pmax: int = 4,
                                 omega: float = 1.0) -> CsrMatrix:
    """Jacobi improvement of the F-rows of P toward ideal interpolation
    W* = -A_FF⁻¹ A_FC, then truncation to `pmax` entries/row with row-sum
    rescaling. One pass reaches distance-2 C-points — the quality role of
    Hypre's extended+i interpolation (interp 6, hypre.c:128) on PMIS grids.

        W ← (1−ω) W + ω D_FF⁻¹ (−A_FC − (A_FF − D_FF) W)

    ω < 1 damps the iteration: plain Jacobi (ω=1) on A_FF diverges when
    ρ(D_FF⁻¹(A_FF−D_FF)) > 1 (measured on the tj7a series — factors blow
    past 0.9 at passes ≥ 2 undamped, while damped multi-pass converges
    toward the ideal operator).
    """
    n = A.nrows
    f_mask = state == FPOINT
    f_idx = np.flatnonzero(f_mask)
    c_idx = np.flatnonzero(~f_mask)
    if f_idx.size == 0:
        return P
    fmap = np.full(n, -1, dtype=np.int64)
    fmap[f_idx] = np.arange(f_idx.size)
    cmap = np.full(n, -1, dtype=np.int64)
    cmap[c_idx] = np.arange(c_idx.size)

    r, c, v = A.to_coo()
    fr = f_mask[r]
    # A_FC (F rows, coarse cols) and off-diagonal A_FF scaled by D_FF⁻¹.
    d = A.diagonal()
    d_f = np.where(d[f_idx] != 0, d[f_idx], 1.0)
    sel_fc = fr & ~f_mask[c]
    A_FC = CsrMatrix.from_coo(fmap[r[sel_fc]], cmap[c[sel_fc]], v[sel_fc],
                              nrows=f_idx.size, ncols=c_idx.size,
                              sum_duplicates=False)
    sel_ff = fr & f_mask[c] & (r != c)
    off_FF = CsrMatrix.from_coo(fmap[r[sel_ff]], fmap[c[sel_ff]], v[sel_ff],
                                nrows=f_idx.size, ncols=f_idx.size,
                                sum_duplicates=False)

    # Current W (F rows of P).
    pr, pc, pv = P.to_coo()
    wsel = f_mask[pr]
    W = CsrMatrix.from_coo(fmap[pr[wsel]], pc[wsel], pv[wsel],
                           nrows=f_idx.size, ncols=P.ncols,
                           sum_duplicates=False)
    # One STACKED SpGEMM per pass instead of product + concat + sorted
    # dedup:  W_new = S @ V  with
    #   S = [ -ωD⁻¹·off_FF | -ωD⁻¹·I | (1-ω)·I ]   (f × 3f, built once)
    #   V = [ W ; A_FC ; W ]                        (3f × nc, re-stacked)
    # (the trailing identity pair drops at ω=1). The native Gustavson
    # kernel dedups in its dense accumulator, so the per-pass
    # argsort-of-multi-M-COO this replaces — the dominant cost of the
    # n=262k first-time AMG setup — disappears;
    # identical math up to float addition order.
    f = f_idx.size
    scale = -omega / d_f
    extra = 1 if omega == 1.0 else 2
    oo, oc, ov = off_FF.offs, off_FF.cols.astype(np.int64), off_FF.vals
    s_offs = np.zeros(f + 1, dtype=np.int64)
    np.cumsum(np.diff(oo) + extra, out=s_offs[1:])
    total = int(oo[-1]) + extra * f
    s_cols = np.empty(total, dtype=np.int64)
    s_vals = np.empty(total)
    rws = np.repeat(np.arange(f), np.diff(oo))
    dest = np.arange(int(oo[-1]), dtype=np.int64) + extra * rws
    s_cols[dest] = oc
    s_vals[dest] = ov * scale[rws]
    pos1 = s_offs[1:] - extra
    s_cols[pos1] = f + np.arange(f)
    s_vals[pos1] = scale
    if extra == 2:
        pos2 = s_offs[1:] - 1
        s_cols[pos2] = 2 * f + np.arange(f)
        s_vals[pos2] = 1.0 - omega
    S_op = CsrMatrix(f, (1 + extra) * f, s_offs,
                     s_cols.astype(np.int32), s_vals)

    def _vstack(mats):
        offs = [mats[0].offs]
        shift = int(mats[0].offs[-1])
        for m in mats[1:]:
            offs.append(m.offs[1:] + shift)
            shift += int(m.offs[-1])
        return CsrMatrix(sum(m.nrows for m in mats), mats[0].ncols,
                         np.concatenate(offs),
                         np.concatenate([m.cols for m in mats]),
                         np.concatenate([m.vals for m in mats]))

    def _truncate_rows(wr2, wc, wv):
        """Keep the pmax largest-|.| entries per row, rescaled so row
        sums are preserved (Hypre's P_max_elmts move, hypre.c:128 role)."""
        order = np.lexsort((-np.abs(wv), wr2))
        rank = np.arange(wv.size) - np.searchsorted(wr2[order], wr2[order])
        keep_sorted = order[rank < pmax]
        rowsum_all = np.zeros(f_idx.size)
        np.add.at(rowsum_all, wr2, wv)
        kr, kc, kv = wr2[keep_sorted], wc[keep_sorted], wv[keep_sorted]
        rowsum_kept = np.zeros(f_idx.size)
        np.add.at(rowsum_kept, kr, kv)
        scale = np.divide(rowsum_all, rowsum_kept,
                          out=np.ones(f_idx.size), where=rowsum_kept != 0)
        return kr, kc, kv * scale[kr]

    for p in range(passes):
        V = _vstack([W, A_FC] if extra == 1 else [W, A_FC, W])
        W = spgemm(S_op, V)
        if pmax and W.nnz and p < passes - 1:
            # Truncate BETWEEN passes too (not only at the end): the
            # pattern of (off_FF)^p·P otherwise grows superlinearly on
            # dense coarse operators — measured 3.8 s for one level-1
            # improvement at n=262k vs 0.3 s truncated, with the same
            # per-cycle contraction on the reference workload (pinned by
            # test_r3_preset_cycle_factor_under_035).
            tr, tc, tv = _truncate_rows(W.row_indices(), W.cols, W.vals)
            W = CsrMatrix.from_coo(tr, tc, tv, nrows=f_idx.size,
                                   ncols=P.ncols, sum_duplicates=False)

    # Truncate to pmax strongest entries/row, preserving row sums.
    wr2 = W.row_indices()
    if pmax and W.nnz:
        kr, kc, kv = _truncate_rows(wr2, W.cols, W.vals)
    else:
        kr, kc, kv = wr2, W.cols, W.vals

    rows = np.concatenate([f_idx[kr], c_idx])
    cols = np.concatenate([kc, cmap[c_idx]])
    vals = np.concatenate([kv, np.ones(c_idx.size)])
    return CsrMatrix.from_coo(rows, cols, vals, nrows=n, ncols=P.ncols)


def classical_coarsen(A: CsrMatrix, theta: float, seed: int = 0,
                      interp: str = "direct", pmax: int = 4,
                      strength: str = "classical",
                      interp_passes: int = 1,
                      interp_omega: float = 1.0) -> tuple[CsrMatrix, int]:
    """One level of classical AMG coarsening: strength → PMIS → fixup →
    interpolation. `interp`:

    - "ext+i": true distance-2 extended+i (Hypre interp 6, hypre.c:128)
    - "jacobi": direct + one Jacobi-improvement pass with truncation
      (an approximation of the ext+i role)
    - "direct": classical direct interpolation (C-promotion fixup)

    `strength`: "classical" (Ruge-Stüben signed) or "abs" (absolute
    value — the non-M-matrix measure). Returns (P, n_coarse)."""
    s_rows, s_cols, s_idx = classical_strength(A, theta, mode=strength)
    state = pmis_splitting(A.nrows, s_rows, s_cols, seed=seed)
    if interp in ("ext+i", "ext_i", "extended+i"):
        state = promote_uninterpolable_d2(state, s_rows, s_cols)
        if not (state == CPOINT).any():
            return None, 0
        return (lambda P: (P, P.ncols))(
            extended_i_interpolation(A, s_idx, state, pmax=pmax))
    state = promote_uninterpolable(state, s_rows, s_cols)
    if not (state == CPOINT).any():
        return None, 0  # nothing to coarsen to (fully decoupled grid)
    P = direct_interpolation(A, s_idx, state)
    if interp == "jacobi":
        P = jacobi_improve_interpolation(A, P, state, passes=interp_passes,
                                         pmax=pmax, omega=interp_omega)
    return P, P.ncols
