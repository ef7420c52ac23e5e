"""Algebraic multigrid — the Hypre BoomerAMG / AmgX / parAlmond role.

Reference protocols being mirrored (BASELINE.md):
- Hypre: strong threshold 0.25 (hypre.c:167), fixed 2 V-cycles
  (maxiter=2, tol=0 — hypre.c:129,185-186), 1 pre/post sweep. → alias
  "hypre" = fixed cycles=2.
- AmgX: strength 0.25, 1 V-cycle (max_iters=1, amgx.c:83). → alias
  "amgx" = fixed cycles=1.
- parAlmond: single AMG cycle application with near-nullspace vector
  1/sqrt(n) (paralmond.cpp:56-58,130). → alias "paralmond" = fixed
  cycles=1.

Two coarsening families are implemented: smoothed aggregation (the
parAlmond family; this module) and classical PMIS + direct interpolation
(the Hypre/AmgX family; solvers/classical_amg.py), selected by
`coarsening="sa"|"classical"`. The hypre/amgx aliases use classical at
strength 0.25; paralmond uses SA with a K-cycle.

Design: setup (strength, aggregation, prolongator smoothing, Galerkin
RAP via ops/spgemm.py) runs on host once; the cycle is a closed-form jitted
function over static per-level operators in the SpMV layout of
solvers/cg.py::build_matvec, with weighted-Jacobi smoothing. The same one-V-cycle application
serves as a CG preconditioner ("--precond amg") — symmetric because the
pre/post Jacobi sweeps are symmetric.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.ops.spgemm import rap, spgemm
from lsbench_tpu.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu.solvers.cg import build_matvec, resolve_layout


# --------------------------------------------------------------- host setup

def strength_graph(A: CsrMatrix, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric strength: keep off-diag (i,j) with
    |a_ij| >= theta * sqrt(|a_ii a_jj|). Returns (offs, cols) adjacency."""
    r, c, v = A.to_coo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    off = r != c
    strong = off & (np.abs(v) >= theta * np.sqrt(d[r] * d[c]))
    if not strong.any():
        return np.zeros(A.nrows + 1, dtype=np.int64), np.zeros(0, dtype=np.int32)
    G = CsrMatrix.from_coo(r[strong], c[strong], np.ones(strong.sum()),
                           nrows=A.nrows, ncols=A.nrows, sum_duplicates=False)
    return G.offs, G.cols


def aggregate(A: CsrMatrix, theta: float) -> tuple[np.ndarray, int]:
    """Greedy distance-1 aggregation on the strength graph.

    Returns (agg_id per node, n_aggregates). Isolated nodes become
    singletons.
    """
    n = A.nrows
    offs, cols = strength_graph(A, theta)
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    # Pass 1: roots whose strong neighborhood is fully unaggregated.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[offs[i]:offs[i + 1]]
        if (agg[nbrs] >= 0).any():
            continue
        agg[i] = nagg
        agg[nbrs] = nagg
        nagg += 1
    # Pass 2: attach leftovers to an adjacent aggregate.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[offs[i]:offs[i + 1]]
        assigned = nbrs[agg[nbrs] >= 0]
        if assigned.size:
            agg[i] = agg[assigned[0]]
    # Pass 3: remaining isolated nodes → singletons.
    for i in range(n):
        if agg[i] < 0:
            agg[i] = nagg
            nagg += 1
    return agg, nagg


def pairwise_aggregate(A: CsrMatrix, npass: int = 2,
                       beta: float = 0.25) -> tuple[np.ndarray, int]:
    """Notay-style (double) pairwise aggregation (AGMG; the quality
    aggregation behind parAlmond-class K-cycle AMG).

    Each pass greedily matches every unaggregated node with its strongest
    negative coupling among unaggregated neighbours (|a_ij| ≥ beta ·
    max-negative-coupling filter); `npass=2` composes two matchings →
    aggregates of ≤ 4 nodes and a ~4x grid ratio. Bounded aggregates are
    what the greedy distance-1 scheme lacks on wide-stencil (SEM-type)
    matrices — there a root swallows its whole 23-neighbour stencil and
    the coarse grid is 12x smaller with piecewise-constant interpolation
    across it (measured cycle factor 0.94 on xn3b_A_18; 2-pass pairwise
    reaches ~4x ratio instead).
    """
    n = A.nrows
    agg = np.arange(n, dtype=np.int64)  # start: every node a singleton

    Ac = A
    cur = np.arange(n, dtype=np.int64)  # node -> current coarse id
    for _ in range(npass):
        m = Ac.nrows
        r, c, v = Ac.to_coo()
        d = Ac.diagonal()
        sign = np.where(d >= 0, 1.0, -1.0)
        neg = (r != c) & (v * sign[r] < 0)
        # Strongest negative coupling per row (for the beta filter).
        w = np.where(neg, -v * sign[r], 0.0)
        rowmax = np.zeros(m)
        np.maximum.at(rowmax, r, w)

        # Greedy matching, visiting rows by ascending number of strong
        # neighbours (Notay's priority: constrained nodes first).
        strong = neg & (w >= beta * rowmax[r]) & (w > 0)
        sr, sc, sw = r[strong], c[strong], w[strong]
        deg = np.bincount(sr, minlength=m)
        order = np.argsort(deg, kind="stable")
        # CSR-ish access into the strong edge list.
        sidx = np.argsort(sr, kind="stable")
        sr_s, sc_s, sw_s = sr[sidx], sc[sidx], sw[sidx]
        start = np.searchsorted(sr_s, np.arange(m + 1))

        mate = np.full(m, -1, dtype=np.int64)
        for i in order:
            if mate[i] >= 0:
                continue
            lo, hi = start[i], start[i + 1]
            if lo == hi:
                mate[i] = i  # singleton
                continue
            cands = sc_s[lo:hi]
            free = mate[cands] < 0
            if not free.any():
                mate[i] = i
                continue
            j = cands[free][np.argmax(sw_s[lo:hi][free])]
            mate[i] = j
            mate[j] = i

        # Coarse ids: one per pair (or singleton).
        rep = np.minimum(np.arange(m), mate)
        uniq, cmap = np.unique(rep, return_inverse=True)
        cur = cmap[cur]
        # Coarse operator for the next pass (plain Galerkin with
        # piecewise-constant P).
        P = CsrMatrix.from_coo(np.arange(m), cmap, np.ones(m),
                               nrows=m, ncols=uniq.size,
                               sum_duplicates=False)
        Ac = rap(P.transpose(), Ac, P)

    return cur, Ac.nrows


def tentative_prolongator(agg: np.ndarray, nagg: int,
                          nullspace: np.ndarray | None = None) -> CsrMatrix:
    """Piecewise-constant P from the near-nullspace vector (default: the
    constant vector, normalized per aggregate — parAlmond uses 1/sqrt(n),
    paralmond.cpp:56-58; per-aggregate normalization is the standard SA
    equivalent)."""
    n = agg.size
    ns = np.ones(n) if nullspace is None else np.asarray(nullspace, np.float64)
    # Normalize within each aggregate.
    norms = np.zeros(nagg)
    np.add.at(norms, agg, ns * ns)
    norms = np.sqrt(np.where(norms > 0, norms, 1.0))
    vals = ns / norms[agg]
    return CsrMatrix.from_coo(np.arange(n), agg, vals, nrows=n, ncols=nagg,
                              sum_duplicates=False)


def smooth_prolongator(A: CsrMatrix, T: CsrMatrix, omega_scale: float = 4.0 / 3.0
                       ) -> CsrMatrix:
    """P = (I - ω D⁻¹ A) T with ω = omega_scale / ρ(D⁻¹A) (power estimate).

    ω = 4/(3ρ) is the classic smoothed-aggregation damping (Vaněk, Mandel,
    Brezina) — it minimizes the energy of the smoothed basis over [0, ρ].
    Measured V(1,1) factor on the 2-D Laplacian: 0.245 vs 0.636 with the
    Jacobi-relaxation 2/3 damping this initially shipped with."""
    dinv = 1.0 / np.where(A.diagonal() != 0, A.diagonal(), 1.0)
    rho = estimate_rho_dinv_a(A, dinv)
    omega = omega_scale / max(rho, 1e-30)
    AT = spgemm(A, T)
    # P = T - omega * Dinv A T  (row-scaled), assembled in COO.
    r1, c1, v1 = T.to_coo()
    r2, c2, v2 = AT.to_coo()
    return CsrMatrix.from_coo(
        np.concatenate([r1, r2]), np.concatenate([c1, c2]),
        np.concatenate([v1, -omega * dinv[r2] * v2]),
        nrows=T.nrows, ncols=T.ncols)


def estimate_rho_dinv_a(A: CsrMatrix, dinv: np.ndarray, iters: int = 12) -> float:
    """Power iteration for ρ(D⁻¹A) on host."""
    rng = np.random.default_rng(0)
    x = rng.random(A.nrows) + 0.1
    rho = 1.0
    for _ in range(iters):
        y = dinv * A.matvec(x)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 1.0
        rho = nrm / np.linalg.norm(x)
        x = y / nrm
    return float(rho)


@dataclass
class AmgOptions:
    cycle: str = "v"             # "v" or "k" (Notay K-cycle, parAlmond)
    coarsening: str = "sa"       # "sa" (smoothed aggregation, parAlmond
    #                              family) or "classical" (PMIS + direct
    #                              interp — Hypre coarsening 8 / AmgX
    #                              CLASSICAL, hypre.c:127, amgx.c:80)
    theta: float | None = None   # strong threshold; None → per-family
    #                              default: 0.08 SA, 0.25 classical
    #                              (hypre.c:167, amgx.c:81)
    interp: str = "direct"       # classical interpolation: "direct" or
    #                              "jacobi" (direct + Jacobi improvement,
    #                              the ext+i distance-2 role, hypre.c:128)
    strength: str = "classical"  # classical strength measure: "classical"
    interp_passes: int = 1       # Jacobi-improvement passes toward the
    #                              ideal -A_FF^-1 A_FC (interp="jacobi")
    interp_omega: float = 1.0    # damping of those passes (<1 when Jacobi
    #                              on A_FF diverges — the tj7a series)
    pmax: int = 4                # interpolation truncation (entries/row)
    #                              (Ruge-Stüben signed, M-matrix) or "abs"
    #                              (absolute value — for the reference's
    #                              SEM matrices with 32% positive
    #                              off-diagonal mass)
    smoother: str = "chebyshev"  # "chebyshev" (hypre cheby order, hypre.c:137),
    #                              "jacobi" (weight auto-scaled by ρ(D⁻¹A)),
    #                              "l1_jacobi" (ℓ1-scaled, convergent
    #                              undamped), or "l1_gs" (hybrid ℓ1-
    #                              symmetric-GS: exact SGS within 128-row
    #                              tiles via batched triangular
    #                              solves, ℓ1-Jacobi across — the actual
    #                              hypre relax type 8, hypre.c:137)
    degree: int = 2              # Chebyshev degree / Jacobi sweeps
    jacobi_scale: float = 4.0 / 3.0  # ω = scale / ρ(D⁻¹A)
    cheby_lower: float = 0.30    # λmin = lower·ρ (hypre cheby fraction style)
    pre_sweeps: int = 1          # 1 smoother application up/down
    post_sweeps: int = 1         #   (hypre.c:134-135)
    max_levels: int = 12
    coarse_n: int = 128          # direct-solve size
    min_coarsen_ratio: float = 0.9  # stop if nagg > ratio * n
    reorder_coarse: bool = False  # RCM-renumber each coarse level (keeps
    #                               banding so distributed halo exchange
    #                               stays narrow — parallel/dist_amg.py)
    align_coarse: bool = True    # anchor every coarse numbering to mean
    #                               fine position (align_coarse_levels):
    #                               keeps banded operators banded AND
    #                               orientation-aligned across levels, so
    #                               the rectangular halo plans stay narrow


def _coarsen_level(Al: CsrMatrix, opts: AmgOptions, level: int
                   ) -> tuple[CsrMatrix | None, int]:
    """One coarsening step → (P, n_coarse); P=None means stop."""
    if opts.coarsening == "classical":
        from lsbench_tpu.solvers.classical_amg import classical_coarsen
        theta = 0.25 if opts.theta is None else opts.theta
        return classical_coarsen(Al, theta, seed=level, interp=opts.interp,
                                 strength=opts.strength, pmax=opts.pmax,
                                 interp_passes=opts.interp_passes,
                                 interp_omega=opts.interp_omega)
    if opts.coarsening in ("pairwise", "sa_pairwise"):
        # Bounded (≤4-node) aggregates; "pairwise" keeps the piecewise-
        # constant P (pair with cycle="k" — the AGMG/parAlmond recipe),
        # "sa_pairwise" smooths it (energy-minimized basis).
        beta = 0.25 if opts.theta is None else opts.theta
        agg, nagg = pairwise_aggregate(Al, npass=2, beta=beta)
        if nagg == 0:
            return None, 0
        T = tentative_prolongator(agg, nagg)
        if opts.coarsening == "sa_pairwise":
            return smooth_prolongator(Al, T), nagg
        return T, nagg
    theta = 0.08 if opts.theta is None else opts.theta
    agg, nagg = aggregate(Al, theta)
    if nagg == 0:
        return None, 0
    T = tentative_prolongator(agg, nagg)
    return smooth_prolongator(Al, T), nagg


def _pack_csr(out: dict, prefix: str, M: CsrMatrix) -> None:
    out[prefix + "_shape"] = np.asarray(M.shape, dtype=np.int64)
    out[prefix + "_offs"] = M.offs
    out[prefix + "_cols"] = M.cols
    out[prefix + "_vals"] = M.vals


def _unpack_csr(z: dict, prefix: str) -> CsrMatrix:
    nr, nc = (int(v) for v in z[prefix + "_shape"])
    return CsrMatrix(nr, nc, z[prefix + "_offs"], z[prefix + "_cols"],
                     z[prefix + "_vals"])


def align_coarse_levels(mats, Acoarse):
    """Renumber every coarse level so coarse ids follow the mean fine
    position of their interpolatory sets (stable argsort over P's column
    supports).

    Whenever the FINE operator is banded (RCM'd, or grid-ordered like
    the production Poisson/SEM cases), this keeps every coarse operator
    banded AND orientation-aligned with the finer level — RCM
    renumbering alone (reorder_coarse) bands each level but leaves its
    orientation arbitrary (RCM can start from either peripheral end),
    which blows up the halo width of the rectangular halo plans
    (parallel/dist_spmv.py::build_rect_halo_plan). Pure renumbering:
    permutation-invariant math (rho unchanged; dinv permuted)."""
    mats = [dict(m) for m in mats]
    for l in range(len(mats)):
        P = mats[l]["P"]
        pr, pc, pv = P.to_coo()
        nc = P.ncols
        pos_sum = np.zeros(nc)
        cnt = np.zeros(nc)
        np.add.at(pos_sum, pc, pr.astype(np.float64))
        np.add.at(cnt, pc, 1.0)
        order = np.argsort(pos_sum / np.maximum(cnt, 1.0), kind="stable")
        if np.array_equal(order, np.arange(nc)):
            continue
        rank = np.empty(nc, dtype=np.int64)
        rank[order] = np.arange(nc)
        P2 = CsrMatrix.from_coo(pr, rank[pc], pv, nrows=P.nrows, ncols=nc,
                                sum_duplicates=False)
        mats[l]["P"] = P2
        mats[l]["R"] = P2.transpose()
        if l + 1 < len(mats):
            nxt = mats[l + 1]
            nxt["A"] = nxt["A"].permuted(order)
            nxt["dinv"] = np.asarray(nxt["dinv"])[order]
            if "dinv_l1" in nxt:
                nxt["dinv_l1"] = np.asarray(nxt["dinv_l1"])[order]
            # The next level's P lives in level-(l+1) ROW coordinates —
            # renumber its rows too (columns are handled at level l+1).
            nr, ncc, nv = nxt["P"].to_coo()
            nxt["P"] = CsrMatrix.from_coo(rank[nr], ncc, nv,
                                          nrows=nxt["P"].nrows,
                                          ncols=nxt["P"].ncols,
                                          sum_duplicates=False)
            nxt["R"] = nxt["P"].transpose()
        else:
            Acoarse = Acoarse.permuted(order)
    return mats, Acoarse


def _maybe_align(mats, Acoarse, opts: AmgOptions):
    if opts.align_coarse and mats:
        return align_coarse_levels(mats, Acoarse)
    return mats, Acoarse


def build_matrix_hierarchy(A: CsrMatrix, opts: AmgOptions,
                           breakdown: dict | None = None):
    """Host coarsening loop → (level_mats, A_coarse). Each level entry is
    dict(A, P, R, dinv, rho) in CSR; A_coarse is the final (direct-solve)
    operator. Shared by the single-chip and distributed (parallel/dist_amg)
    builds.

    With the setup cache enabled (harness/cache.py), two hit levels:
    - EXACT hit (structure + values): the stored hierarchy is returned.
    - PATTERN hit (same structure, new values — parameter-dependent
      re-assembly): frozen-hierarchy device re-setup. The stored C/F
      splittings and transfer operators P/R are kept, and every coarse
      operator is re-formed ON DEVICE by the two-pass numeric RAP
      (ops/spgemm_device.py) — the hypre.c:97 on-device BoomerAMGSetup
      role. Smoother scalings (dinv, ℓ1, ρ) are recomputed from the new
      values. `breakdown` (if given) records which path ran and the
      device-RAP seconds.
    """
    from lsbench_tpu.harness import cache
    key = pat_key = None
    if cache.is_enabled():
        opt_sig = ("amg_hier_v4", opts.coarsening, opts.theta, opts.interp,
                   opts.interp_passes, opts.interp_omega, opts.pmax,
                   opts.strength, opts.coarse_n, opts.max_levels,
                   opts.min_coarsen_ratio, opts.reorder_coarse)
        key = cache.key_of(cache.fingerprint_csr(A), *opt_sig)
        pat_key = cache.key_of(cache.fingerprint_pattern(A), *opt_sig)
        hit = cache.load_arrays("amg_hier", key)
        if hit is not None:
            if breakdown is not None:
                breakdown["hier_cache"] = "exact_hit"
            nlev = int(hit["n_levels"][0])
            mats = [dict(A=_unpack_csr(hit, f"l{l}_A"),
                         P=_unpack_csr(hit, f"l{l}_P"),
                         R=_unpack_csr(hit, f"l{l}_R"),
                         dinv=hit[f"l{l}_dinv"],
                         dinv_l1=hit[f"l{l}_dinv_l1"],
                         rho=float(hit[f"l{l}_rho"][0]))
                    for l in range(nlev)]
            return _maybe_align(mats, _unpack_csr(hit, "coarse"), opts)
        refreshed = _pattern_hit_refresh(A, pat_key, key, breakdown)
        if refreshed is not None:
            return _maybe_align(refreshed[0], refreshed[1], opts)

    mats = []
    Al = A
    while (Al.nrows > opts.coarse_n and len(mats) < opts.max_levels):
        P, nagg = _coarsen_level(Al, opts, len(mats))
        if P is None or nagg >= opts.min_coarsen_ratio * Al.nrows:
            break
        if opts.reorder_coarse:
            # Renumber the coarse space by RCM of the coarse operator so
            # every level stays banded (math is permutation-invariant).
            from lsbench_tpu.ordering.rcm import rcm_ordering
            Ac0 = rap(P.transpose(), Al, P)
            cperm = rcm_ordering(Ac0)
            cinv = np.empty_like(cperm)
            cinv[cperm] = np.arange(cperm.size)
            pr, pc, pv = P.to_coo()
            P = CsrMatrix.from_coo(pr, cinv[pc], pv, nrows=P.nrows,
                                   ncols=P.ncols, sum_duplicates=False)
        R = P.transpose()
        Ac = rap(R, Al, P)
        d = Al.diagonal()
        dinv = 1.0 / np.where(d != 0, d, 1.0)
        # ℓ1 diagonal d_i = a_ii + Σ_{j≠i}|a_ij| — the convergent-without-
        # damping smoother scaling of Hypre's ℓ1 relaxation family
        # (relax type 8, hypre.c:137).
        rl, cl_, vl = Al.to_coo()
        l1 = d.copy()
        offm = rl != cl_
        np.add.at(l1, rl[offm], np.abs(vl[offm]))
        dinv_l1 = 1.0 / np.where(l1 != 0, l1, 1.0)
        # Smoother spectral bound: ρ(D⁻¹A) per level (power iteration).
        rho = estimate_rho_dinv_a(Al, dinv)
        mats.append(dict(A=Al, P=P, R=R, dinv=dinv, dinv_l1=dinv_l1,
                         rho=rho))
        Al = Ac

    if key is not None:
        out = {"n_levels": np.asarray([len(mats)], dtype=np.int64)}
        for l, m in enumerate(mats):
            _pack_csr(out, f"l{l}_A", m["A"])
            _pack_csr(out, f"l{l}_P", m["P"])
            _pack_csr(out, f"l{l}_R", m["R"])
            out[f"l{l}_dinv"] = m["dinv"]
            out[f"l{l}_dinv_l1"] = m["dinv_l1"]
            out[f"l{l}_rho"] = np.asarray([m["rho"]])
        _pack_csr(out, "coarse", Al)
        cache.store_arrays("amg_hier", key, out)
        # Pattern-keyed copy for same-structure re-setup (device RAP).
        cache.store_arrays("amg_hier_pat", pat_key, out)
    if breakdown is not None:
        breakdown.setdefault("hier_cache", "miss")
    return _maybe_align(mats, Al, opts)


# In-process memo of refreshers so repeated same-pattern re-setups skip
# the host symbolic pass entirely (the plans are static per pattern).
_REFRESHERS: dict[str, "HierarchyRefresher"] = {}
_REFRESHERS_MAX = 4


def _pattern_hit_refresh(A: CsrMatrix, pat_key: str, exact_key: str,
                         breakdown: dict | None):
    """Exact-miss path: try the pattern-keyed store; on hit, re-setup the
    hierarchy on device from A's NEW values and memoize the refresher."""
    import time as _time

    from lsbench_tpu.harness import cache

    refresher = _REFRESHERS.get(pat_key)
    if refresher is None:
        hit = cache.load_arrays("amg_hier_pat", pat_key)
        if hit is None:
            return None
        nlev = int(hit["n_levels"][0])
        mats = [dict(A=_unpack_csr(hit, f"l{l}_A"),
                     P=_unpack_csr(hit, f"l{l}_P"),
                     R=_unpack_csr(hit, f"l{l}_R"),
                     dinv=hit[f"l{l}_dinv"],
                     dinv_l1=hit[f"l{l}_dinv_l1"],
                     rho=float(hit[f"l{l}_rho"][0]))
                for l in range(nlev)]
        if nlev == 0:
            return None
        try:
            refresher = HierarchyRefresher(mats, _unpack_csr(hit, "coarse"))
        except ValueError:
            # Stale/incompatible pattern entry (e.g. from an older code
            # version): a best-effort cache must fall back to a full
            # rebuild, never abort the solve.
            return None
        if len(_REFRESHERS) >= _REFRESHERS_MAX:
            # Bounded memo: each refresher pins expansion-triple index
            # arrays (hundreds of MB at n=262k) on device.
            _REFRESHERS.pop(next(iter(_REFRESHERS)))
        _REFRESHERS[pat_key] = refresher

    t0 = _time.perf_counter()
    mats, Acoarse = refresher.refresh(A.vals)
    if breakdown is not None:
        breakdown["hier_cache"] = "pattern_hit_device_rap"
        breakdown["rap_device_s"] = _time.perf_counter() - t0
    # Deliberately NOT stored under the exact key: the refreshed
    # hierarchy has FROZEN (lagged) transfer operators from the pattern
    # entry's original values; storing it as this matrix's exact entry
    # would make later runs serve the lagged hierarchy labeled
    # "exact_hit", silently dependent on cache insertion order. Repeat
    # refreshes stay fast through the in-process memo.
    del exact_key
    return mats, Acoarse


class HierarchyRefresher:
    """Frozen-hierarchy re-setup: same sparsity, new matrix values.

    The C/F splitting and transfer operators P/R are frozen (their
    patterns AND weights — the standard lagged-hierarchy re-assembly);
    each coarse operator A_{l+1} = R_l A_l P_l is re-formed on DEVICE via
    the host-symbolic / device-numeric two-pass RAP
    (ops/spgemm_device.py::rap_symbolic + rap_numeric — the hypre.c:97
    on-device BoomerAMGSetup role). Smoother scalings (D⁻¹, ℓ1, ρ) are
    recomputed from the new values; the symbolic plans are built once and
    reused for every subsequent refresh.
    """

    def __init__(self, mats: list[dict], Acoarse: CsrMatrix):
        from lsbench_tpu.ops.spgemm_device import rap_numeric_idx, rap_symbolic

        self._mats = mats
        self._Acoarse = Acoarse
        self._plan_idx = []   # 8-tuples of index arrays, passed as jit ARGS
        self._rp_vals = []
        self._nnz_pairs = []
        chain = [m["A"] for m in mats] + [Acoarse]
        for l, m in enumerate(mats):
            plan = rap_symbolic(m["R"], m["A"], m["P"])
            nxt = chain[l + 1]
            # The plan's output pattern must BE the stored coarse pattern
            # (both canonical row-major CSR) — the refreshed values drop
            # straight into the stored structure.
            if not (np.array_equal(plan.rap.offs, nxt.offs)
                    and np.array_equal(plan.rap.cols, nxt.cols)):
                raise ValueError(
                    "RAP plan pattern mismatch vs stored hierarchy "
                    f"(level {l}) — cache entry stale")
            # Index arrays ride as jit arguments, NOT captured constants:
            # at n=262k the expansion triples are hundreds of MB, which
            # would otherwise be embedded in the executable.
            self._plan_idx.append((plan.ra.a_idx, plan.ra.b_idx,
                                   plan.ra.pads, plan.ra.slot_pos,
                                   plan.rap.a_idx, plan.rap.b_idx,
                                   plan.rap.pads, plan.rap.slot_pos))
            self._rp_vals.append((jnp.asarray(m["R"].vals),
                                  jnp.asarray(m["P"].vals)))
            self._nnz_pairs.append((plan.ra.nnz, plan.rap.nnz))

        nnz_pairs = self._nnz_pairs

        # ONE jitted program for the whole chain: one compile and one
        # dispatch per refresh instead of one per level and product.
        @jax.jit
        def _chain(plan_idx_all, rp_all, fine_vals):
            vals = fine_vals
            out = [vals]
            for l in range(len(nnz_pairs)):
                rv, pv = rp_all[l]
                vals = rap_numeric_idx(plan_idx_all[l], *nnz_pairs[l],
                                       rv, vals, pv)
                out.append(vals)
            return tuple(out)

        self._chain = _chain

    def refresh(self, fine_vals) -> tuple[list[dict], CsrMatrix]:
        # Phase 1: ONE device program runs the whole RAP chain (each
        # level feeds the next); the host then recomputes smoother
        # scalings while the device drains.
        vals = jnp.asarray(np.asarray(fine_vals, dtype=np.float64))
        level_vals = self._chain(tuple(self._plan_idx),
                                 tuple(self._rp_vals), vals)

        # Phase 2: per-level host pass (diagonals, l1 scaling, rho).
        new_mats = []
        for l, m in enumerate(self._mats):
            Al = CsrMatrix(nrows=m["A"].nrows, ncols=m["A"].ncols,
                           offs=m["A"].offs, cols=m["A"].cols,
                           vals=np.asarray(level_vals[l], dtype=np.float64))
            d = Al.diagonal()
            dinv = 1.0 / np.where(d != 0, d, 1.0)
            rl, cl_, vl = Al.to_coo()
            l1 = d.copy()
            offm = rl != cl_
            np.add.at(l1, rl[offm], np.abs(vl[offm]))
            dinv_l1 = 1.0 / np.where(l1 != 0, l1, 1.0)
            rho = estimate_rho_dinv_a(Al, dinv)
            new_mats.append(dict(A=Al, P=m["P"], R=m["R"], dinv=dinv,
                                 dinv_l1=dinv_l1, rho=rho))
        Ac = CsrMatrix(nrows=self._Acoarse.nrows, ncols=self._Acoarse.ncols,
                       offs=self._Acoarse.offs, cols=self._Acoarse.cols,
                       vals=np.asarray(level_vals[-1], dtype=np.float64))
        return new_mats, Ac


def l1_gs_blocks(M: CsrMatrix, block: int = 128):
    """Host build of the hybrid ℓ1-GS per-block factors.

    Hypre's relax type 8 (hypre.c:137) is ℓ1-scaled hybrid symmetric
    Gauss-Seidel (Baker, Falgout, Kolev & Yang 2011): exact GS inside a
    process, Jacobi across, with the off-process couplings folded into an
    ℓ1 diagonal d_i = a_ii + Σ_{j∉block}|a_ij| so the sweep stays
    convergent without damping. The "process" unit here is a 128-row
    tile: within-tile sweeps become ONE batched (nb,128,128) triangular
    solve — no sequential dependence across tiles.

    Returns (Lblk, d_l1): Lblk[k] = strictly-lower within-block part of A
    plus diag(d_l1) (padding rows get unit diagonal), d_l1 of length n.
    The symmetric sweep uses Lblkᵀ for the up-sweep, which equals the
    within-block upper part for symmetric A (the AMG workload is SPD).
    """
    n = M.nrows
    nb = -(-n // block)
    r, c, v = M.to_coo()
    rb, cb = r // block, c // block
    d = M.diagonal()
    d_l1 = d.copy()
    off_block = rb != cb
    np.add.at(d_l1, r[off_block], np.abs(v[off_block]))
    d_l1 = np.where(d_l1 != 0, d_l1, 1.0)
    Lblk = np.zeros((nb, block, block))
    wl = (~off_block) & (c < r)           # within-block strict lower
    Lblk[rb[wl], r[wl] % block, c[wl] % block] = v[wl]
    rows = np.arange(nb * block)
    diag = np.ones(nb * block)
    diag[:n] = d_l1
    Lblk[rows // block, rows % block, rows % block] = diag
    return Lblk, d_l1


def coarse_cholesky(Al: CsrMatrix, dtype) -> jax.Array:
    """Dense factor of the coarsest operator (symmetrized)."""
    dense = Al.to_dense()
    dense = (dense + dense.T) * 0.5
    L = np.linalg.cholesky(dense + 1e-30 * np.eye(Al.nrows))
    return jnp.asarray(L, dtype=dtype)


def build_hierarchy(A: CsrMatrix, opts: AmgOptions, dtype, layout: str,
                    breakdown: dict | None = None):
    """Host setup → (level_params, level_aps, coarse_factor).

    `level_params` is a pytree of device arrays (operator layouts +
    inverse diagonals) meant to be passed as a jit ARGUMENT; `level_aps`
    holds the static side (apply functions, spectral bounds, sizes).
    Splitting the two keeps the hierarchy out of the executable's captured
    constants (which cost per dispatch and bloat the binary)."""
    mats, Al = build_matrix_hierarchy(A, opts, breakdown=breakdown)

    def matvec(M):
        return build_matvec(M, dtype, resolve_layout(layout, dtype, M))

    level_params, level_aps = [], []
    for m in mats:
        a_ap, a_op, _ = matvec(m["A"])
        p_ap, p_op, _ = matvec(m["P"])
        r_ap, r_op, _ = matvec(m["R"])
        lp = dict(
            a=a_op, p=p_op, r=r_op,
            inv_diag=jnp.asarray(m["dinv"], dtype=dtype),
            inv_l1=jnp.asarray(m["dinv_l1"], dtype=dtype))
        if opts.smoother == "l1_gs":
            Lblk, d_l1 = l1_gs_blocks(m["A"])
            pad = Lblk.shape[0] * Lblk.shape[1]
            dpad = np.ones(pad)
            dpad[: d_l1.size] = d_l1
            lp["gs_l"] = jnp.asarray(Lblk, dtype=dtype)
            lp["gs_d"] = jnp.asarray(dpad, dtype=dtype)
        level_params.append(lp)
        level_aps.append(dict(a=a_ap, p=p_ap, r=r_ap, rho=m["rho"],
                              n_fine=m["A"].nrows, n_coarse=m["P"].ncols))
    return level_params, level_aps, coarse_cholesky(Al, dtype)


# -------------------------------------------------------------- device cycle

def make_vcycle(level_aps, opts: AmgOptions, dtype) -> Callable:
    """Return vcycle(level_params, coarse_L, b, x0) -> x, a jittable
    closed-form V-cycle taking the hierarchy arrays as arguments."""
    import jax.scipy.linalg as jsl

    def coarse_solve(coarse_L, b):
        y = jsl.solve_triangular(coarse_L, b, lower=True)
        return jsl.solve_triangular(coarse_L, y, lower=True, trans=1)

    def jacobi_smooth(ap, L, b, x):
        om = jnp.asarray(opts.jacobi_scale / ap["rho"], dtype)
        for _ in range(opts.degree):
            x = x + om * L["inv_diag"] * (b - ap["a"](L["a"], x))
        return x

    def chebyshev_smooth(ap, L, b, x):
        """Chebyshev polynomial smoother on D⁻¹A over [lower·ρ, 1.1·ρ]
        (hypre's cheby smoother family, order = opts.degree)."""
        mv = lambda v: ap["a"](L["a"], v)
        dinv = L["inv_diag"]
        lmax = 1.1 * ap["rho"]
        lmin = opts.cheby_lower * ap["rho"]
        theta = jnp.asarray((lmax + lmin) / 2.0, dtype)
        delta = jnp.asarray((lmax - lmin) / 2.0, dtype)
        sigma = theta / delta
        rho_k = 1.0 / sigma
        r = b - mv(x)
        d = (dinv * r) / theta
        for k in range(opts.degree - 1):
            x = x + d
            r = r - mv(d)
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            d = (rho_k1 * rho_k) * d + (2.0 * rho_k1 / delta) * (dinv * r)
            rho_k = rho_k1
        return x + d

    def l1_jacobi_smooth(ap, L, b, x):
        """ℓ1-Jacobi: x += D_ℓ1⁻¹ (b − Ax), D_ℓ1 = a_ii + Σ_{j≠i}|a_ij|.
        Convergent without damping for SPD A (Baker, Falgout, Kolev &
        Yang 2011) — the hypre relax-8 family member that vectorizes
        (the GS half is sequential)."""
        for _ in range(opts.degree):
            x = x + L["inv_l1"] * (b - ap["a"](L["a"], x))
        return x

    def l1_gs_smooth(ap, L, b, x):
        """Hybrid ℓ1-symmetric-GS (hypre relax 8, hypre.c:137): exact
        symmetric Gauss-Seidel within each 128-row tile, ℓ1-compensated
        Jacobi across tiles. One sweep = one SpMV + two batched
        triangular solves:  x += (D+U)⁻¹ D (L+D)⁻¹ (b − Ax)  blockwise,
        with D the ℓ1 diagonal (see l1_gs_blocks)."""
        blk = L["gs_l"]                       # (nb, B, B) lower, ℓ1 diag
        dpad = L["gs_d"]                      # (nb*B,) ℓ1 diag, 1-padded
        nb, Bb, _ = blk.shape
        n = ap["n_fine"]
        for _ in range(opts.degree):
            r = b - ap["a"](L["a"], x)
            rp = jnp.zeros(nb * Bb, dtype).at[:n].set(r).reshape(nb, Bb, 1)
            z1 = jax.lax.linalg.triangular_solve(
                blk, rp, left_side=True, lower=True)
            w = dpad.reshape(nb, Bb, 1) * z1
            z = jax.lax.linalg.triangular_solve(
                blk, w, left_side=True, lower=True, transpose_a=True)
            x = x + z.reshape(-1)[:n]
        return x

    smooth = {"chebyshev": chebyshev_smooth,
              "jacobi": jacobi_smooth,
              "l1_jacobi": l1_jacobi_smooth,
              "l1_gs": l1_gs_smooth}[opts.smoother]
    nlev = len(level_aps)

    def coarse_correct(levels, coarse_L, lvl: int, rc):
        """Approximate solve of A_{lvl} e = rc by one cycle (V) or two
        Krylov steps preconditioned by the cycle (K-cycle, Notay —
        parAlmond's algorithm, paralmond.cpp AMGSetup/Operator role)."""
        if lvl == nlev:
            return coarse_solve(coarse_L, rc)
        if opts.cycle == "v":
            return cycle(levels, coarse_L, lvl, rc, jnp.zeros_like(rc))
        ap, L = level_aps[lvl], levels[lvl]
        mv = lambda v: ap["a"](L["a"], v)
        eps = jnp.asarray(1e-30, dtype)
        # Step 1 (FCG): u = M rc
        u = cycle(levels, coarse_L, lvl, rc, jnp.zeros_like(rc))
        v = mv(u)
        rho1 = jnp.vdot(u, v) + eps
        alpha1 = jnp.vdot(u, rc)
        rt = rc - (alpha1 / rho1) * v
        # Step 2: w = M rt, combined A-orthogonal update.
        w = cycle(levels, coarse_L, lvl, rt, jnp.zeros_like(rt))
        z = mv(w)
        gamma = jnp.vdot(v, w)
        rho2 = jnp.vdot(w, z) - gamma * gamma / rho1 + eps
        alpha2 = jnp.vdot(w, rt)
        return (alpha1 / rho1 - gamma * alpha2 / (rho1 * rho2)) * u \
            + (alpha2 / rho2) * w

    def cycle(levels, coarse_L, lvl: int, b, x):
        if lvl == nlev:
            return coarse_solve(coarse_L, b)
        ap, L = level_aps[lvl], levels[lvl]
        for _ in range(opts.pre_sweeps):
            x = smooth(ap, L, b, x)
        r = b - ap["a"](L["a"], x)
        rc = ap["r"](L["r"], r)
        ec = coarse_correct(levels, coarse_L, lvl + 1, rc)
        x = x + ap["p"](L["p"], ec)
        for _ in range(opts.post_sweeps):
            x = smooth(ap, L, b, x)
        return x

    def vcycle(level_params, coarse_L, b, x0):
        return cycle(level_params, coarse_L, 0,
                     b.astype(dtype), x0.astype(dtype))

    return vcycle


# ------------------------------------------------------------------- solver

@register_solver("amg")
class AmgSolver(Solver):
    """Standalone AMG: fixed-cycle mode (cycles=k, like Hypre maxiter=2
    tol=0) or converge mode (rtol + maxiter)."""

    def __init__(self, A: CsrMatrix, dtype=jnp.float64, cycles=None,
                 rtol=1e-8, maxiter=100, theta=None, coarsening="sa",
                 interp="direct", smoother="chebyshev", strength="classical",
                 interp_passes=1, pmax=4, interp_omega=1.0,
                 degree=2, cycle="v", pre_sweeps=1, post_sweeps=1,
                 coarse_n=128, max_levels=12, layout="auto", ordering="none",
                 **params):
        super().__init__(A, **params)
        self.dtype = jnp.dtype(dtype)
        self.cycles = int(cycles) if cycles is not None else None
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        resolve_layout(layout, self.dtype, A)   # refuse unknown names early
        self.layout = layout        # resolved per level operator
        if str(ordering).lower() not in ("none", ""):
            # AMG coarsening is permutation-invariant; the flag is accepted
            # for CLI parity (cusparse.c:66-85 is the only reference user)
            # but has no effect here — say so instead of silently ignoring.
            import sys
            print(f"amg: --ordering {ordering} has no effect "
                  "(AMG coarsening is permutation-invariant); ignoring.",
                  file=sys.stderr)
        del ordering

        opts = AmgOptions(cycle=cycle, theta=theta, coarsening=coarsening,
                          interp=interp, smoother=smoother, strength=strength,
                          interp_passes=interp_passes, pmax=pmax,
                          interp_omega=interp_omega,
                          degree=degree, pre_sweeps=pre_sweeps,
                          post_sweeps=post_sweeps, coarse_n=coarse_n,
                          max_levels=max_levels)
        self.opts = opts
        perm_dev = inv_dev = None
        Ah = A
        if smoother == "l1_gs":
            # Hybrid ℓ1-GS sweeps exactly within 128-row tiles; like
            # hypre's process-local GS it only bites when a tile holds a
            # graph NEIGHBORHOOD. RCM-band the operator internally (and
            # keep coarse levels banded) so tiles capture couplings; the
            # permutation is undone on the returned x.
            from lsbench_tpu.ordering.rcm import rcm_ordering
            perm = rcm_ordering(A)
            if not np.array_equal(perm, np.arange(A.nrows)):
                Ah = A.permuted(perm)
                inv = np.empty_like(perm)
                inv[perm] = np.arange(A.nrows)
                perm_dev, inv_dev = jnp.asarray(perm), jnp.asarray(inv)
            opts.reorder_coarse = True
        import time as _time
        _t0 = _time.perf_counter()
        level_params, level_aps, coarse_L = build_hierarchy(
            Ah, opts, self.dtype, self.layout,
            breakdown=self.setup_breakdown)
        self.setup_breakdown["hierarchy_s"] = _time.perf_counter() - _t0
        self.n_levels = len(level_aps) + 1
        vcycle = make_vcycle(level_aps, opts, self.dtype)
        # Fine-level residual operator (independent of hierarchy depth).
        if level_aps:
            fine_mv = lambda lv, x: level_aps[0]["a"](lv[0]["a"], x)
        else:
            f_ap, f_op, _ = build_matvec(
                Ah, self.dtype, resolve_layout(layout, self.dtype, Ah))
            level_params = [dict(a=f_op)]
            fine_mv = lambda lv, x: f_ap(lv[0]["a"], x)
        dt = self.dtype
        self._params = (level_params, coarse_L)

        if self.cycles is not None:
            k = self.cycles

            @jax.jit
            def _solve(lv, cL, b):
                b = b.astype(dt)
                if perm_dev is not None:
                    b = b[perm_dev]
                x = jnp.zeros_like(b)
                for _ in range(k):
                    x = vcycle(lv, cL, b, x)
                r = b - fine_mv(lv, x)
                if inv_dev is not None:
                    x = x[inv_dev]
                return x, jnp.sqrt(jnp.vdot(r, r)), jnp.sqrt(jnp.vdot(b, b))
        else:
            rtol_c, maxiter_c = self.rtol, self.maxiter

            @jax.jit
            def _solve(lv, cL, b):
                b = b.astype(dt)
                if perm_dev is not None:
                    b = b[perm_dev]
                bb = jnp.vdot(b, b)
                tol2 = (rtol_c ** 2) * bb

                def cond(s):
                    x, rr, it = s
                    return jnp.logical_and(it < maxiter_c, rr > tol2)

                def body(s):
                    x, rr, it = s
                    x = vcycle(lv, cL, b, x)
                    r = b - fine_mv(lv, x)
                    return (x, jnp.vdot(r, r), it + 1)

                x0 = jnp.zeros_like(b)
                x, rr, it = jax.lax.while_loop(
                    cond, body, (x0, bb, jnp.int32(0)))
                if inv_dev is not None:
                    x = x[inv_dev]
                return x, jnp.sqrt(rr), jnp.sqrt(bb), it

        self._jit_solve = _solve

    def solve(self, b) -> SolveResult:
        out = self._jit_solve(*self._params, jnp.asarray(b))
        if self.cycles is not None:
            x, rnorm, bnorm = out
            iters = self.cycles
            # Fixed-cycle protocol: "converged" is not the contract
            # (hypre tol=0); report residual as data (SURVEY.md §5).
            rnorm, bnorm = float(rnorm), float(bnorm)
            relres = rnorm / bnorm if bnorm > 0 else 0.0
            extra = {"mode": f"fixed_{self.cycles}_cycles",
                     "levels": self.n_levels}
            return SolveResult(x=x, iters=iters, relres=relres,
                               converged=True, extra=extra)
        x, rnorm, bnorm, iters = out
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        extra = {"levels": self.n_levels}
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra=extra)

    def solve_fn(self):
        params, jit_solve = self._params, self._jit_solve
        return lambda b: jit_solve(*params, b)[0]


def amg_precond(A: CsrMatrix, dtype, **amg_params):
    """One V-cycle as a CG preconditioner (symmetric: Jacobi pre+post).

    The hierarchy arrays ride in the preconditioner *state* (a jit
    argument), not in captured constants."""
    layout = amg_params.pop("layout", "auto")
    resolve_layout(layout, dtype, A)   # refuse unknown names early
    opts = AmgOptions(**amg_params)
    perm_dev = inv_dev = None
    if opts.smoother == "l1_gs":
        # Same internal RCM banding as AmgSolver (tiles must capture
        # neighborhoods); applied as Pᵀ M⁻¹ P so the preconditioner stays
        # SPD for CG.
        from lsbench_tpu.ordering.rcm import rcm_ordering
        perm = rcm_ordering(A)
        if not np.array_equal(perm, np.arange(A.nrows)):
            A = A.permuted(perm)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(A.nrows)
            perm_dev, inv_dev = jnp.asarray(perm), jnp.asarray(inv)
        opts.reorder_coarse = True
    level_params, level_aps, coarse_L = build_hierarchy(A, opts, dtype, layout)
    vcycle = make_vcycle(level_aps, opts, dtype)

    def apply(state, r):
        lv, cL = state
        if perm_dev is not None:
            r = r[perm_dev]
        z = vcycle(lv, cL, r, jnp.zeros_like(r))
        if inv_dev is not None:
            z = z[inv_dev]
        return z

    return (level_params, coarse_L), apply
