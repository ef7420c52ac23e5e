"""Static per-iteration communication accounting + a link scaling model.

The reference has no distributed path to measure (MPI neutered,
paralmond.cpp:94-102; SURVEY.md §2.2). Two things are produced here:

1. **Exact communication volumes** — every distributed solver's per-
   iteration collective schedule is STATIC (built at setup from the halo /
   2-D plans), so bytes-moved and collective counts are known without
   running anything. `cg_comm_volume` / `cg2d_comm_volume` derive them
   from the same plan objects the solvers use; a trace-count test
   (tests/test_comm_model.py) asserts the accounting matches the
   collectives the solvers actually issue.

2. **A parameterized link model** — `predict_efficiency` combines the
   volumes with (a) a measured single-device per-iteration time, (b) a
   link bandwidth per direction (for the H100 the NVLink entry of
   harness/profile.py's device table) and (c) a per-hop latency, into a
   strong-scaling efficiency prediction:

       t_D = t_1/D  +  bytes_per_spmv/link_bw  +  hop_lat · hops(D)
       eff = (t_1/D) / t_D

   hops(D): a fused psum (all-reduce of ≤3 scalars) is latency-bound —
   2·(D−1) ring hops; each halo ppermute is 1 hop (simultaneous left/
   right). Compute splits as t_1/D because the single-device kernel is
   memory-bound and memory bandwidth scales with devices. The caller
   supplies every rate; none is assumed here.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import build_halo_plan


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class CommVolume:
    """Per-device, per-CG-iteration communication of a distributed solver."""
    strategy: str            # halo | all_gather | 2d
    n_devices: int
    halo: int | None         # H (halo strategy only)
    bytes_per_spmv: int      # payload bytes moved per device per SpMV
    ppermutes_per_spmv: int  # point-to-point exchanges per SpMV
    psums_per_iter: int      # fused scalar all-reduces per CG iteration
    psum_scalars: int        # total scalars carried by those psums
    gather_hops_per_spmv: int = 0  # ring hops of the gather/scatter
    #                         collectives per SpMV: D−1 for a 1-D
    #                         all_gather, (pr−1)+(pc−1) for the 2-D
    #                         all_gather+psum_scatter pair

    @property
    def bytes_per_iter(self) -> int:
        # 1 SpMV per CG iteration + the psum payloads (f64 scalars).
        return self.bytes_per_spmv + self.psum_scalars * 8


def cg_comm_volume(A: CsrMatrix, n_devices: int, dtype=jnp.float32,
                   strategy: str = "auto", row_align: int = 8) -> CommVolume:
    """Distributed-CG (parallel/dist_cg.py) communication, derived from
    the SAME halo plan the solver builds. Counts per iteration:
    1 SpMV (2 ppermutes of H rows on the halo path, or one all_gather
    of the complement on the fallback) + 2 fused psums (p·Ap, then
    r·z with r·r batched — 3 scalars total)."""
    itemsize = jnp.dtype(dtype).itemsize
    plan = build_halo_plan(A, n_devices, dtype, row_align=row_align)
    use_halo = strategy == "halo" or (strategy == "auto"
                                      and not plan.needs_all_gather)
    if n_devices == 1:
        # Collectives on a 1-device mesh move nothing.
        return CommVolume("halo" if use_halo else "all_gather", 1,
                          plan.halo if use_halo else None, 0,
                          2 if use_halo else 0, 2, 3)
    if use_halo:
        return CommVolume("halo", n_devices, plan.halo,
                          2 * plan.halo * itemsize, 2, 2, 3)
    return CommVolume("all_gather", n_devices, None,
                      (plan.n_pad - plan.nloc) * itemsize, 0, 2, 3,
                      gather_hops_per_spmv=n_devices - 1)


def cg2d_comm_volume(A: CsrMatrix, pr: int, pc: int,
                     dtype=jnp.float32) -> CommVolume:
    """2-D distributed CG (parallel/dist2d.py): per SpMV one all_gather
    over ROWS ((pr−1)·csize inbound, pr−1 ring hops) + one psum_scatter
    over COLS ((pc−1)·csize outbound-equivalent, pc−1 hops); 2 fused
    psums over the whole mesh per iteration. csize is computed directly
    from the plan's shape rule (dist2d.py:71-77) — building the full
    O(nnz) device plan just to read a chunk size would defeat host-side
    accounting at scale."""
    itemsize = jnp.dtype(dtype).itemsize
    csize = _round_up(-(-A.nrows // (pr * pc)), 8)
    bytes_spmv = ((pr - 1) + (pc - 1)) * csize * itemsize
    return CommVolume("2d", pr * pc, None, bytes_spmv,
                      0, 2, 3,
                      gather_hops_per_spmv=(pr - 1) + (pc - 1))


def predict_efficiency(t1_iter_s: float, cv: CommVolume,
                       link_gbps: float, hop_latency_s: float):
    """Strong-scaling prediction: (efficiency, t_iter_at_D seconds).

    `t1_iter_s` is a measured single-device per-iteration wall time;
    `link_gbps` the usable bandwidth per link direction and
    `hop_latency_s` the latency of one collective hop."""
    D = cv.n_devices
    if D == 1:
        return 1.0, t1_iter_s
    t_bw = cv.bytes_per_spmv / (link_gbps * 1e9)
    hops = (cv.psums_per_iter * 2 * (D - 1) + cv.ppermutes_per_spmv // 2
            + cv.gather_hops_per_spmv)
    t_lat = hops * hop_latency_s
    t_d = t1_iter_s / D + t_bw + t_lat
    return (t1_iter_s / D) / t_d, t_d


@dataclass
class AmgLevelComm:
    """Per-device communication of ONE VISIT to a hierarchy level (a
    V-cycle visits each level once per cycle; a K-cycle visits level l
    2^(l) times — the visit multipliers are folded into the
    *_per_cycle totals)."""
    level: int
    a_strategy: str          # halo | all_gather (A_l smoother/residual mv)
    a_halo: int | None
    a_applies: int           # A_l matvecs per V-cycle
    r_strategy: str          # restriction R_l (fine → coarse)
    r_halo: int | None
    p_strategy: str          # prolongation P_l (coarse → fine)
    p_halo: int | None
    ppermutes: int           # collective CALLS at this level per V-cycle
    all_gathers: int
    bytes: int               # payload bytes per device per V-cycle (D≥2)


@dataclass
class AmgCommVolume:
    """Per-device communication of the distributed AMG V-cycle and of one
    AMG-preconditioned-CG iteration (parallel/dist_amg.py), derived from
    the SAME halo plans the solver shards (pinned by the trace-count
    tests in tests/test_comm_model.py). The reference's AMG role is
    hypre.c:97 (BoomerAMG setup/solve) — which has no distributed path
    at all (MPI off, libs/hypre.cmake:31); this accounting is the
    scaling story the reference never had."""
    n_devices: int
    levels: list
    coarse_gather_bytes: int      # replicated coarse-solve all_gather
    ppermutes_per_cycle: int
    all_gathers_per_cycle: int    # includes the coarse-grid gather(s)
    bytes_per_cycle: int
    psums_per_cycle: int          # K-cycle: the FCG inner products
    #                               (2 fused psums per coarse_correct
    #                               entry; a V-cycle has 0)
    # One DistributedAmgCg iteration = 1 V-cycle (preconditioner) +
    # 1 fine-level matvec + 2 fused psums (p·Ap; r·z with r·r).
    psums_per_iter: int
    psum_scalars: int
    ppermutes_per_iter: int
    all_gathers_per_iter: int
    bytes_per_iter_payload: int

    def as_comm_volume(self) -> CommVolume:
        """Adapter so `predict_efficiency` prices an AMG-CG iteration."""
        D = self.n_devices
        return CommVolume(
            "amg_cg", D, None, self.bytes_per_iter_payload,
            self.ppermutes_per_iter, self.psums_per_iter, self.psum_scalars,
            gather_hops_per_spmv=self.all_gathers_per_iter * (D - 1))


def amg_comm_volume(solver) -> AmgCommVolume:
    """Account a `_DistAmgBase` solver's V-cycle collective schedule.

    Reads the solver's RESOLVED per-level strategies (`_halos`,
    `_p_halos`, `_r_halos` — None means the all_gather fallback) and the
    smoother protocol: each smoother application issues `degree` A-mat-
    vecs (Chebyshev and Jacobi alike), so one V-cycle does
    (pre+post)·degree + 1 A-applies, 1 R, 1 P per level, plus one
    all_gather for the replicated coarse solve. Counts are collective
    CALLS (what the trace tests count); bytes are the D≥2 payloads."""
    D = solver.n_dev
    opts = solver.opts
    isz = jnp.dtype(solver.dtype).itemsize
    a_applies = (opts.pre_sweeps + opts.post_sweeps) * opts.degree + 1
    nlev = solver.n_levels - 1
    kcycle = getattr(opts, "cycle", "v") == "k"
    levels = []
    pp_cyc = ag_cyc = by_cyc = ps_cyc = 0
    visits = 1  # times level l is entered per top-level cycle
    for l in range(nlev):
        npf, npc = solver.pads[l], solver.pads[l + 1]
        nlf, nlc = npf // D, npc // D
        ha, hr, hp = (solver._halos[l], solver._r_halos[l],
                      solver._p_halos[l])
        # One A-matvec's collective cost (also the K-cycle FCG extra).
        if ha is not None:
            a_pp, a_ag, a_by = 2, 0, 2 * ha * isz
        else:
            a_pp, a_ag, a_by = 0, 1, (npf - nlf) * isz
        pp = a_applies * a_pp
        ag = a_applies * a_ag
        by = a_applies * a_by
        if hr is not None:
            pp += 2
            by += 2 * hr * isz
        else:
            ag += 1
            by += (npf - nlf) * isz
        if hp is not None:
            pp += 2
            by += 2 * hp * isz
        else:
            ag += 1
            by += (npc - nlc) * isz
        # K-cycle: level l (l ≥ 1) is ENTERED visits(l−1) times via
        # coarse_correct, each entry running 2 recursive cycles (so
        # visits double per level) + 2 extra A-matvecs + 2 fused psums
        # (dist_amg.py coarse_correct — the distributed FCG recursion).
        entries = visits
        if kcycle and l >= 1:
            visits = 2 * entries
        levels.append(AmgLevelComm(
            level=l,
            a_strategy="halo" if ha is not None else "all_gather",
            a_halo=ha, a_applies=a_applies,
            r_strategy="halo" if hr is not None else "all_gather",
            r_halo=hr,
            p_strategy="halo" if hp is not None else "all_gather",
            p_halo=hp,
            ppermutes=pp, all_gathers=ag, bytes=by))
        pp_cyc += visits * pp
        ag_cyc += visits * ag
        by_cyc += visits * by
        if kcycle and l >= 1:
            pp_cyc += entries * 2 * a_pp
            ag_cyc += entries * 2 * a_ag
            by_cyc += entries * 2 * a_by
            ps_cyc += entries * 2
    npL = solver.pads[-1]
    coarse_bytes = (npL - npL // D) * isz
    ag_cyc += visits
    by_cyc += visits * coarse_bytes

    # Fine-level matvec of the CG iteration (same operator as level 0).
    l0 = levels[0]
    if l0.a_strategy == "halo":
        pp_it = pp_cyc + 2
        ag_it = ag_cyc
        by_it = by_cyc + 2 * l0.a_halo * isz
    else:
        pp_it = pp_cyc
        ag_it = ag_cyc + 1
        by_it = by_cyc + (solver.pads[0] - solver.pads[0] // D) * isz
    return AmgCommVolume(
        n_devices=D, levels=levels, coarse_gather_bytes=coarse_bytes,
        ppermutes_per_cycle=pp_cyc, all_gathers_per_cycle=ag_cyc,
        bytes_per_cycle=by_cyc, psums_per_cycle=ps_cyc,
        psums_per_iter=2 + ps_cyc,
        psum_scalars=3 + (ps_cyc // 2) * 5,
        ppermutes_per_iter=pp_it, all_gathers_per_iter=ag_it,
        bytes_per_iter_payload=by_it)


def efficiency_crossover_n(nnz_per_row: float, gnnz_per_s: float,
                           n_devices: int, target: float = 0.8,
                           halo_rows: int = 64, dtype=jnp.float32, *,
                           link_gbps: float, hop_latency_s: float) -> int:
    """Smallest n where the model predicts ≥`target` efficiency at
    `n_devices` devices, for a banded operator with the given density and
    a measured single-device SpMV throughput (Gnnz/s → t_1 per CG
    iteration ≈ nnz / rate). Solved by bisection on n."""
    itemsize = jnp.dtype(dtype).itemsize

    def eff(n):
        t1 = (n * nnz_per_row) / (gnnz_per_s * 1e9)
        cv = CommVolume("halo", n_devices, halo_rows,
                        2 * halo_rows * itemsize, 2, 2, 3)
        return predict_efficiency(t1, cv, link_gbps, hop_latency_s)[0]

    lo, hi = 1_000, 1_000_000_000
    if eff(hi) < target:
        return -1
    while hi - lo > max(1000, lo // 100):
        mid = (lo + hi) // 2
        if eff(mid) >= target:
            hi = mid
        else:
            lo = mid
    return hi
