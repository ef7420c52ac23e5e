"""Communication accounting (parallel/comm_model.py) vs the collectives
the distributed solvers ACTUALLY issue.

The solvers' collective schedules are static (built from the same plans
the model reads), so the trace of one jitted solve must contain exactly
the modeled counts: monkeypatched jax.lax.ppermute / jax.lax.psum /
jax.lax.all_gather record every call made while the shard_map body is
traced (a while_loop body traces ONCE, so body collectives appear once —
the per-iteration counts — plus the init-phase psums)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lsbench_tpu.matrix.generate import poisson_2d
from lsbench_tpu.matrix.io import read_matrix
from lsbench_tpu.parallel.comm_model import (cg2d_comm_volume,
                                             cg_comm_volume,
                                             efficiency_crossover_n,
                                             predict_efficiency)
from lsbench_tpu.parallel.mesh import make_mesh_2d, make_row_mesh



@pytest.fixture()
def collective_counts(monkeypatch):
    counts = {"ppermute": 0, "psum": 0, "all_gather": 0, "psum_scatter": 0}
    orig = {k: getattr(jax.lax, k) for k in counts}

    def wrap(name):
        def f(*a, **k):
            counts[name] += 1
            return orig[name](*a, **k)
        return f

    for k in counts:
        monkeypatch.setattr(jax.lax, k, wrap(k))
    return counts


def _require(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} simulated devices")


def test_cg_halo_counts_match_trace(ref_data_dir, collective_counts):
    _require(4)
    from lsbench_tpu.ordering.rcm import rcm_ordering
    A = read_matrix(str(ref_data_dir / "xn3b_A_10.txt"))
    A = A.permuted(rcm_ordering(A))   # banded → halo exists at 4 devices
    b = np.arange(A.nrows, dtype=np.float64)
    cv = cg_comm_volume(A, 4, jnp.float64, strategy="halo")
    assert cv.strategy == "halo"

    from lsbench_tpu.parallel.dist_cg import DistributedCg
    s = DistributedCg(A, make_row_mesh(4), dtype="float64", rtol=0.0,
                      maxiter=3, strategy="halo", local_spmv="ell")
    assert s.plan.halo == cv.halo                      # same plan
    s.solve(b)   # forces the trace
    # Body (one iteration): 2 ppermutes for the halo exchange, 2 fused
    # psums. Init phase adds 2 more psums (b·b; r·z with r·r) and no SpMV.
    assert collective_counts["ppermute"] == cv.ppermutes_per_spmv
    assert collective_counts["psum"] == cv.psums_per_iter + 2
    assert collective_counts["all_gather"] == 0
    # Byte accounting: both boundary strips of H rows.
    assert cv.bytes_per_spmv == 2 * cv.halo * 8


def test_cg_all_gather_counts_match_trace(ref_data_dir, collective_counts):
    _require(4)
    A = read_matrix(str(ref_data_dir / "xn3b_A_10.txt"))
    b = np.arange(A.nrows, dtype=np.float64)
    cv = cg_comm_volume(A, 4, jnp.float64, strategy="all_gather")
    assert cv.strategy == "all_gather"

    from lsbench_tpu.parallel.dist_cg import DistributedCg
    s = DistributedCg(A, make_row_mesh(4), dtype="float64", rtol=0.0,
                      maxiter=3, strategy="all_gather", local_spmv="ell")
    s.solve(b)
    assert collective_counts["all_gather"] == 1        # one per SpMV
    assert collective_counts["ppermute"] == 0
    assert collective_counts["psum"] == cv.psums_per_iter + 2
    # Inbound complement: everything this device does not own.
    nloc = s.n_pad // 4
    assert cv.bytes_per_spmv == (s.n_pad - nloc) * 8


def test_cg2d_counts_match_trace(collective_counts):
    _require(8)
    A = poisson_2d(16)
    b = np.arange(A.nrows, dtype=np.float64)
    cv = cg2d_comm_volume(A, 2, 4, jnp.float64)

    from lsbench_tpu.parallel.dist2d import DistributedCg2d
    s = DistributedCg2d(A, make_mesh_2d(2, 4), dtype="float64", rtol=0.0,
                        maxiter=3, local_spmv="ell")
    s.solve(b)
    assert collective_counts["all_gather"] == 1        # rows axis
    assert collective_counts["psum_scatter"] == 1      # cols axis
    assert collective_counts["psum"] == cv.psums_per_iter + 2
    assert cv.bytes_per_spmv == (1 + 3) * s.plan.csize * 8


def test_amg_cg_counts_match_trace(collective_counts):
    """V-cycle + AMG-CG schedule (parallel/comm_model.amg_comm_volume)
    vs the collectives DistributedAmgCg actually issues (VERDICT r4
    missing 1: the flagship path's comm accounting)."""
    _require(8)
    from lsbench_tpu.parallel.comm_model import amg_comm_volume
    from lsbench_tpu.parallel.dist_amg import DistributedAmgCg
    A = poisson_2d(64)
    s = DistributedAmgCg(A, make_row_mesh(8), dtype=jnp.float32,
                         rtol=1e-5, comm="auto")
    cv = amg_comm_volume(s)
    # The fine level must ride the ppermute ring, or the accounting test
    # is vacuous (banded poisson + aligned coarse renumbering).
    assert cv.levels[0].a_strategy == "halo"
    assert cv.levels[0].r_strategy == "halo"
    assert cv.levels[0].p_strategy == "halo"

    s.solve(np.arange(A.nrows, dtype=np.float64))
    # Trace = init (1 psum b·b + 1 V-cycle + 1 fused psum) + while body
    # traced once (1 V-cycle + 1 fine matvec + 2 fused psums).
    fine_pp = cv.ppermutes_per_iter - cv.ppermutes_per_cycle
    fine_ag = cv.all_gathers_per_iter - cv.all_gathers_per_cycle
    assert collective_counts["ppermute"] == 2 * cv.ppermutes_per_cycle + fine_pp
    assert collective_counts["all_gather"] == 2 * cv.all_gathers_per_cycle + fine_ag
    assert collective_counts["psum"] == 2 + cv.psums_per_iter
    # Structure: (pre+post)·degree+1 A-applies at each level, 1 coarse
    # gather, and every level's bytes accounted.
    assert cv.levels[0].a_applies == (s.opts.pre_sweeps
                                      + s.opts.post_sweeps) * s.opts.degree + 1
    assert cv.bytes_per_cycle == (sum(l.bytes for l in cv.levels)
                                  + cv.coarse_gather_bytes)
    # The halo schedule must be strictly cheaper than the all_gather one.
    s_ag = DistributedAmgCg(A, make_row_mesh(8), dtype=jnp.float32,
                            rtol=1e-5, comm="all_gather")
    cv_ag = amg_comm_volume(s_ag)
    # all_gather mode: every A-apply, R and P gathers (a_applies+2 per
    # level) + the coarse gather.
    assert cv_ag.all_gathers_per_cycle == (
        (cv_ag.levels[0].a_applies + 2) * len(cv_ag.levels) + 1)
    assert cv.bytes_per_cycle < cv_ag.bytes_per_cycle / 4


def test_amg_kcycle_counts_match_trace(collective_counts):
    """Distributed K-cycle (parAlmond role, paralmond.cpp:118-140 —
    VERDICT r4 missing 5): level visits double per depth and each
    coarse_correct entry adds 2 FCG matvecs + 2 fused psums; the model
    must match the trace exactly."""
    _require(8)
    from lsbench_tpu.parallel.comm_model import amg_comm_volume
    from lsbench_tpu.parallel.dist_amg import DistributedAmg
    A = poisson_2d(64)
    s = DistributedAmg(A, make_row_mesh(8), dtype=jnp.float32, cycles=1,
                       cycle="k", comm="auto")
    cv = amg_comm_volume(s)
    assert cv.psums_per_cycle > 0          # FCG dots exist
    assert s.n_levels >= 3

    s.solve(np.arange(A.nrows, dtype=np.float64))
    # Trace = 1 psum (b·b) + ONE K-cycle + 1 fine matvec residual
    # + 1 psum (r·r).
    fine_pp = cv.ppermutes_per_iter - cv.ppermutes_per_cycle
    fine_ag = cv.all_gathers_per_iter - cv.all_gathers_per_cycle
    assert collective_counts["psum"] == 2 + cv.psums_per_cycle
    assert collective_counts["ppermute"] == cv.ppermutes_per_cycle + fine_pp
    assert collective_counts["all_gather"] == cv.all_gathers_per_cycle + fine_ag
    # Structure: with L coarse-correct levels the coarse grid is hit
    # 2^(nlev-1) times.
    assert cv.all_gathers_per_cycle >= 2 ** (s.n_levels - 2)


def test_amg_cg_ir_counts_match_trace(collective_counts):
    """The production path (DistributedAmgCgIr): inner f32 AMG-CG
    schedule + per-pass f64 residual matvec + psums, from the trace."""
    _require(8)
    from lsbench_tpu.parallel.comm_model import amg_comm_volume
    from lsbench_tpu.parallel.dist_amg import DistributedAmgCgIr
    A = poisson_2d(64)
    s = DistributedAmgCgIr(A, make_row_mesh(8), rtol=1e-10, comm="auto")
    cv = amg_comm_volume(s)
    assert cv.levels[0].a_strategy == "halo"

    r = s.solve(np.arange(A.nrows, dtype=np.float64))
    assert r.extra["true_relres"] <= 1e-10
    # Trace = outer init 1 psum + refine body traced once:
    #   inner init (1 psum + 1 cycle + 1 psum) + inner body
    #   (1 cycle + 1 fine f32 matvec + 2 psums) + 1 f64 fine matvec
    #   (2 ppermutes on the halo path) + 1 outer psum.
    fine_pp = cv.ppermutes_per_iter - cv.ppermutes_per_cycle
    assert fine_pp == 2                       # halo fine level
    assert collective_counts["psum"] == 6
    assert collective_counts["ppermute"] == 2 * cv.ppermutes_per_cycle + fine_pp + 2
    assert collective_counts["all_gather"] == 2 * cv.all_gathers_per_cycle


def test_model_structure(ref_data_dir):
    """Latency-bound at reference size, compute-bound at scale, pinned
    numerically with the H100 NVLink rate from the device table and a
    1 µs hop latency (both supplied by the caller; none is assumed)."""
    from lsbench_tpu.harness.profile import device_peaks
    link = device_peaks("NVIDIA H100 80GB HBM3")["link_gbps"]
    hop = 1e-6
    A = read_matrix(str(ref_data_dir / "xn3b_A_10.txt"))
    cv8 = cg_comm_volume(A, 8, jnp.float32)
    # A 20 µs single-device iteration: psum hops dominate.
    eff_ref, _ = predict_efficiency(20e-6, cv8, link, hop)
    assert eff_ref < 0.25
    # An 800 µs iteration: compute dominates.
    eff_big, _ = predict_efficiency(800e-6, cv8, link, hop)
    assert eff_big > 0.70
    # The gather-hop term must actually bite: an all_gather CV is
    # strictly slower than the same CV with the hops zeroed out.
    from dataclasses import replace
    no_hops, _ = predict_efficiency(800e-6,
                                    replace(cv8, gather_hops_per_spmv=0),
                                    link, hop)
    assert eff_big <= no_hops
    # Efficiency is monotone in t1 and decreasing in latency and in
    # link bandwidth's inverse.
    assert predict_efficiency(100e-6, cv8, link, hop)[0] < eff_big
    assert predict_efficiency(800e-6, cv8, link, 1e-5)[0] < eff_big
    assert predict_efficiency(800e-6, cv8, link / 100, hop)[0] < eff_big

    n80 = efficiency_crossover_n(5.0, 1.58, 8, link_gbps=link,
                                 hop_latency_s=hop)
    assert 10_000 < n80 < 10_000_000


def test_crossover_unreachable_returns_sentinel():
    assert efficiency_crossover_n(5.0, 1.58, 8, target=0.8,
                                  link_gbps=450.0, hop_latency_s=10.0) == -1
