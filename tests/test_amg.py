import numpy as np
import pytest

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.generate import poisson_2d, poisson_3d, random_spd
from lsbench_tpu.ops.spgemm import rap, spgemm
from lsbench_tpu.solvers.base import get_solver

from conftest import make_rhs


def make(name, A, **kw):
    cls, params = get_solver(name)
    params.update(kw)
    return cls(A, **params)


def test_spgemm_matches_dense():
    rng = np.random.default_rng(0)
    a = rng.random((20, 30)); a[a < 0.7] = 0; a[0, 0] = 1
    b = rng.random((30, 25)); b[b < 0.7] = 0; b[0, 0] = 1
    A, B = CsrMatrix.from_dense(a), CsrMatrix.from_dense(b)
    C = spgemm(A, B)
    np.testing.assert_allclose(C.to_dense(), a @ b, atol=1e-13)


def test_rap_matches_dense():
    A = poisson_2d(8)
    rng = np.random.default_rng(1)
    p = rng.random((64, 16)); p[p < 0.6] = 0; p[0, 0] = 1
    P = CsrMatrix.from_dense(p)
    R = P.transpose()
    C = rap(R, A, P)
    np.testing.assert_allclose(C.to_dense(), p.T @ A.to_dense() @ p, atol=1e-12)


def test_amg_converges_poisson():
    # Converge mode: AMG iterated to rtol must beat plain Jacobi badly.
    A = poisson_2d(24)  # n=576
    b = make_rhs(A.nrows)
    s = make("amg", A, rtol=1e-8, maxiter=60, coarse_n=32)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"
    assert res.iters < 40  # AMG should converge in O(10) cycles
    assert res.extra["levels"] >= 2
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(A.to_dense(), b), rtol=1e-5)


def test_amg_fixed_cycles_hypre_protocol():
    # hypre alias: exactly 2 V-cycles, always reports (no FIXME).
    A = poisson_2d(16)
    b = make_rhs(A.nrows)
    cls, params = get_solver("hypre")
    assert params["cycles"] == 2
    res = cls(A, **params).solve(b)
    assert res.iters == 2
    assert res.extra["mode"] == "fixed_2_cycles"
    assert 0 < res.relres < 1.0  # 2 cycles reduce but don't converge


def test_amgx_paralmond_aliases_one_cycle():
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    for name in ("amgx", "paralmond"):
        cls, params = get_solver(name)
        assert params["cycles"] == 1
        res = cls(A, **params).solve(b)
        assert res.iters == 1


def test_amg_preconditioned_cg():
    # AMG-CG should converge in far fewer iterations than Jacobi-CG.
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    r_jac = make("cg", A, rtol=1e-10, precond="jacobi").solve(b)
    r_amg = make("cg", A, rtol=1e-10, precond="amg").solve(b)
    assert r_amg.converged
    assert r_amg.iters < r_jac.iters / 2
    np.testing.assert_allclose(np.asarray(r_amg.x),
                               np.linalg.solve(A.to_dense(), b), rtol=1e-6)


def test_amg_kcycle_converges_no_slower_than_v():
    A = poisson_2d(20)
    b = make_rhs(A.nrows)
    rv = make("amg", A, rtol=1e-8, maxiter=100, cycle="v", coarse_n=16,
              max_levels=2).solve(b)
    rk = make("amg", A, rtol=1e-8, maxiter=100, cycle="k", coarse_n=16,
              max_levels=2).solve(b)
    assert rk.converged
    assert rk.iters <= rv.iters  # K-cycle strengthens truncated hierarchies


def test_paralmond_alias_is_kcycle():
    from lsbench_tpu.solvers.base import get_solver
    _, params = get_solver("paralmond")
    assert params.get("cycle") == "k" and params["cycles"] == 1


def test_amg_3d_and_random():
    for A in [poisson_3d(7), random_spd(300, seed=2)]:
        b = make_rhs(A.nrows)
        res = make("amg", A, rtol=1e-8, maxiter=80, coarse_n=32).solve(b)
        assert res.converged, f"n={A.nrows} relres={res.relres}"


def test_amg_reference_workload(ref_data_dir):
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(ref_data_dir / "xn3b_A_18.txt")
    b = make_rhs(A.nrows)
    res = make("cg", A, rtol=1e-8, precond="amg_classical").solve(b)
    assert res.converged
    assert res.iters < 60  # measured: ~30 CG iterations


# ----------------------------------------------------- classical AMG (PMIS)

def test_classical_strength_and_pmis_poisson():
    from lsbench_tpu.solvers.classical_amg import (
        CPOINT, FPOINT, classical_strength, pmis_splitting,
        promote_uninterpolable)
    A = poisson_2d(16)
    sr, sc, sidx = classical_strength(A, 0.25)
    # 5-point stencil: every off-diagonal -1 is strong at theta 0.25.
    assert sr.size == A.nnz - A.nrows
    state = pmis_splitting(A.nrows, sr, sc)
    state = promote_uninterpolable(state, sr, sc)
    assert set(np.unique(state)) <= {FPOINT, CPOINT}
    # Every F-point with strong connections has a strong C-neighbour.
    has_c = np.zeros(A.nrows, dtype=bool)
    has_c[sr[state[sc] == CPOINT]] = True
    fpts = np.flatnonzero(state == FPOINT)
    assert has_c[fpts].all()
    # Nontrivial coarsening.
    nc = int((state == CPOINT).sum())
    assert 0 < nc < 0.75 * A.nrows


def test_classical_interp_preserves_constants():
    # Direct interpolation must reproduce constants on an M-matrix
    # (zero-row-sum interior rows): P @ 1 == 1 on interior F-points.
    from lsbench_tpu.solvers.classical_amg import classical_coarsen
    A = poisson_2d(16)
    P, nc = classical_coarsen(A, 0.25)
    ones_c = np.ones(nc)
    Pones = P.matvec(ones_c)
    rowsum = A.matvec(np.ones(A.nrows))
    interior = np.abs(rowsum) < 1e-12
    np.testing.assert_allclose(Pones[interior], 1.0, atol=1e-12)


def test_classical_amg_converges():
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", rtol=1e-8, maxiter=60,
             coarse_n=32)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"
    assert res.extra["levels"] >= 2
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(A.to_dense(), b), rtol=1e-5)


def test_hypre_amgx_aliases_are_classical():
    for name in ("hypre", "amgx"):
        _, params = get_solver(name)
        assert params["coarsening"] == "classical"
        # Internals tuned to the reference workload (see solvers/__init__
        # rationale + RESULTS.md); protocol cycle counts stay faithful.
        assert params["theta"] == 0.5
    assert get_solver("hypre")[1]["cycles"] == 2   # hypre.c:129
    assert get_solver("amgx")[1]["cycles"] == 1    # amgx.c:83


def test_jacobi_improved_interp_preserves_constants():
    # One Jacobi pass mixes in neighbour rows, so boundary row-sum deficits
    # reach one hop inward; constants must be exact on distance-2 interior.
    from lsbench_tpu.solvers.classical_amg import classical_coarsen
    A = poisson_2d(16)
    P, nc = classical_coarsen(A, 0.25, interp="jacobi")
    Pones = P.matvec(np.ones(nc))
    rowsum = A.matvec(np.ones(A.nrows))
    interior = np.abs(rowsum) < 1e-12
    r, c, _ = A.to_coo()
    deep = interior.copy()
    np.logical_and.at(deep, r, interior[c])
    np.testing.assert_allclose(Pones[deep], 1.0, atol=1e-10)
    assert deep.sum() > 100  # the check is not vacuous
    # And everywhere, sums stay in (0, 1] up to roundoff.
    assert (Pones > 0).all() and (Pones < 1 + 1e-10).all()


def test_jacobi_interp_beats_direct():
    # The distance-2 (Jacobi-improved) interpolation must give a stronger
    # 2-cycle reduction than plain direct interpolation (the reason Hypre
    # pairs PMIS with ext+i, hypre.c:127-128).
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    rel = {}
    for interp in ("direct", "jacobi"):
        s = make("amg", A, coarsening="classical", cycles=2, interp=interp)
        rel[interp] = s.solve(b).relres
    assert rel["jacobi"] < rel["direct"]


def test_hypre_alias_uses_jacobi_interp():
    _, params = get_solver("hypre")
    assert params["interp"] == "jacobi"


@pytest.mark.parametrize("layout", ["auto", "ell"])
def test_amg_layout_matches_dense_solve(layout):
    # Every level of the hierarchy runs in the chosen SpMV layout;
    # AMG-preconditioned CG must reach the dense solution in each.
    import numpy as np
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.solvers.base import get_solver
    A = poisson_2d(20)
    b = np.arange(A.nrows, dtype=np.float64)
    cls, params = get_solver("cg")
    params.update(rtol=1e-10, precond="amg",
                  precond_params={"layout": layout})
    res = cls(A, **params).solve(b)
    assert res.converged
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


def test_sa_vcycle_convergence_factor():
    # Regression for the prolongator damping: with the classic 4/(3 rho)
    # smoothing the SA V(1,1) factor on the 2-D Laplacian must stay well
    # under the 0.636 the 2/3 damping produced.
    import numpy as np
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.solvers.base import get_solver
    A = poisson_2d(40)
    b = np.arange(A.nrows, dtype=np.float64)
    cls, ps = get_solver("amg")
    ps.update(cycles=8)
    res = cls(A, **ps).solve(b)
    r = np.linalg.norm(b - A.matvec(np.asarray(res.x))) / np.linalg.norm(b)
    assert r ** 0.125 < 0.35, r ** 0.125


def test_ext_i_interp_preserves_constants():
    # Extended+i interpolation must reproduce constants exactly on
    # zero-row-sum (interior) rows: sum_j w_ij = 1 there.
    from lsbench_tpu.solvers.classical_amg import classical_coarsen
    A = poisson_2d(16)
    P, nc = classical_coarsen(A, 0.25, interp="ext+i")
    Pones = P.matvec(np.ones(nc))
    rowsum = A.matvec(np.ones(A.nrows))
    interior = np.abs(rowsum) < 1e-12
    assert interior.any()
    np.testing.assert_allclose(Pones[interior], 1.0, atol=1e-10)


def test_ext_i_amg_converges():
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", theta=0.25, interp="ext+i",
             rtol=1e-8, maxiter=60, coarse_n=32)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"
    # Distance-2 interpolation on a PMIS grid: comfortably multigrid-fast.
    assert res.iters <= 25


def test_ext_i_promotes_less_than_direct():
    # Distance-2-aware promotion keeps more F-points than the distance-1
    # fixup (the point of ext+i on PMIS grids, hypre.c:127-128).
    from lsbench_tpu.solvers.classical_amg import (
        classical_strength, pmis_splitting, promote_uninterpolable,
        promote_uninterpolable_d2, CPOINT)
    A = poisson_2d(24)
    sr, sc, _ = classical_strength(A, 0.25)
    st = pmis_splitting(A.nrows, sr, sc)
    n_c1 = (promote_uninterpolable(st, sr, sc) == CPOINT).sum()
    n_c2 = (promote_uninterpolable_d2(st, sr, sc) == CPOINT).sum()
    assert n_c2 <= n_c1


def test_l1_jacobi_smoother_converges():
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", smoother="l1_jacobi",
             rtol=1e-8, maxiter=80, coarse_n=32)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"


def test_pairwise_aggregation_bounded():
    from lsbench_tpu.solvers.amg import pairwise_aggregate
    A = poisson_2d(20)
    agg, nagg = pairwise_aggregate(A, npass=2)
    sizes = np.bincount(agg, minlength=nagg)
    assert sizes.max() <= 4          # two matchings: pairs of pairs
    assert nagg <= A.nrows // 2      # real coarsening
    assert (sizes > 0).all()


def test_pairwise_amg_converges():
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="sa_pairwise", cycle="k",
             rtol=1e-8, maxiter=60, coarse_n=32)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"


def test_l1_gs_sweep_matches_numpy_block_sgs():
    # One l1_gs sweep must equal the numpy hybrid block-SGS oracle:
    # x += (D+U_b)^-1 D (L_b+D)^-1 (b - A x), blocks of 128 rows, D the
    # l1 diagonal with off-block compensation (hypre relax 8 semantics).
    import scipy.linalg as sla
    from lsbench_tpu.solvers.amg import (AmgOptions, build_hierarchy,
                                         l1_gs_blocks, make_vcycle)
    from lsbench_tpu.solvers.cg import build_matvec
    A = poisson_2d(18)  # n=324 -> 3 blocks of 128
    n = A.nrows
    opts = AmgOptions(smoother="l1_gs", degree=1)
    import jax.numpy as jnp
    dtype = jnp.float64
    lps, aps, _ = build_hierarchy(A, opts, dtype, "ell")
    # jitted single sweep on the finest level via the vcycle internals:
    import jax
    ap, L = aps[0], lps[0]
    b = make_rhs(n)
    x0 = np.linspace(-1.0, 1.0, n)

    # numpy oracle
    Lblk, d_l1 = l1_gs_blocks(A)
    nb, B = Lblk.shape[0], Lblk.shape[1]
    r = b - A.matvec(x0)
    rp = np.zeros(nb * B)
    rp[:n] = r
    dpad = np.ones(nb * B)
    dpad[:n] = d_l1
    z = np.zeros(nb * B)
    for k in range(nb):
        z1 = sla.solve_triangular(Lblk[k], rp[k*B:(k+1)*B], lower=True)
        z[k*B:(k+1)*B] = sla.solve_triangular(
            Lblk[k].T, dpad[k*B:(k+1)*B] * z1, lower=False)
    x_ref = x0 + z[:n]

    # device sweep: rebuild the same math the smoother runs
    blk = L["gs_l"]; dp = L["gs_d"]
    def sweep(x):
        rr = jnp.asarray(b) - ap["a"](L["a"], x)
        rpj = jnp.zeros(nb * B, dtype).at[:n].set(rr).reshape(nb, B, 1)
        z1 = jax.lax.linalg.triangular_solve(blk, rpj, left_side=True,
                                             lower=True)
        w = dp.reshape(nb, B, 1) * z1
        zz = jax.lax.linalg.triangular_solve(blk, w, left_side=True,
                                             lower=True, transpose_a=True)
        return x + zz.reshape(-1)[:n]
    x_dev = np.asarray(jax.jit(sweep)(jnp.asarray(x0, dtype)))
    np.testing.assert_allclose(x_dev, x_ref, rtol=1e-10, atol=1e-12)


def test_l1_gs_vcycle_beats_l1_jacobi():
    # The hybrid SGS smoother should converge at least as fast per cycle
    # as l1-Jacobi on the Laplacian (classically it's notably better).
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    factors = {}
    for sm in ("l1_jacobi", "l1_gs"):
        s = make("amg", A, coarsening="classical", theta=0.25, cycles=6,
                 smoother=sm, coarse_n=32)
        res = s.solve(b)
        r = np.linalg.norm(b - A.matvec(np.asarray(res.x))) / np.linalg.norm(b)
        factors[sm] = r ** (1.0 / 6.0)
    assert factors["l1_gs"] <= factors["l1_jacobi"] * 1.02, factors


def test_l1_gs_amg_converges_reference_matrix(ref_data_dir):
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", theta=0.5, smoother="l1_gs",
             interp="jacobi", rtol=1e-8, maxiter=40)
    res = s.solve(b)
    assert res.converged, f"relres={res.relres} iters={res.iters}"


def test_cg_with_l1_gs_amg_precond():
    # l1_gs inside the AMG preconditioner must stay SPD (P^T M^-1 P) and
    # accelerate CG on the reference-type workload.
    A = poisson_2d(24)
    b = make_rhs(A.nrows)
    s = make("cg", A, rtol=1e-10, precond="amg",
             precond_params=dict(smoother="l1_gs", coarsening="classical",
                                 theta=0.25))
    res = s.solve(b)
    assert res.converged and res.iters < 25, (res.iters, res.relres)


def test_r3_preset_cycle_factor_under_035(ref_data_dir):
    """VERDICT r2 item 3 regression lock: the r3 hypre-alias internals
    (3 damped ideal-interp passes, pmax 8) hold per-cycle factor ≤ 0.35
    on the reference workload (RESULTS.md §1 measures 0.146-0.331 on all
    seven matrices; this pins the cheapest one)."""
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", theta=0.5, interp="jacobi",
             interp_passes=3, interp_omega=0.5, pmax=8, degree=3,
             pre_sweeps=2, post_sweeps=2, rtol=1e-10, maxiter=30)
    res = s.solve(b)
    factor = res.relres ** (1.0 / max(res.iters, 1))
    assert factor <= 0.35, factor


def test_hypre_alias_two_cycle_product(ref_data_dir):
    """The hypre ALIAS (fixed 2 cycles, hypre.c:129,185-186) with the r3
    internals: 2-cycle residual reduction ≤ 0.15 (≈ factor² + margin)."""
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = make_rhs(A.nrows)
    s = make("hypre", A)
    res = s.solve(b)
    assert res.iters == 2
    assert res.relres <= 0.15, res.relres


def test_hypre_faithful_preset(ref_data_dir):
    """The hypre-FAITHFUL knobs (hypre.c:126-188: θ=0.25, ext+i interp,
    relax type 8 = ℓ1-hybrid-SGS, V(1,1)) — reachable exactly as the
    README documents, via solver params (--opt ... on the CLI) — must run
    and contract (the alias's tuned defaults differ; this pins the
    faithful path so the divergence stays an explicit, working choice)."""
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "xn3b_A_18.txt"))
    b = make_rhs(A.nrows)
    s = make("amg", A, cycles=2, coarsening="classical", theta=0.25,
             interp="ext+i", smoother="l1_gs", degree=2,
             interp_passes=1, pmax=4, pre_sweeps=1, post_sweeps=1)
    res = s.solve(b)
    assert res.iters == 2
    assert res.relres < 1.0, res.relres  # contracts under the protocol


def test_paralmond_single_kcycle_contracts_error_tj7a(ref_data_dir):
    """One paralmond K-cycle application (paralmond.cpp:118-140 protocol)
    on the tj7a stand-in (cond ~2.5e4): the A-norm and 2-norm ERRORS
    both contract well below 1 — the cycle is a correct error
    contraction — while the residual 2-norm may transiently grow
    (||Ae|| ≤ λmax·||e||; on the original tj7a it grew ~2.1x) but stays
    bounded. A cycle-scaling regression pushes the error contraction
    toward or over 1 and fails here."""
    from lsbench_tpu.matrix.io import read_matrix
    A = read_matrix(str(ref_data_dir / "tj7a_A_18.txt"))
    b = make_rhs(A.nrows)
    cls, p = get_solver("paralmond")
    res = cls(A, **p).solve(b)
    assert res.iters == 1
    x1 = np.asarray(res.x, np.float64)
    Ad = A.to_dense()
    xs = np.linalg.solve(Ad, b)
    e0, e1 = xs, xs - x1
    anorm = lambda e: float(np.sqrt(e @ (Ad @ e)))
    a_contr = anorm(e1) / anorm(e0)
    e_contr = float(np.linalg.norm(e1) / np.linalg.norm(e0))
    assert res.relres < 4.0, res.relres
    assert a_contr < 0.5, a_contr             # the cycle really contracts
    assert e_contr < 0.5, e_contr


def test_abs_strength_selectable():
    """strength=abs is selectable (documented negative result on the
    reference workload) and produces a working hierarchy."""
    A = poisson_2d(16)
    b = make_rhs(A.nrows)
    s = make("amg", A, coarsening="classical", strength="abs",
             rtol=1e-8, maxiter=60)
    res = s.solve(b)
    assert res.converged


def test_amg_levels_follow_resolve_layout():
    """Every level operator (A, P, R) of the hierarchy is built in the
    layout `resolve_layout` names: on the CPU "auto" is XLA's ELL; a named
    layout reaches every level; a removed layout is refused."""
    from lsbench_tpu.matrix.ell import EllMatrix
    from lsbench_tpu.ops.spmv_triton import EllSlotMajor
    A = poisson_2d(16)
    for layout, kind in (("auto", EllMatrix), ("ell_triton", EllSlotMajor)):
        levels = make("amgx", A, layout=layout, coarse_n=16)._params[0]
        assert len(levels) >= 2
        for L in levels:
            assert all(isinstance(L[m], kind) for m in ("a", "p", "r"))
    with pytest.raises(ValueError, match="unknown SpMV layout"):
        make("amgx", A, layout="bsr")


def test_amg_auto_on_gpu_splits_levels_by_width(monkeypatch):
    """With the GPU's "auto", each level operator takes the Triton kernel
    only if its widest row fits TRITON_MAX_K (the kernel in interpret mode
    here), and the cycle still gives the XLA-ELL hierarchy's answer."""
    import functools

    import lsbench_tpu.ops.spmv_triton as st
    import lsbench_tpu.solvers.cg as cg
    from lsbench_tpu.matrix.ell import EllMatrix
    monkeypatch.setattr(st, "spmv_ell_triton",
                        functools.partial(st.spmv_ell_triton, interpret=True))
    A = poisson_2d(16)
    b = make_rhs(A.nrows)
    x_ell = np.asarray(make("amgx", A, layout="ell", coarse_n=16).solve(b).x)
    monkeypatch.setattr(cg.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cg, "TRITON_MAX_K", 8)
    s = make("amgx", A, coarse_n=16)
    kinds = set()
    for L in s._params[0]:
        for m in ("a", "p", "r"):
            op = L[m]
            if isinstance(op, st.EllSlotMajor):
                assert op.vals_t.shape[0] <= 8
            else:
                assert isinstance(op, EllMatrix) and op.k > 8
            kinds.add(type(op))
    assert kinds == {st.EllSlotMajor, EllMatrix}
    np.testing.assert_allclose(np.asarray(s.solve(b).x), x_ell,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["amgx", "paralmond"])
def test_amg_triton_levels_match_ell(monkeypatch, name):
    """A V-cycle (amgx) and a K-cycle (paralmond) with every level on the
    Triton SpMV (interpret mode here) give the ELL hierarchy's answer."""
    import functools

    import lsbench_tpu.ops.spmv_triton as st
    monkeypatch.setattr(st, "spmv_ell_triton",
                        functools.partial(st.spmv_ell_triton, interpret=True))
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    x_ell = np.asarray(make(name, A, layout="ell", coarse_n=16).solve(b).x)
    x_tri = np.asarray(make(name, A, layout="ell_triton",
                            coarse_n=16).solve(b).x)
    np.testing.assert_allclose(x_tri, x_ell, rtol=1e-10, atol=1e-12)
