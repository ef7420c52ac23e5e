"""Distributed AMG: block-row-sharded V-cycle over a device mesh.

The reference has no working distributed AMG — Hypre is compiled MPI-off
(libs/hypre.cmake:31) and parAlmond asserts a single rank
(paralmond.cpp:39). This is the design here (SURVEY.md §7.6):

- setup on host builds the same hierarchy as the single-chip path
  (solvers/amg.py `build_matrix_hierarchy` — SA or classical coarsening),
  then `align_coarse_levels` (solvers/amg.py, opts.align_coarse)
  anchors every coarse numbering to fine
  positions so ALL level operators stay banded AND orientation-aligned
  with the block-row partition;
- every level's operators (A, P, R) are stored as row-sharded padded-row
  (ELL) blocks over a 1-D mesh; vectors are row-sharded per level;
- EVERY operator application — smoother matvec, restriction R,
  prolongation P — moves O(halo) rows by `ppermute` ring exchange
  (dist_spmv.py `build_halo_plan` / `build_rect_halo_plan`), not the
  O(n) `all_gather` the docstringed v1 design used; a level falls back
  to all_gather only if its reach exceeds one neighbor block. The
  smoother (Jacobi/Chebyshev) needs no dot products, so a whole V-cycle
  costs only these O(halo) exchanges plus one coarse-grid gather — no
  scalar round-trips. `parallel/comm_model.amg_comm_volume` accounts
  the exact schedule, pinned by tests/test_comm_model.py trace counts;
- the coarsest system is solved redundantly on every device from a
  replicated dense Cholesky factor (coarse grids are tiny; redundant
  compute beats a gather/scatter round-trip — standard practice);
- `DistributedAmgCg` wraps the cycle as the preconditioner inside the
  fused-psum CG iteration (one `psum` per iteration for the dots).

Coarse levels are NOT redistributed to fewer devices (each level keeps the
full mesh; padding absorbs the imbalance) — at reference scale the coarse
matvecs are latency-bound either way.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist_spmv import fused_psum
from lsbench_tpu.parallel.mesh import ROWS, fetch_global
from lsbench_tpu.solvers.amg import AmgOptions, build_matrix_hierarchy
from lsbench_tpu.solvers.base import SolveResult, Solver


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_size(n: int, n_dev: int, align: int = 8) -> int:
    return _round_up(max(1, -(-n // n_dev)), align) * n_dev


def _ell_padded(M: CsrMatrix, n_pad: int, dtype):
    """Row-padded ELL arrays (n_pad, k) with global column ids; padding
    rows/slots hold val 0 (col 0)."""
    counts = np.diff(M.offs)
    k = max(int(counts.max(initial=0)), 1)
    vals = np.zeros((n_pad, k))
    cols = np.zeros((n_pad, k), dtype=np.int32)
    rows_idx = M.row_indices()
    slot = np.arange(M.nnz) - M.offs[rows_idx]
    vals[rows_idx, slot] = M.vals
    cols[rows_idx, slot] = M.cols
    return jnp.asarray(vals, dtype=dtype), jnp.asarray(cols)


class _DistAmgBase(Solver):
    """Shared setup: sharded hierarchy + in-shard cycle builder."""

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 theta=None, coarsening="sa", smoother="chebyshev", degree=2,
                 interp="direct", interp_passes=1, interp_omega=1.0, pmax=4,
                 pre_sweeps=1, post_sweeps=1, coarse_n=128, cycle="v",
                 max_levels=12, jacobi_scale=4.0 / 3.0, cheby_lower=0.30,
                 ordering="rcm", comm="auto", local_spmv="auto", **params):
        super().__init__(A, **params)
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.n = A.nrows
        n_dev = mesh.devices.size
        self.n_dev = n_dev

        # A banded fine level (RCM, or a grid ordering) + coarse numbering
        # aligned to it (opts.align_coarse) keeps all operators banded, so
        # the smoother matvecs can use the O(halo) ppermute ring instead
        # of O(n) all_gather (SURVEY.md §7.6). Coarse levels are NOT
        # renumbered before the next coarsening, so the hierarchy is the
        # single-device one for the same ordering.
        from lsbench_tpu.ordering import get_ordering
        perm = get_ordering(ordering, A)
        identity = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if identity else A.permuted(perm)
        self._perm = None if identity else perm
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        self._invperm = None if identity else inv

        self._Ap = Ap  # permuted operator (for f64 residual matvecs)
        opts = AmgOptions(theta=theta, coarsening=coarsening, cycle=cycle,
                          smoother=smoother, degree=degree, interp=interp,
                          interp_passes=interp_passes,
                          interp_omega=interp_omega, pmax=pmax,
                          pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                          coarse_n=coarse_n, max_levels=max_levels,
                          jacobi_scale=jacobi_scale, cheby_lower=cheby_lower,
                          reorder_coarse=False)
        self.opts = opts
        mats, Acoarse = build_matrix_hierarchy(
            Ap, opts, breakdown=self.setup_breakdown)
        self.n_levels = len(mats) + 1
        self.comm = comm

        sizes = [m["A"].nrows for m in mats] + [Acoarse.nrows]
        pads = [_pad_size(s, n_dev) for s in sizes]
        self.n_pad = pads[0]
        self.pads = pads
        self.rhos = [float(m["rho"]) for m in mats]

        row2 = NamedSharding(mesh, P(ROWS, None))
        row1 = NamedSharding(mesh, P(ROWS))
        rep = NamedSharding(mesh, P(None, None))

        def shard2(x):
            return jax.device_put(x, row2)

        from lsbench_tpu.parallel.dist_spmv import check_local_spmv
        check_local_spmv(local_spmv)

        levels_dev = []
        levels_spec = []
        self._halos = []    # per level: A halo width (ppermute ring) or None
        self._p_halos = []  # per level: P (prolongation) halo or None
        self._r_halos = []  # per level: R (restriction) halo or None
        for l, m in enumerate(mats):
            npf, npc = pads[l], pads[l + 1]
            halo = None
            if comm in ("auto", "halo"):
                from lsbench_tpu.parallel.dist_spmv import build_halo_plan
                plan = build_halo_plan(m["A"], n_dev, self.dtype)
                assert plan.n_pad == npf
                if not plan.needs_all_gather:
                    halo = plan.halo
                    av, ac = plan.vals, plan.cols
            if halo is None:
                av, ac = _ell_padded(m["A"], npf, self.dtype)
            self._halos.append(halo)
            lvl = {}
            spec = {}
            # Transfer operators: rectangular halo plans (fine/coarse
            # block sizes differ) — R gathers from the fine vector, P
            # from the coarse one; all_gather only when the reach exceeds
            # a neighbor block (then the level keeps global column ids).
            p_halo = r_halo = None
            if comm in ("auto", "halo"):
                from lsbench_tpu.parallel.dist_spmv import \
                    build_rect_halo_plan
                pp = build_rect_halo_plan(m["P"], n_dev, npf // n_dev,
                                          npc // n_dev, self.dtype)
                if not pp.needs_all_gather:
                    p_halo, pv, pc = pp.halo, pp.vals, pp.cols
                rp = build_rect_halo_plan(m["R"], n_dev, npc // n_dev,
                                          npf // n_dev, self.dtype)
                if not rp.needs_all_gather:
                    r_halo, rv, rc = rp.halo, rp.vals, rp.cols
            if p_halo is None:
                pv, pc = _ell_padded(m["P"], npf, self.dtype)
            if r_halo is None:
                rv, rc = _ell_padded(m["R"], npc, self.dtype)
            self._p_halos.append(p_halo)
            self._r_halos.append(r_halo)
            dinv = np.zeros(npf)
            dinv[: sizes[l]] = m["dinv"]
            lvl.update(av=shard2(av), ac=shard2(ac),
                       pv=shard2(pv), pc=shard2(pc),
                       rv=shard2(rv), rc=shard2(rc),
                       dinv=jax.device_put(
                           jnp.asarray(dinv, dtype=self.dtype), row1))
            spec.update(av=P(ROWS, None), ac=P(ROWS, None),
                        pv=P(ROWS, None), pc=P(ROWS, None),
                        rv=P(ROWS, None), rc=P(ROWS, None),
                        dinv=P(ROWS))
            levels_dev.append(lvl)
            levels_spec.append(spec)
        self.local_spmv = "ell"

        # Coarsest: replicated dense factor padded with identity rows.
        npL = pads[-1]
        dense = Acoarse.to_dense()
        dense = (dense + dense.T) * 0.5
        Lc = np.eye(npL)
        Lc[: sizes[-1], : sizes[-1]] = np.linalg.cholesky(
            dense + 1e-30 * np.eye(sizes[-1]))
        self._coarse_L = jax.device_put(jnp.asarray(Lc, dtype=self.dtype), rep)
        self._levels_dev = levels_dev
        self._levels_spec = levels_spec
        self._vec_shard = row1

    # ---- in-shard building blocks (call only inside shard_map) ----

    def _make_cycle(self):
        opts, rhos = self.opts, self.rhos
        nloc_L = self.pads[-1] // self.n_dev
        nlev = self.n_levels - 1
        halos = self._halos
        p_halos, r_halos = self._p_halos, self._r_halos
        import jax.scipy.linalg as jsl

        from lsbench_tpu.parallel.dist_spmv import halo_spmv_local

        def matvec(vals_l, cols_l, x_l):
            xf = jax.lax.all_gather(x_l, ROWS, tiled=True)
            return jnp.sum(vals_l * xf[cols_l], axis=1)

        def a_matvec(lvl, L, x_l):
            """Level operator: O(halo) ppermute ring when banded; else
            all_gather."""
            if halos[lvl] is not None:
                return halo_spmv_local(halos[lvl], L["av"], L["ac"], x_l)
            return matvec(L["av"], L["ac"], x_l)

        def restrict(lvl, L, r_l):
            if r_halos[lvl] is not None:
                return halo_spmv_local(r_halos[lvl], L["rv"], L["rc"], r_l)
            return matvec(L["rv"], L["rc"], r_l)

        def prolong(lvl, L, ec_l):
            if p_halos[lvl] is not None:
                return halo_spmv_local(p_halos[lvl], L["pv"], L["pc"], ec_l)
            return matvec(L["pv"], L["pc"], ec_l)

        def jacobi(lvl, L, rho, b_l, x_l):
            om = jnp.asarray(opts.jacobi_scale / rho, b_l.dtype)
            for _ in range(opts.degree):
                x_l = x_l + om * L["dinv"] * (b_l - a_matvec(lvl, L, x_l))
            return x_l

        def chebyshev(lvl, L, rho, b_l, x_l):
            lmax = 1.1 * rho
            lmin = opts.cheby_lower * rho
            theta = jnp.asarray((lmax + lmin) / 2.0, b_l.dtype)
            delta = jnp.asarray((lmax - lmin) / 2.0, b_l.dtype)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b_l - a_matvec(lvl, L, x_l)
            d = (L["dinv"] * r) / theta
            for _ in range(opts.degree - 1):
                x_l = x_l + d
                r = r - a_matvec(lvl, L, d)
                rho_k1 = 1.0 / (2.0 * sigma - rho_k)
                d = (rho_k1 * rho_k) * d + (2.0 * rho_k1 / delta) * (L["dinv"] * r)
                rho_k = rho_k1
            return x_l + d

        smooth = chebyshev if opts.smoother == "chebyshev" else jacobi

        def coarse_solve(coarse_L, b_l):
            bf = jax.lax.all_gather(b_l, ROWS, tiled=True)
            y = jsl.solve_triangular(coarse_L, bf, lower=True)
            xf = jsl.solve_triangular(coarse_L, y, lower=True, trans=1)
            i = jax.lax.axis_index(ROWS)
            return jax.lax.dynamic_slice(xf, (i * nloc_L,), (nloc_L,))

        def coarse_correct(levels, coarse_L, lvl, rc_l):
            """Coarse-grid correction: one recursive cycle (V), or two
            FCG steps preconditioned by the cycle (K-cycle, Notay — the
            parAlmond role, paralmond.cpp:118-140, now DISTRIBUTED: the
            FCG inner products become fused psums at every level,
            accounted by comm_model.amg_comm_volume)."""
            if lvl == nlev:
                return coarse_solve(coarse_L, rc_l)
            if opts.cycle == "v":
                return cycle(levels, coarse_L, lvl, rc_l,
                             jnp.zeros_like(rc_l))
            L = levels[lvl]
            eps = jnp.asarray(1e-30, rc_l.dtype)
            u = cycle(levels, coarse_L, lvl, rc_l, jnp.zeros_like(rc_l))
            v = a_matvec(lvl, L, u)
            rho1, alpha1 = fused_psum(jnp.vdot(u, v), jnp.vdot(u, rc_l))
            rho1 = rho1 + eps
            rt = rc_l - (alpha1 / rho1) * v
            w = cycle(levels, coarse_L, lvl, rt, jnp.zeros_like(rt))
            z = a_matvec(lvl, L, w)
            gamma, wz, alpha2 = fused_psum(jnp.vdot(v, w), jnp.vdot(w, z),
                                           jnp.vdot(w, rt))
            rho2 = wz - gamma * gamma / rho1 + eps
            return ((alpha1 / rho1 - gamma * alpha2 / (rho1 * rho2)) * u
                    + (alpha2 / rho2) * w)

        def cycle(levels, coarse_L, lvl, b_l, x_l):
            if lvl == nlev:
                return coarse_solve(coarse_L, b_l)
            L = levels[lvl]
            for _ in range(opts.pre_sweeps):
                x_l = smooth(lvl, L, rhos[lvl], b_l, x_l)
            r_l = b_l - a_matvec(lvl, L, x_l)
            rc_l = restrict(lvl, L, r_l)
            ec_l = coarse_correct(levels, coarse_L, lvl + 1, rc_l)
            x_l = x_l + prolong(lvl, L, ec_l)
            for _ in range(opts.post_sweeps):
                x_l = smooth(lvl, L, rhos[lvl], b_l, x_l)
            return x_l

        def fine_matvec(L, x_l):
            return a_matvec(0, L, x_l)

        return cycle, fine_matvec

    def _pad_b(self, b):
        b = np.asarray(b, dtype=np.float64)
        if self._perm is not None:
            b = b[self._perm]
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(
            jnp.asarray(b, dtype=self.dtype))
        return jax.device_put(bp, self._vec_shard)

    def _unpermute(self, x_host: np.ndarray) -> np.ndarray:
        return x_host if self._invperm is None else x_host[self._invperm]


class DistributedAmg(_DistAmgBase):
    """Standalone distributed AMG: fixed-cycle (hypre maxiter=k protocol)
    or converge-to-rtol mode."""

    name = "dist_amg"

    def __init__(self, A: CsrMatrix, mesh: Mesh, cycles=None, rtol=1e-8,
                 maxiter=100, **kw):
        super().__init__(A, mesh, **kw)
        self.cycles = int(cycles) if cycles is not None else None
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)

        cycle, fine_matvec = self._make_cycle()
        spec = (self._levels_spec, P(None, None), P(ROWS))
        cycles_c, rtol_c, maxiter_c = self.cycles, self.rtol, self.maxiter

        @partial(shard_map, mesh=self.mesh, in_specs=spec,
                 out_specs=(P(ROWS), P(), P(), P()))
        def _run(levels, coarse_L, b_l):
            fine = levels[0]
            bb = jax.lax.psum(jnp.vdot(b_l, b_l), ROWS)
            x_l = jnp.zeros_like(b_l)
            if cycles_c is not None:
                for _ in range(cycles_c):
                    x_l = cycle(levels, coarse_L, 0, b_l, x_l)
                r_l = b_l - fine_matvec(fine, x_l)
                rr = jax.lax.psum(jnp.vdot(r_l, r_l), ROWS)
                return x_l, jnp.sqrt(rr), jnp.sqrt(bb), jnp.int32(cycles_c)
            tol2 = (rtol_c ** 2) * bb

            def cond(s):
                _, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, rr, it = s
                x = cycle(levels, coarse_L, 0, b_l, x)
                r = b_l - fine_matvec(fine, x)
                return (x, jax.lax.psum(jnp.vdot(r, r), ROWS), it + 1)

            x_l, rr, it = jax.lax.while_loop(cond, body, (x_l, bb, jnp.int32(0)))
            return x_l, jnp.sqrt(rr), jnp.sqrt(bb), it

        self._jit_run = jax.jit(_run)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters = self._jit_run(
            self._levels_dev, self._coarse_L, self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = self._unpermute(fetch_global(x, self.n))
        extra = {"levels": self.n_levels, "n_devices": self.n_dev,
                 "local_spmv": self.local_spmv}
        if self.cycles is not None:
            # Fixed-cycle protocol (hypre tol=0): converged = "protocol
            # completed"; the residual is data, not a contract.
            conv = True
        else:
            # Converge mode: judge against the host fp64 TRUE residual —
            # an f32 recurrence can sit ~30x below truth.
            true_rel = self.true_relres(x_host, b)
            extra["true_relres"] = true_rel
            conv = true_rel <= self.rtol
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=conv, extra=extra)

    def solve_fn(self):
        lv, cl, pad = self._levels_dev, self._coarse_L, self._pad_b
        run = self._jit_run
        return lambda b: run(lv, cl, pad(b))[0]


class DistributedAmgCg(_DistAmgBase):
    """AMG-preconditioned CG over the mesh: one fused psum per iteration
    for the dots, one V-cycle per iteration as M⁻¹ (parallel/dist_cg.py's
    iteration with the sharded V-cycle in place of Jacobi)."""

    name = "dist_amg_cg"

    def __init__(self, A: CsrMatrix, mesh: Mesh, rtol=1e-8, maxiter=None,
                 **kw):
        super().__init__(A, mesh, **kw)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))

        cycle, fine_matvec = self._make_cycle()
        spec = (self._levels_spec, P(None, None), P(ROWS))
        rtol_c, maxiter_c = self.rtol, self.maxiter

        @partial(shard_map, mesh=self.mesh, in_specs=spec,
                 out_specs=(P(ROWS), P(), P()))
        def _cg(levels, coarse_L, b_l):
            fine = levels[0]

            def mv(p_l):
                return fine_matvec(fine, p_l)

            def precond(r_l):
                return cycle(levels, coarse_L, 0, r_l, jnp.zeros_like(r_l))


            (bb,) = fused_psum(jnp.vdot(b_l, b_l))
            tol2 = (rtol_c ** 2) * bb
            x0 = jnp.zeros_like(b_l)
            r0 = b_l
            z0 = precond(r0)
            p0 = z0
            rz0, rr0 = fused_psum(jnp.vdot(r0, z0), jnp.vdot(r0, r0))

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, rz, rr, it = s
                Ap = mv(p)
                (pAp,) = fused_psum(jnp.vdot(p, Ap))
                alpha = rz / pAp
                x = x + alpha * p
                r = r - alpha * Ap
                z = precond(r)
                rz_new, rr_new = fused_psum(jnp.vdot(r, z), jnp.vdot(r, r))
                beta = rz_new / rz
                p = z + beta * p
                return (x, r, p, rz_new, rr_new, it + 1)

            x, r, p, rz, rr, it = jax.lax.while_loop(
                cond, body, (x0, r0, p0, rz0, rr0, jnp.int32(0)))
            return x, jnp.sqrt(rr / jnp.where(bb > 0, bb, 1.0)), it

        self._jit_cg = jax.jit(_cg)

    def solve(self, b) -> SolveResult:
        x, relres, iters = self._jit_cg(
            self._levels_dev, self._coarse_L, self._pad_b(b))
        relres = float(relres)
        x_host = self._unpermute(fetch_global(x, self.n))
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"levels": self.n_levels,
                                  "n_devices": self.n_dev,
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel})

    def solve_fn(self):
        lv, cl, pad = self._levels_dev, self._coarse_L, self._pad_b
        run = self._jit_cg
        return lambda b: run(lv, cl, pad(b))[0]


class DistributedAmgCgIr(_DistAmgBase):
    """Mixed-precision distributed AMG-CG: f32 AMG-CG inner solves +
    f64 residual refinement, all in ONE shard_map program.

    The f32 cycle's recursive residual departs the true residual below
    ~1e-6, so an honest 1e-10 distributed AMG solve needs the refinement
    structure of parallel/dist_cg_ir.py: per pass, solve A d ≈ r with
    f32 AMG-CG to `inner_rtol`, then recompute the f64 residual with an
    f64 matvec and one psum.
    """

    name = "dist_amg_cg_ir"

    def __init__(self, A: CsrMatrix, mesh: Mesh, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6, **kw):
        kw["dtype"] = jnp.float32  # the cycle is structurally f32
        super().__init__(A, mesh, **kw)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)

        from lsbench_tpu.parallel.dist_spmv import build_dist_matvec
        dm64 = build_dist_matvec(self._Ap, mesh, jnp.float64)
        assert dm64.n_pad == self.n_pad
        mv64_local = dm64.matvec

        cycle, fine_matvec = self._make_cycle()
        spec = (self._levels_spec, P(None, None), *dm64.op_specs, P(ROWS))
        rtol_c, inner_rtol_c = self.rtol, self.inner_rtol
        maxiter_c, max_refine_c = self.maxiter, self.max_refine
        n64 = len(dm64.op_specs)

        @partial(shard_map, mesh=self.mesh, in_specs=spec,
                 out_specs=(P(ROWS), P(), P(), P(), P()))
        def _solve(levels, coarse_L, *rest):
            op64_l = tuple(rest[:n64])
            b_l = rest[n64]
            fine = levels[0]


            def amg_cg_inner(rhs_l):
                """f32 AMG-preconditioned CG of A d = rhs to inner_rtol."""
                (bb,) = fused_psum(jnp.vdot(rhs_l, rhs_l))
                tol2 = jnp.asarray(inner_rtol_c**2, jnp.float32) * bb
                x0 = jnp.zeros_like(rhs_l)
                z0 = cycle(levels, coarse_L, 0, rhs_l, jnp.zeros_like(rhs_l))
                rz0, rr0 = fused_psum(jnp.vdot(rhs_l, z0),
                                      jnp.vdot(rhs_l, rhs_l))

                def cond(s):
                    *_, rr, it = s
                    return jnp.logical_and(it < maxiter_c, rr > tol2)

                def body(s):
                    x, r, pv, rz, rr, it = s
                    Ap = fine_matvec(fine, pv)
                    (pAp,) = fused_psum(jnp.vdot(pv, Ap))
                    alpha = rz / pAp
                    x = x + alpha * pv
                    r = r - alpha * Ap
                    z = cycle(levels, coarse_L, 0, r, jnp.zeros_like(r))
                    rz_new, rr_new = fused_psum(jnp.vdot(r, z),
                                                jnp.vdot(r, r))
                    beta = rz_new / rz
                    pv = z + beta * pv
                    return (x, r, pv, rz_new, rr_new, it + 1)

                x, r, pv, rz, rr, it = jax.lax.while_loop(
                    cond, body, (x0, rhs_l, z0, rz0, rr0, jnp.int32(0)))
                return x, it

            b_l = b_l.astype(jnp.float64)
            (bb,) = fused_psum(jnp.vdot(b_l, b_l))
            tol2 = (rtol_c**2) * bb

            def refine_cond(s):
                x, r, rr, it_total, passes = s
                return jnp.logical_and(passes < max_refine_c, rr > tol2)

            def refine_body(s):
                x, r, rr, it_total, passes = s
                scale = jnp.sqrt(rr)
                safe = jnp.where(scale > 0, scale, 1.0)
                rhs32 = (r.astype(jnp.float32)
                         * (1.0 / safe).astype(jnp.float32))
                d32, inner_iters = amg_cg_inner(rhs32)
                d32 = jnp.where(jnp.isfinite(d32), d32, 0.0)
                x = x + (d32 * safe.astype(jnp.float32)).astype(jnp.float64)
                r_new = b_l - mv64_local(op64_l, x)
                (rr_new,) = fused_psum(jnp.vdot(r_new, r_new))
                return (x, r_new, rr_new, it_total + inner_iters, passes + 1)

            x0 = jnp.zeros_like(b_l)
            x, r, rr, iters, passes = jax.lax.while_loop(
                refine_cond, refine_body,
                (x0, b_l, bb, jnp.int32(0), jnp.int32(0)))
            return x, jnp.sqrt(rr), jnp.sqrt(bb), iters, passes

        self._op64_args = dm64.op_args
        self._jit_solve = jax.jit(_solve)

    def _pad_b(self, b):
        # The outer refinement carries b and x in f64 (the base pads to
        # the cycle's f32).
        b = np.asarray(b, dtype=np.float64)
        if self._perm is not None:
            b = b[self._perm]
        bp = jnp.zeros(self.n_pad, jnp.float64).at[: self.n].set(
            jnp.asarray(b))
        return jax.device_put(bp, self._vec_shard)

    def solve(self, b) -> SolveResult:
        x, rnorm, bnorm, iters, passes = self._jit_solve(
            self._levels_dev, self._coarse_L, *self._op64_args,
            self._pad_b(b))
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x_host = self._unpermute(fetch_global(x, self.n))
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": int(passes),
                                  "levels": self.n_levels,
                                  "n_devices": self.n_dev,
                                  "local_spmv": self.local_spmv,
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir_auto"})

    def solve_fn(self):
        lv, cl, pad = self._levels_dev, self._coarse_L, self._pad_b
        args64 = self._op64_args
        run = self._jit_solve
        return lambda b: run(lv, cl, *args64, pad(b))[0]
