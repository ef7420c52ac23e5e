"""AMG-preconditioned CG on the 2-D block partition (SURVEY.md §5's
very-large-matrix axis, completed for the AMG family).

Every hierarchy operator (A_l, P_l, R_l) is a RECTANGULAR 2-D-partitioned
sparse matrix applied with the same all_gather(ROWS) → local ELL →
psum_scatter(COLS) schedule as the fine-level SpMV (parallel/dist2d.py):
a level-l vector lives in P = Pr·Pc row-major chunks of csize_l entries,
P_l maps level-(l+1) chunks to level-l chunks (csize_r=csize_l,
csize_c=csize_{l+1}), R_l the reverse. The smoothers (Jacobi/Chebyshev)
are diagonal — no extra collectives beyond their matvecs — and the
coarsest system is solved redundantly from a replicated dense Cholesky
factor after ONE all_gather over both mesh axes.

Per-application communication: each operator costs O(n_l/Pc) inbound +
O(n_l/Pr) outbound per device (2·n_l/√P on a square mesh) vs the 1-D
path's O(halo) ring (banded) or O(n) all_gather (general). The 2-D
partition therefore wins exactly when the operator is NOT banded enough
for the halo ring and n is large — the regime parallel/comm_model.py's
model quantifies; at reference sizes the 1-D path dominates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.dist2d import build_2d_plan, spmv_2d_local
from lsbench_tpu.parallel.dist_spmv import fused_psum
from lsbench_tpu.parallel.mesh import COLS, ROWS
from lsbench_tpu.solvers.amg import AmgOptions, build_matrix_hierarchy
from lsbench_tpu.solvers.base import SolveResult, Solver


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DistributedAmgCg2d(Solver):
    """AMG-preconditioned CG over a (rows × cols) mesh: one V-cycle per
    iteration as M⁻¹ inside the fused-psum CG of parallel/dist2d.py."""

    name = "dist_amg_cg2d"

    def __init__(self, A: CsrMatrix, mesh: Mesh, dtype=jnp.float64,
                 rtol=1e-8, maxiter=None, theta=None, coarsening="sa",
                 smoother="chebyshev", degree=2, interp="direct",
                 interp_passes=1, interp_omega=1.0, pmax=4,
                 pre_sweeps=1, post_sweeps=1, coarse_n=128, max_levels=12,
                 jacobi_scale=4.0 / 3.0, cheby_lower=0.30,
                 ordering="rcm", **params):
        super().__init__(A, **params)
        if set(mesh.axis_names) != {ROWS, COLS}:
            raise ValueError(f"need a ({ROWS},{COLS}) mesh, "
                             f"got {mesh.axis_names}")
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        pr, pc = mesh.shape[ROWS], mesh.shape[COLS]
        P_ = pr * pc
        self.n = A.nrows

        from lsbench_tpu.ordering import get_ordering
        perm = get_ordering(ordering, A)
        identity = bool(np.all(perm == np.arange(A.nrows)))
        Ap = A if identity else A.permuted(perm)
        self._perm = None if identity else perm
        inv = np.empty_like(perm)
        inv[perm] = np.arange(A.nrows)
        self._invperm = None if identity else inv

        opts = AmgOptions(theta=theta, coarsening=coarsening,
                          smoother=smoother, degree=degree, interp=interp,
                          interp_passes=interp_passes,
                          interp_omega=interp_omega, pmax=pmax,
                          pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                          coarse_n=coarse_n, max_levels=max_levels,
                          jacobi_scale=jacobi_scale, cheby_lower=cheby_lower,
                          reorder_coarse=True)
        self.opts = opts
        mats, Acoarse = build_matrix_hierarchy(
            Ap, opts, breakdown=self.setup_breakdown)
        self.n_levels = len(mats) + 1
        self.rhos = [float(m["rho"]) for m in mats]

        sizes = [m["A"].nrows for m in mats] + [Acoarse.nrows]
        csizes = [_round_up(max(1, -(-s // P_)), 8) for s in sizes]
        pads = [cs * P_ for cs in csizes]
        self.n_pad = pads[0]
        self.pads = pads
        dt = self.dtype
        both = (ROWS, COLS)

        blk4 = NamedSharding(mesh, P(ROWS, COLS, None, None))
        vec1 = NamedSharding(mesh, P(both))
        rep = NamedSharding(mesh, P(None, None))

        def put_plan(plan):
            return (jax.device_put(plan.vals, blk4),
                    jax.device_put(plan.cols, blk4))

        levels_dev, levels_spec = [], []
        for l, m in enumerate(mats):
            a_plan = build_2d_plan(m["A"], pr, pc, dt,
                                   csize_r=csizes[l], csize_c=csizes[l])
            p_plan = build_2d_plan(m["P"], pr, pc, dt,
                                   csize_r=csizes[l], csize_c=csizes[l + 1])
            r_plan = build_2d_plan(m["R"], pr, pc, dt,
                                   csize_r=csizes[l + 1], csize_c=csizes[l])
            dinv = np.zeros(pads[l])
            dinv[: sizes[l]] = m["dinv"]
            av, ac = put_plan(a_plan)
            pv, pcc = put_plan(p_plan)
            rv, rc = put_plan(r_plan)
            lvl = dict(av=av, ac=ac, pv=pv, pc=pcc, rv=rv, rc=rc,
                       dinv=jax.device_put(jnp.asarray(dinv, dtype=dt),
                                           vec1))
            spec4 = P(ROWS, COLS, None, None)
            spec = dict(av=spec4, ac=spec4, pv=spec4, pc=spec4,
                        rv=spec4, rc=spec4, dinv=P(both))
            levels_dev.append(lvl)
            levels_spec.append(spec)

        # Coarsest: replicated dense factor padded with identity rows.
        npL = pads[-1]
        dense = Acoarse.to_dense()
        dense = (dense + dense.T) * 0.5
        Lc = np.eye(npL)
        Lc[: sizes[-1], : sizes[-1]] = np.linalg.cholesky(
            dense + 1e-30 * np.eye(sizes[-1]))
        coarse_L = jax.device_put(jnp.asarray(Lc, dtype=dt), rep)

        rhos, nlev = self.rhos, self.n_levels - 1
        csize_L = csizes[-1]
        rtol_c, maxiter_c = self.rtol, self.maxiter
        import jax.scipy.linalg as jsl

        def mv2d(arr_v, arr_c, x_l):
            return spmv_2d_local(arr_v[0, 0], arr_c[0, 0], x_l)

        def a_matvec(L, x_l):
            return mv2d(L["av"], L["ac"], x_l)

        def jacobi(L, rho, b_l, x_l):
            om = jnp.asarray(opts.jacobi_scale / rho, b_l.dtype)
            for _ in range(opts.degree):
                x_l = x_l + om * L["dinv"] * (b_l - a_matvec(L, x_l))
            return x_l

        def chebyshev(L, rho, b_l, x_l):
            lmax = 1.1 * rho
            lmin = opts.cheby_lower * rho
            theta_ = jnp.asarray((lmax + lmin) / 2.0, b_l.dtype)
            delta = jnp.asarray((lmax - lmin) / 2.0, b_l.dtype)
            sigma = theta_ / delta
            rho_k = 1.0 / sigma
            r = b_l - a_matvec(L, x_l)
            d = (L["dinv"] * r) / theta_
            for _ in range(opts.degree - 1):
                x_l = x_l + d
                r = r - a_matvec(L, d)
                rho_k1 = 1.0 / (2.0 * sigma - rho_k)
                d = ((rho_k1 * rho_k) * d
                     + (2.0 * rho_k1 / delta) * (L["dinv"] * r))
                rho_k = rho_k1
            return x_l + d

        smooth = chebyshev if opts.smoother == "chebyshev" else jacobi

        def coarse_solve(cL, b_l):
            bf = jax.lax.all_gather(b_l, both, tiled=True)   # (npL,)
            y = jsl.solve_triangular(cL, bf, lower=True)
            xf = jsl.solve_triangular(cL, y, lower=True, trans=1)
            c = jax.lax.axis_index(ROWS) * pc + jax.lax.axis_index(COLS)
            return jax.lax.dynamic_slice(xf, (c * csize_L,), (csize_L,))

        def cycle(levels, cL, lvl, b_l, x_l):
            if lvl == nlev:
                return coarse_solve(cL, b_l)
            L = levels[lvl]
            for _ in range(opts.pre_sweeps):
                x_l = smooth(L, rhos[lvl], b_l, x_l)
            r_l = b_l - a_matvec(L, x_l)
            rc_l = mv2d(L["rv"], L["rc"], r_l)
            ec_l = cycle(levels, cL, lvl + 1, rc_l, jnp.zeros_like(rc_l))
            x_l = x_l + mv2d(L["pv"], L["pc"], ec_l)
            for _ in range(opts.post_sweeps):
                x_l = smooth(L, rhos[lvl], b_l, x_l)
            return x_l

        @partial(shard_map, mesh=mesh,
                 in_specs=(levels_spec, P(None, None), P(both)),
                 out_specs=(P(both), P(), P()))
        def _cg(levels, cL, b_l):
            def mv(p_l):
                return a_matvec(levels[0], p_l)

            def precond(r_l):
                return cycle(levels, cL, 0, r_l, jnp.zeros_like(r_l))

            (bb,) = fused_psum(jnp.vdot(b_l, b_l), axis=both)
            tol2 = (rtol_c ** 2) * bb
            x0 = jnp.zeros_like(b_l)
            r0 = b_l
            z0 = precond(r0)
            p0 = z0
            rz0, rr0 = fused_psum(jnp.vdot(r0, z0), jnp.vdot(r0, r0),
                                  axis=both)

            def cond(s):
                *_, rr, it = s
                return jnp.logical_and(it < maxiter_c, rr > tol2)

            def body(s):
                x, r, p, rz, rr, it = s
                Ap_ = mv(p)
                (pAp,) = fused_psum(jnp.vdot(p, Ap_), axis=both)
                alpha = rz / pAp
                x = x + alpha * p
                r = r - alpha * Ap_
                z = precond(r)
                rz_new, rr_new = fused_psum(jnp.vdot(r, z), jnp.vdot(r, r),
                                            axis=both)
                beta = rz_new / rz
                p = z + beta * p
                return (x, r, p, rz_new, rr_new, it + 1)

            x, r, p, rz, rr, it = jax.lax.while_loop(
                cond, body, (x0, r0, p0, rz0, rr0, jnp.int32(0)))
            return x, jnp.sqrt(rr / jnp.where(bb > 0, bb, 1.0)), it

        self._levels_dev = levels_dev
        self._coarse_L = coarse_L
        self._vec_shard = vec1
        self._jit_cg = jax.jit(_cg)
        self._pr, self._pc = pr, pc

    def _pad_b(self, b):
        b = np.asarray(b, dtype=np.float64)
        if self._perm is not None:
            b = b[self._perm]
        bp = jnp.zeros(self.n_pad, dtype=self.dtype).at[: self.n].set(
            jnp.asarray(b, dtype=self.dtype))
        return jax.device_put(bp, self._vec_shard)

    def solve(self, b) -> SolveResult:
        x, relres, iters = self._jit_cg(self._levels_dev, self._coarse_L,
                                        self._pad_b(b))
        relres = float(relres)
        x_host = np.asarray(x)[: self.n]
        if self._invperm is not None:
            x_host = x_host[self._invperm]
        true_rel = self.true_relres(x_host, b)
        return SolveResult(x=x_host, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"levels": self.n_levels,
                                  "mesh": (self._pr, self._pc),
                                  "true_relres": true_rel})

    def solve_fn(self):
        lv, cl, pad = self._levels_dev, self._coarse_L, self._pad_b
        run = self._jit_cg
        return lambda b: run(lv, cl, pad(b))[0]
