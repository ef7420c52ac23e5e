from lsbench_tpu.solvers.base import (SolveResult, Solver, get_solver,
                                      list_solvers, register_solver)

# Importing solver modules registers them.
from lsbench_tpu.solvers import cg  # noqa: F401
from lsbench_tpu.solvers import bicgstab  # noqa: F401
from lsbench_tpu.solvers import refine  # noqa: F401
from lsbench_tpu.solvers import direct  # noqa: F401
from lsbench_tpu.solvers import sparse_cholesky  # noqa: F401
from lsbench_tpu.solvers import band_cholesky  # noqa: F401
from lsbench_tpu.solvers import amg  # noqa: F401
from lsbench_tpu.solvers import gmres  # noqa: F401
from lsbench_tpu.solvers import batched_bicgstab  # noqa: F401
from lsbench_tpu.solvers import block_cg  # noqa: F401
from lsbench_tpu.solvers.base import register_alias

# Reference backend names → native solvers with matching protocols
# (lsbench.h:8-16 solver enum; per-backend protocols in BASELINE.md).
# Ginkgo: BiCGSTAB + Jacobi, implicit resnorm ≤ 1e-4 × initial
# (ginkgo.cpp:55-64).
register_alias("ginkgo", "bicgstab", precond="jacobi", rtol=1e-4)
# CHOLMOD: ordering+factorization in setup, timed solve = triangular solves
# (cholmod-impl.h:25-26,44-63).
register_alias("cholmod", "cholesky", refactor_each_solve=False)
# cusolver csrlsvchol: full factor+solve per timed trial (cusparse.c:183-194).
register_alias("cusolver", "cholesky", refactor_each_solve=True)
# Hypre BoomerAMG: classical AMG (PMIS coarsening, hypre.c:127), fixed 2
# V-cycles (maxiter=2 tol=0, hypre.c:129,185-186), Chebyshev-family
# smoother (hypre.c:137). PROTOCOL (cycle counts, fixed-cycle mode) is
# hypre's; cycle INTERNALS are tuned to the measured-best convergence on
# the reference workload rather than hypre's literal knobs (which assume
# M-matrices; tj7a/xn3b are SEM-type with 32% positive off-diagonal
# mass): θ=0.5, direct interpolation improved by 3 damped (ω=0.5) Jacobi
# passes toward the ideal -A_FF⁻¹A_FC truncated to 8/row (per-cycle
# factors 0.15-0.33 on all 7 reference matrices; true
# ext+i is implemented too and loses here), Chebyshev degree 3, V(2,2).
# The hypre-faithful recipe (hypre.c:126-188) is one --opt line away and
# is TESTED as such (tests/test_amg.py::test_hypre_faithful_preset):
#   --opt theta=0.25 --opt interp=ext+i --opt smoother=l1_gs
#   --opt degree=2 --opt interp_passes=1 --opt pmax=4
#   --opt pre_sweeps=1 --opt post_sweeps=1
register_alias("hypre", "amg", cycles=2, coarsening="classical", theta=0.5,
               interp="jacobi", interp_passes=3, interp_omega=0.5, pmax=8,
               degree=3, pre_sweeps=2, post_sweeps=2)
# AmgX: CLASSICAL selector, D2 interpolator, 1 V-cycle (amgx.c:78-86);
# same tuned internals as the hypre alias.
register_alias("amgx", "amg", cycles=1, coarsening="classical", theta=0.5,
               interp="jacobi", interp_passes=3, interp_omega=0.5, pmax=8,
               degree=3, pre_sweeps=2, post_sweeps=2)
# parAlmond: single AMG K-cycle application (paralmond.cpp:118-140; the
# parAlmond library is aggregation K-cycle AMG). Bounded pairwise
# aggregates (Notay AGMG style) + smoothed basis — measured factor 0.69
# vs 0.94 for greedy distance-1 aggregation on xn3b_A_18.
register_alias("paralmond", "amg", cycles=1, cycle="k",
               coarsening="sa_pairwise", degree=3,
               pre_sweeps=2, post_sweeps=2)

__all__ = ["SolveResult", "Solver", "get_solver", "list_solvers",
           "register_solver"]
