"""Benchmark protocol: setup/solve split, warmup, wall-clock timing.

Fixes the reference's measurement defects (SURVEY.md §2.3) while keeping its
shape: the reference times `trials` back-to-back solves after an equal-length
warmup using CPU `clock()` (cusparse.c:181-197, cholmod-impl.h:44-63). Here:

- wall time via `time.perf_counter`, fenced with `jax.block_until_ready`
  (clock() measures CPU time — wrong for device-async work),
- warmup count independent of trials (the reference doubles total work),
- setup (layout/ordering/factorization/AMG hierarchy) timed separately from
  solve (the reference conflates them differently per backend — §3.3),
- the CSV record is always emitted (Hypre's is missing, hypre.c:235;
  parAlmond never reports, paralmond.cpp:118-140).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.solvers.base import Solver


@dataclass
class BenchRecord:
    matrix: str
    n: int
    nnz: int
    trials: int
    solver: str
    ordering: str
    elapsed: float           # wall seconds for `trials` solves (reference CSV field)
    setup_s: float = 0.0
    solve_s: float = 0.0     # per-solve average
    iters: int = 0
    relres: float = float("nan")
    converged: bool = True
    precision: str = "fp64"
    extra: dict = field(default_factory=dict)
    x: object = None         # the reporting solve's solution (not in JSON)

    # Exact reference CSV schema (cusparse.c:207-209; cholmod-impl.h:68-70;
    # ginkgo.cpp:110-112).
    CSV_HEADER = "===matrix,n,nnz,trials,solver,ordering,elapsed==="

    def csv_line(self) -> str:
        return (f"{self.matrix},{self.n},{self.nnz},{self.trials},"
                f"{self.solver},{self.ordering},{self.elapsed:.6e}")

    def to_json(self) -> dict:
        d = {
            "matrix": self.matrix, "n": self.n, "nnz": self.nnz,
            "trials": self.trials, "solver": self.solver,
            "ordering": self.ordering, "elapsed": self.elapsed,
            "setup_s": self.setup_s, "solve_s": self.solve_s,
            "iters": self.iters, "relres": self.relres,
            "converged": self.converged, "precision": self.precision,
            "nnz_per_s": (self.nnz * max(self.iters, 1)
                          * self.extra.get("nrhs", 1)) / self.solve_s
            if self.solve_s > 0 else None,
        }
        d.update(self.extra)
        return d


def run_bench(
    solver: Solver,
    b,
    trials: int,
    warmups: int = 2,
    matrix_name: str = "",
    ordering: str = "none",
    precision: str = "fp64",
    setup_s: float = 0.0,
) -> BenchRecord:
    """Run the timed-trials protocol on an already-set-up solver."""
    fn = solver.solve_fn()

    # First call separately timed: it carries jit compile, so the record
    # can attribute it.
    t0 = time.perf_counter()
    jax.block_until_ready(fn(b))
    first_call_s = time.perf_counter() - t0
    for _ in range(max(warmups - 1, 0)):
        jax.block_until_ready(fn(b))

    t0 = time.perf_counter()
    out = None
    for _ in range(trials):
        out = fn(b)
    # The device runs enqueued programs in order, so fencing the last
    # trial's result fences all of them.
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    # One reporting solve for iteration count / residual (outside timing).
    res = solver.solve(b)
    true_relres = _relative_residual(solver.A, res.x, b)

    # Precision-mode deviations (e.g. fp64 requested but executed as
    # f32 inner solve + f64 refinement) are FIRST-CLASS in the record: the reference enforces FP64 (lsbench.c:140-141), so any
    # substitution must be visible in the `precision` field itself, not
    # only in extra.
    mode = res.extra.get("precision_mode")
    if mode:
        base = mode[: -len("_auto")] if mode.endswith("_auto") else mode
        if base not in precision:
            precision = f"{precision}({mode})"

    return BenchRecord(
        matrix=matrix_name, n=solver.A.nrows, nnz=solver.A.nnz,
        trials=trials, solver=solver.name, ordering=ordering,
        elapsed=elapsed, setup_s=setup_s, solve_s=elapsed / max(trials, 1),
        iters=res.iters, relres=res.relres, converged=res.converged,
        precision=precision, x=res.x,
        extra={"true_relres": true_relres,
               "first_call_s": first_call_s,
               **({"setup_breakdown": solver.setup_breakdown}
                  if getattr(solver, "setup_breakdown", None) else {}),
               **res.extra},
    )


def _relative_residual(A: CsrMatrix, x, b) -> float:
    """Host-side ||b - Ax|| / ||b|| in fp64 — the oracle the reference
    disabled (cholmod-impl.h:47-53). For multi-RHS (2-D) solves this is
    the WORST column's relative residual."""
    xh = np.asarray(x, dtype=np.float64)
    bh = np.asarray(b, dtype=np.float64)
    if xh.ndim == 2:
        return max(_relative_residual(A, xh[:, j], bh[:, j])
                   for j in range(xh.shape[1]))
    bn = float(np.linalg.norm(bh))
    if bn == 0.0:
        return 0.0
    return float(np.linalg.norm(bh - A.matvec(xh))) / bn
