"""Solver registry and result types.

The reference declares a backend vtable (`struct backend`,
lsbench-impl.h:36-40) but never uses it — dispatch is a hardcoded switch over
compile-time-enabled backends (lsbench.c:162-184). Here the registry is real
and runtime: solvers self-register by name, `get_solver` resolves them, and
reference backend names are aliases onto native solvers so a reference
user's command lines keep working (see harness/cli.py).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


@dataclass
class SolveResult:
    """One solve's outcome. Mirrors + extends Ginkgo's convergence log —
    the only reference backend reporting iterations/residual
    (ginkgo.cpp:103-108)."""

    x: Any  # device or host vector
    iters: int = 0
    relres: float = float("nan")
    converged: bool = True
    extra: dict = field(default_factory=dict)


class Solver(abc.ABC):
    """A solver instance bound to one matrix.

    Lifecycle mirrors every reference backend's `csr_init` → repeated
    `solve` → `csr_finalize` shape (SURVEY.md §1): `setup` does all
    per-matrix work (layout conversion, ordering, factorization, AMG
    hierarchy) so that `solve` is the timed hot path, jitted end-to-end.
    """

    name: str = "base"

    def __init__(self, A: CsrMatrix, dtype=None, **params):
        self.A = A
        self.params = params
        # Populated by subclasses: wall-seconds per setup phase
        # ("ordering_s", "factor_s", "layout_s", "hierarchy_s", ...) so
        # setup is attributable in the JSON record; compile time shows up
        # as the bench's first_call_s.
        self.setup_breakdown: dict[str, float] = {}

    @abc.abstractmethod
    def solve(self, b: jax.Array) -> SolveResult:
        """Solve A x = b. Must be safe to call repeatedly (bench trials)."""

    # Optional fast path used by the bench loop: a jitted callable
    # `fn(b) -> x` that performs one full solve with no host round trips
    # and returns ONLY the solution array (never the solver's internal
    # (x, iters, ...) tuple — bench.py chains fn output back into b, so
    # the return must be a single array; distributed solvers may return
    # the padded row-sharded solution of length n_pad). Defaults to
    # `solve`.
    def solve_fn(self) -> Callable[[jax.Array], Any]:
        return lambda b: self.solve(b).x

    # Like solve_fn, but the device operands are returned separately:
    # (fn, args) with fn(args, b) -> x. Callers that wrap the solve in an
    # OUTER jit must pass `args` through as jit arguments — a closure
    # would embed them as HLO literal constants, which bloats the
    # executable at scale (a dense n=6.4k f32 inverse is 164 MB).
    def solve_fn_args(self):
        fn = self.solve_fn()
        return (lambda args, b: fn(b)), ()

    def matvec_op(self):
        """(matvec_fn, nnz, stream_bytes) for roofline reporting, or None
        if the solver has no streaming SpMV (e.g. dense direct)."""
        mv = getattr(self, "_mv", None)
        stream = getattr(self, "stream_bytes", None)
        if mv is None or stream is None:
            return None
        return mv, self.A.nnz, stream

    def residual_norm(self, x, b) -> float:
        """Host-side ||b - A x||_2 — the oracle the reference commented out
        (cholmod-impl.h:47-53)."""
        xh = np.asarray(x, dtype=np.float64)
        bh = np.asarray(b, dtype=np.float64)
        return float(np.linalg.norm(bh - self.A.matvec(xh)))

    def true_relres(self, x, b) -> float:
        """Host-side fp64 ||b − A x||/||b|| (columnwise max for multi-RHS).
        Iterative solvers call this at exit so `converged=True` implies the
        TRUE residual meets rtol, not just the recursive one — an f32
        recurrence can report ~30x better than truth."""
        xh = np.asarray(x, dtype=np.float64)
        bh = np.asarray(b, dtype=np.float64)
        if xh.ndim == 1:
            xh, bh = xh[:, None], bh[:, None]
        rel = 0.0
        for j in range(xh.shape[1]):
            bn = float(np.linalg.norm(bh[:, j]))
            if bn == 0.0:
                continue
            rn = float(np.linalg.norm(bh[:, j] - self.A.matvec(xh[:, j])))
            rel = max(rel, rn / bn)
        return rel


_REGISTRY: dict[str, type[Solver]] = {}
_ALIASES: dict[str, tuple[str, dict]] = {}


def register_solver(name: str):
    def deco(cls: type[Solver]):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def register_alias(alias: str, target: str, **default_params):
    """Map a reference backend name to a native solver + parameter preset."""
    _ALIASES[alias] = (target, default_params)


def get_solver(name: str) -> tuple[type[Solver], dict]:
    """Resolve a solver name (case-insensitive) to (class, default_params)."""
    key = name.lower()
    if key in _ALIASES:
        target, params = _ALIASES[key]
        return _REGISTRY[target], dict(params)
    if key in _REGISTRY:
        return _REGISTRY[key], {}
    raise KeyError(f"unknown solver '{name}'. Available: {', '.join(list_solvers())}")


def list_solvers() -> list[str]:
    return sorted(_REGISTRY) + sorted(_ALIASES)
