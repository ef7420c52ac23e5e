"""lsbench_tpu — a sparse linear-solver library + benchmark harness in JAX.

Re-creates the capabilities of the reference ``lsbench`` (a C/C++ harness
wrapping cuSolverSp, CHOLMOD, Hypre BoomerAMG, AmgX, parAlmond and Ginkgo)
as native JAX/XLA solvers:

- matrix core: COO text reader with reference-identical semantics
  (lsbench-csr.c:29-92), host CSR, padded (ELL) and CSR device layouts
- kernels: SpMV, fused Krylov reductions
- solvers: CG / BiCGSTAB / GMRES (Krylov), dense+banded+sparse Cholesky
  (direct), algebraic multigrid (AMG) as preconditioner and fixed-cycle
  solver
- distribution: block-row partitioning over a `jax.sharding.Mesh`,
  halo exchange + fused all-reduces (replaces the reference's vestigial
  MPI path, paralmond.cpp:94-102)
- harness: the reference CLI (lsbench.c:84-92) and CSV schema
  (cusparse.c:207-209) plus extended JSON reporting.

FP64 semantics are preserved by enabling x64 at import (the reference
enforces FP64, lsbench.c:140-141); FP32 and mixed-precision iterative
refinement are offered beside it.
"""

import os as _os

import jax as _jax

# FP64 is the reference's enforced precision (lsbench.c:140-141); enable
# before any array is created.
_jax.config.update("jax_enable_x64", True)

CHECKOUT_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives: the directory
    JAX_COMPILATION_CACHE_DIR names, else `<checkout>/.jax_cache` (a
    fixed path, since the path is part of the cache key)."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(CHECKOUT_DIR, ".jax_cache"))


# Every CLI invocation is a fresh process; the persistent cache keeps
# compiled solves across them. JAX reads JAX_COMPILATION_CACHE_DIR
# itself, so code sets the directory only when the variable is unset.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from lsbench_tpu.matrix.csr import CsrMatrix  # noqa: E402
from lsbench_tpu.matrix.io import read_matrix  # noqa: E402
from lsbench_tpu.matrix.ell import EllMatrix  # noqa: E402
from lsbench_tpu.solvers.base import SolveResult, get_solver, list_solvers  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CsrMatrix",
    "EllMatrix",
    "read_matrix",
    "SolveResult",
    "get_solver",
    "list_solvers",
]
