"""Driver CLI — the reference command-line surface, natively dispatched.

Flags and defaults mirror `lsbench_init` (lsbench.c:84-135): `--matrix`
(required), `--solver`, `--ordering`, `--precision`, `--verbose`, `--trials`,
`--help`; trials default 100 (lsbench.c:96); unknown solver warns and falls
back to the default (lsbench.c:31-33); unknown ordering warns and defaults to
AMD (lsbench.c:47-49); FP16 is rejected like all non-FP64 precisions in the
reference (lsbench.c:140-141) — FP32 is additionally *accepted* here (with
iterative refinement via `--precision fp32_ir`).

Reference backend names (cusolver, cholmod, hypre, amgx, paralmond, ginkgo)
are aliases onto native solvers with matching protocols — see
solvers/__init__ registration — so reference command lines run unchanged.

RHS convention preserved: r[i] = i (lsbench.c:158-160).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from lsbench_tpu.harness.bench import BenchRecord, run_bench
from lsbench_tpu.matrix.io import MatrixFormatError, read_matrix
from lsbench_tpu.solvers.base import get_solver, list_solvers

ORDERINGS = ("none", "rcm", "amd", "metis")

PRECISION_DTYPES = {
    "fp64": "float64",
    "fp32": "float32",
    "fp32_ir": "mixed",  # f32 inner solve + f64 iterative refinement
}

# The reference defaults to its CHOLMOD backend (CMakeLists.txt:5); the
# native equivalent is the direct Cholesky solver, aliased as "cholmod".
# Until it registers, fall back to CG.
def _default_solver() -> str:
    try:
        get_solver("cholmod")
        return "cholmod"
    except KeyError:
        return "cg"


DEFAULT_SOLVER = None  # resolved lazily in build_parser/_resolve_solver_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lsbench",
        description="Sparse linear-solver benchmark harness (JAX)",
    )
    p.add_argument("--matrix", required=True, help="matrix text file (nnz base header + COO triplets)")
    p.add_argument("--solver", default=None,
                   help=f"one of: {', '.join(list_solvers())}")
    p.add_argument("--ordering", default="none", help="none | rcm | amd | metis")
    p.add_argument("--precision", default="fp64",
                   help="fp64 | fp32 | fp32_ir (fp16 rejected)")
    p.add_argument("--verbose", type=int, nargs="?", const=1, default=0)
    p.add_argument("--trials", type=int, default=100)
    # Extensions beyond the reference surface:
    p.add_argument("--warmups", type=int, default=2, help="untimed warmup solves")
    p.add_argument("--rtol", type=float, default=None, help="override solver residual tolerance")
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--precond", default=None,
                   help="override preconditioner "
                        "(none|jacobi|block_jacobi|amg|amg_classical)")
    p.add_argument("--nrhs", type=int, default=1,
                   help="solve this many right-hand sides at once "
                        "(cg family routes to block_cg; column 0 is the "
                        "reference RHS r[i]=i, extras are seeded random)")
    p.add_argument("--json", action="store_true", help="emit a JSON record after the CSV line")
    p.add_argument("--save-x", default=None, metavar="FILE",
                   help="save the reporting solve's solution to FILE (.npy)")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu | gpu); default: environment")
    p.add_argument("--roofline", action="store_true",
                   help="measure the solver's SpMV against the HBM roofline")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the timed loop into DIR")
    p.add_argument("--cache", action="store_true",
                   help="cache setup artifacts (orderings, factors, AMG "
                        "hierarchies) keyed by matrix hash")
    p.add_argument("--cache-dir", default=None,
                   help="setup-cache directory (default ~/.cache/lsbench_tpu)")
    p.add_argument("--devices", type=int, default=None,
                   help="run the solve block-row-sharded over N devices "
                        "(cg / cg_ir / gmres / bicgstab / ginkgo / amg / "
                        "hypre / amgx / paralmond; every Krylov family "
                        "accepts --precision fp32_ir for f32 inner + f64 "
                        "refinement; --nrhs k composes via "
                        "block_cg). --devices 1 runs the full "
                        "shard_map/halo plumbing on a 1-device "
                        "mesh; omit for the single-device path. Use "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                        "with --platform cpu to simulate)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address "
                        "(process 0); meshes then span all hosts' devices "
                        "(the MPI replacement, SURVEY.md §2.2)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's id")
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="2-D device mesh for --devices runs, e.g. 2x4 "
                        "(cg/bicgstab/ginkgo: all_gather over rows + "
                        "psum_scatter over cols, ELL local "
                        "SpMV, parallel/dist2d.py; --precond amg runs the "
                        "fully 2-D-sharded AMG hierarchy, dist_amg2d.py; "
                        "--nrhs k runs 2-D multi-RHS block CG)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (fail fast on NaN/Inf in any "
                        "kernel — the sanitizer role, SURVEY.md §5)")
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE",
                   help="extra solver parameter (repeatable), e.g. "
                        "--opt theta=0.5 --opt smoother=jacobi; the "
                        "reference hardcodes these (hypre.c:126-137)")
    return p


def _resolve_solver_name(name: str | None) -> str:
    if name is None:
        return _default_solver()
    try:
        get_solver(name)
        return name.lower()
    except KeyError:
        # Reference behavior: warn and default (lsbench.c:31-33).
        default = _default_solver()
        print(f"Invalid solver: \"{name}\". Defaulting to {default}.",
              file=sys.stderr)
        return default


def _resolve_ordering(name: str) -> str:
    if name.lower() in ORDERINGS:
        return name.lower()
    # Reference behavior: warn and default to AMD (lsbench.c:47-49).
    print(f"Invalid ordering: \"{name}\". Defaulting to AMD.", file=sys.stderr)
    return "amd"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    precision = args.precision.lower()
    if precision not in PRECISION_DTYPES:
        # Reference rejects everything but FP64 (lsbench.c:140-141); we
        # additionally implement fp32/fp32_ir.
        print(f"Precision '{args.precision}' is not implemented "
              f"(supported: {', '.join(PRECISION_DTYPES)}).", file=sys.stderr)
        return 1

    solver_name = _resolve_solver_name(args.solver)
    ordering = _resolve_ordering(args.ordering)

    if args.cache or args.cache_dir:
        from lsbench_tpu.harness import cache
        cache.enable(True)
        if args.cache_dir:
            cache.set_cache_dir(args.cache_dir)

    if args.debug_nans:
        import jax
        jax.config.update("jax_debug_nans", True)

    if args.coordinator:
        from lsbench_tpu.parallel.mesh import init_distributed
        try:
            pid = init_distributed(args.coordinator, args.num_processes,
                                   args.process_id)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        if args.verbose >= 1:
            import jax
            print(f"distributed: process {pid}/{jax.process_count()}, "
                  f"{len(jax.devices())} global devices", file=sys.stderr)

    try:
        A = read_matrix(args.matrix)
    except FileNotFoundError:
        # Reference: err(EXIT_FAILURE, "Unable to open file ...") lsbench-csr.c:32
        print(f"Unable to open file \"{args.matrix}\" for reading.", file=sys.stderr)
        return 1
    except MatrixFormatError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.verbose >= 1:
        print(f"matrix {args.matrix}: n={A.nrows} nnz={A.nnz} "
              f"({A.nnz / A.nrows:.1f} nnz/row)", file=sys.stderr)

    # RHS r[i] = i (lsbench.c:158-160).
    b = np.arange(A.nrows, dtype=np.float64)
    if args.nrhs > 1:
        # Multi-RHS extension (no reference analog — lsbench is
        # single-RHS): column 0 keeps the reference convention, extra
        # columns are deterministic pseudo-random.
        rng = np.random.default_rng(0)
        b = np.column_stack(
            [b] + [rng.standard_normal(A.nrows)
                   for _ in range(args.nrhs - 1)])
        # Gate on the RESOLVED solver (aliases like ginkgo→bicgstab must
        # be judged by what they run, not how they are spelled).
        resolved_cls, _ = get_solver(solver_name)
        if resolved_cls.name in ("cg", "cg_ir"):
            solver_name = "block_cg"
            if precision == "fp64" and args.verbose >= 0:
                # block_cg is structurally f32 SpMM + f64 residual
                # refinement; the record's precision field will say so
                # (run_bench reflects extra["precision_mode"]).
                print("nrhs: cg with multiple RHS runs as block_cg "
                      "(f32 SpMM inner + f64 refinement, "
                      "mode fp32_ir).", file=sys.stderr)
        elif resolved_cls.name == "bicgstab":
            # Ginkgo-role multi-RHS (ginkgo.cpp:55-64 with k RHS): k
            # INDEPENDENT BiCGSTAB recurrences batched — per-column
            # scalars, one SpMM per half-step over the same matrix
            # stream (block CG would wrongly share a Krylov space
            # across unrelated RHS).
            solver_name = "batched_bicgstab"
            if args.verbose >= 0:
                print("nrhs: bicgstab/ginkgo with multiple RHS runs as "
                      "batched BiCGSTAB (f32 SpMM inner + "
                      "f64 refinement, mode fp32_ir).", file=sys.stderr)
        elif resolved_cls.name not in ("block_cg", "cholesky",
                                       "cholesky_ir"):
            # GMRES is the documented exception: a batched Arnoldi
            # shares nothing across unrelated RHS (per-column (m+1,n)
            # bases and Hessenberg solves — k separate solves in one
            # program buys no operator amortization because the basis
            # orthogonalization, not the SpMV, dominates its cost).
            print(f"--nrhs > 1 is implemented for the cg family "
                  f"(block_cg), bicgstab/ginkgo (batched BiCGSTAB), and "
                  f"the dense Cholesky family (cholmod/cusolver: "
                  f"X = A⁻¹B as one GEMM per refinement pass); "
                  f"got '{solver_name}' (for gmres run one RHS per "
                  f"solve).", file=sys.stderr)
            return 1

    cls, params = get_solver(solver_name)
    if precision == "fp32_ir":
        # Remap the RESOLVED target (so alias params — e.g. ginkgo's
        # rtol=1e-4/jacobi — survive) onto its iterative-refinement twin.
        ir_map = {"cg": "cg_ir", "cholesky": "cholesky_ir",
                  "gmres": "gmres_ir", "bicgstab": "bicgstab_ir"}
        target = ir_map.get(cls.name, cls.name)
        if target in ("block_cg", "batched_bicgstab"):
            pass  # these ARE their IR form (f32 SpMM + f64 residual)
        elif not target.endswith("_ir"):
            print(f"Precision 'fp32_ir' is only implemented for the cg, "
                  f"cholesky, gmres, and bicgstab solver families "
                  f"(got '{solver_name}').", file=sys.stderr)
            return 1
        ir_cls, _ = get_solver(target)
        cls = ir_cls
        if solver_name in ir_map:
            solver_name = target
        # Mark the precision structure for the distributed dispatcher:
        # a non-cg-family alias (e.g. ginkgo->bicgstab_ir) keeps its
        # spelled name, and without this mark the --devices path would
        # silently build a plain fp64 solver under a record that says
        # fp32_ir (the substitution-visibility rule, harness/bench.py).
        params["dtype"] = "mixed"
    else:
        params["dtype"] = PRECISION_DTYPES[precision]
    params["ordering"] = ordering
    if args.rtol is not None:
        params["rtol"] = args.rtol
    if args.maxiter is not None:
        params["maxiter"] = args.maxiter
    if args.precond is not None:
        params["precond"] = args.precond
    for kv in args.opt:
        if "=" not in kv:
            print(f"--opt expects KEY=VALUE, got '{kv}'", file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        params[k] = _parse_opt_value(v)

    # Force backend initialization OUTSIDE the solver-setup timer and
    # attribute it: it otherwise lands on whichever setup phase touches a
    # device array first, corrupting the setup_breakdown.
    import jax as _jax
    t0 = time.perf_counter()
    _jax.devices()
    backend_init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        if args.devices is not None:
            solver = _make_distributed(solver_name, A, args, params)
            if solver is None:
                return 1
        else:
            solver = cls(A, **_accepted_params(cls, params))
    except ValueError as e:  # a parameter the solver rejects
        print(str(e), file=sys.stderr)
        return 1
    setup_s = time.perf_counter() - t0

    if args.profile_dir:
        from lsbench_tpu.harness.profile import trace
        with trace(args.profile_dir):
            rec = run_bench(solver, b, trials=args.trials, warmups=args.warmups,
                            matrix_name=args.matrix, ordering=ordering,
                            precision=precision, setup_s=setup_s)
    else:
        rec = run_bench(solver, b, trials=args.trials, warmups=args.warmups,
                        matrix_name=args.matrix, ordering=ordering,
                        precision=precision, setup_s=setup_s)
    # Report under the reference's original solver name for comparability.
    rec.solver = solver_name
    rec.extra["backend_init_s"] = backend_init_s

    if args.roofline:
        op = solver.matvec_op()
        if op is None:
            print("roofline: solver has no streaming SpMV", file=sys.stderr)
        else:
            import jax.numpy as jnp
            from lsbench_tpu.harness.profile import spmv_roofline
            mv, nnz, stream = op
            x0 = jnp.asarray(np.random.default_rng(0).random(solver.A.ncols))
            rec.extra["roofline"] = spmv_roofline(mv, x0, nnz, stream)

    if args.save_x:
        np.save(args.save_x, np.asarray(rec.x, dtype=np.float64))
    if args.devices is not None:
        # Row shard i lives on mesh device i.
        mesh = getattr(solver, "mesh", None)
        if mesh is not None:
            rec.extra["shard_devices"] = [
                f"{d.platform}:{d.id}" for d in mesh.devices.flat]

    print(BenchRecord.CSV_HEADER)
    print(rec.csv_line())
    if args.json or args.verbose >= 1:
        print(json.dumps(rec.to_json()))
    return 0


def _parse_opt_value(v: str):
    """KEY=VALUE values: int, float, bool, or string."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _make_distributed(solver_name: str, A, args, params):
    """Map a solver name onto its block-row-sharded implementation."""
    from lsbench_tpu.parallel.mesh import make_row_mesh
    try:
        mesh = make_row_mesh(args.devices)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return None

    kw = {}
    if args.rtol is not None:
        kw["rtol"] = args.rtol
    if args.maxiter is not None:
        kw["maxiter"] = args.maxiter
    dtype = params.get("dtype", "float64")
    mixed = dtype == "mixed"

    if args.mesh:
        if solver_name not in ("cg", "cg_ir", "bicgstab", "bicgstab_ir",
                               "ginkgo", "gmres", "gmres_ir", "block_cg"):
            print("--mesh RxC supports cg/gmres/bicgstab/ginkgo "
                  "(point/none or amg preconditioning) and multi-RHS "
                  "block_cg.", file=sys.stderr)
            return None
        from lsbench_tpu.parallel.dist2d import (DistributedBicgstab2d,
                                                 DistributedBlockCg2d,
                                                 DistributedCg2d)
        from lsbench_tpu.parallel.mesh import make_mesh_2d
        try:
            pr, pc = (int(t) for t in args.mesh.lower().split("x"))
        except ValueError:
            print(f"--mesh expects RxC (e.g. 2x4), got '{args.mesh}'",
                  file=sys.stderr)
            return None
        if pr * pc != args.devices:
            print(f"--mesh {args.mesh} needs {pr*pc} devices but "
                  f"--devices={args.devices}", file=sys.stderr)
            return None
        mesh2 = make_mesh_2d(pr, pc)
        if "local_spmv" in params:
            kw["local_spmv"] = params["local_spmv"]
        kw["ordering"] = params.get("ordering", "none")
        if solver_name == "block_cg":
            # --nrhs k × --mesh RxC composition (f32 SpMM + f64 refine).
            kw.setdefault("rtol", 1e-10)
            return DistributedBlockCg2d(A, mesh2, nrhs=max(args.nrhs, 1),
                                        **kw)
        if (solver_name in ("cg", "cg_ir")
                and args.precond in ("amg", "amg_classical")):
            # AMG-preconditioned CG on the 2-D partition: every hierarchy
            # operator (A/P/R per level) 2-D-sharded (dist_amg2d.py).
            from lsbench_tpu.parallel.dist_amg2d import DistributedAmgCg2d
            kw.pop("local_spmv", None)  # hierarchy is ELL-on-2-D only
            if args.precond == "amg_classical":
                kw.update(coarsening="classical", theta=0.5,
                          interp="jacobi", interp_passes=3,
                          interp_omega=0.5, pmax=8)
            for k in ("coarsening", "theta", "interp", "interp_passes",
                      "interp_omega", "pmax", "smoother", "degree",
                      "pre_sweeps", "post_sweeps", "coarse_n"):
                if k in params:
                    kw[k] = params[k]
            return DistributedAmgCg2d(A, mesh2, dtype=dtype, **kw)
        if mixed or solver_name.endswith("_ir"):
            # fp64 semantics on the 2-D partition at f32 iteration cost:
            # f32 inner Krylov + f64 per-pass residual.
            from lsbench_tpu.parallel.dist_cg_ir import (
                DistributedBicgstabIr2d, DistributedCgIr2d,
                DistributedGmresIr2d)
            if solver_name in ("bicgstab", "bicgstab_ir", "ginkgo"):
                kw.setdefault("rtol",
                              1e-4 if solver_name == "ginkgo" else 1e-10)
                return DistributedBicgstabIr2d(A, mesh2, **kw)
            kw.setdefault("rtol", 1e-10)
            if solver_name in ("gmres", "gmres_ir"):
                if "restart" in params:
                    kw["restart"] = params["restart"]
                return DistributedGmresIr2d(A, mesh2, **kw)
            return DistributedCgIr2d(A, mesh2, **kw)
        if solver_name in ("gmres", "gmres_ir"):
            print("--mesh RxC gmres runs as fp32_ir (the f64 Arnoldi has "
                  "no 2-D path; use --precision fp32_ir).", file=sys.stderr)
            return None
        if solver_name in ("bicgstab", "ginkgo"):
            if solver_name == "ginkgo":
                kw.setdefault("rtol", 1e-4)  # ginkgo.cpp:61
            return DistributedBicgstab2d(A, mesh2, dtype=dtype, **kw)
        return DistributedCg2d(A, mesh2, dtype=dtype, **kw)

    amg_like = {"amg", "hypre", "amgx", "paralmond"}
    if solver_name in amg_like:
        from lsbench_tpu.parallel.dist_amg import DistributedAmg
        # Full alias preset pass-through so `--solver hypre --devices N`
        # builds the SAME hierarchy as the single-chip alias — including
        # "cycle": the K-cycle's FCG recursion distributes with fused
        # psums at every level (dist_amg.py coarse_correct, round 5 —
        # `--solver paralmond --devices N` now runs its own protocol).
        for k in ("cycles", "cycle", "coarsening", "theta", "interp",
                  "interp_passes", "interp_omega", "pmax", "smoother",
                  "degree", "pre_sweeps", "post_sweeps"):
            if k in params:
                kw[k] = params[k]
        # The same ordering as the single-device solver, so both build
        # the same hierarchy.
        kw["ordering"] = params.get("ordering", "none")
        return DistributedAmg(A, mesh, dtype=dtype, **kw)
    if solver_name in ("cg", "cg_ir") and args.precond in ("amg",
                                                           "amg_classical"):
        from lsbench_tpu.parallel.dist_amg import (DistributedAmgCg,
                                                   DistributedAmgCgIr)
        if args.precond == "amg_classical":
            kw.update(coarsening="classical", theta=0.5, interp="jacobi",
                      interp_passes=3, interp_omega=0.5, pmax=8)
        if solver_name == "cg_ir" or mixed:
            # f32 AMG-CG inner + f64 refinement: the honest 1e-10 AMG
            # route over a mesh (f32 cycles floor at true ~3e-5).
            kw.setdefault("rtol", 1e-10)
            return DistributedAmgCgIr(A, mesh, **kw)
        return DistributedAmgCg(A, mesh, dtype=dtype, **kw)
    kw["ordering"] = params.get("ordering", "none")
    # Distributed --opt knobs (the AMG branch already forwards its own).
    for k in ("local_spmv", "strategy", "inner_rtol", "max_refine",
              "row_align", "precond", "block_size", "restart"):
        if k in params:
            kw[k] = params[k]
    if solver_name in ("bicgstab", "ginkgo", "bicgstab_ir"):
        if solver_name == "ginkgo":
            kw.setdefault("rtol", 1e-4)  # ginkgo.cpp:61
        if mixed or solver_name == "bicgstab_ir":
            # f32 inner distributed BiCGSTAB + f64 refinement: the
            # ginkgo role over a mesh with honest fp64 semantics
            # (ginkgo.cpp:55-64 + lsbench.c:140-141).
            from lsbench_tpu.parallel.dist_cg_ir import DistributedBicgstabIr
            return DistributedBicgstabIr(A, mesh, **kw)
        from lsbench_tpu.parallel.dist_bicgstab import DistributedBicgstab
        return DistributedBicgstab(A, mesh, dtype=dtype, **kw)
    if solver_name == "cg_ir" or (solver_name == "cg" and mixed):
        # f32 inner distributed CG + f64 refinement — the
        # production fp64 mode over a mesh (parallel/dist_cg_ir.py).
        from lsbench_tpu.parallel.dist_cg_ir import DistributedCgIr
        kw.setdefault("rtol", 1e-10)
        return DistributedCgIr(A, mesh, **kw)
    if solver_name == "cg":
        from lsbench_tpu.parallel.dist_cg import DistributedCg
        return DistributedCg(A, mesh, dtype=dtype, **kw)
    if solver_name in ("gmres", "gmres_ir"):
        if mixed or solver_name == "gmres_ir":
            from lsbench_tpu.parallel.dist_cg_ir import DistributedGmresIr
            kw.setdefault("rtol", 1e-10)
            return DistributedGmresIr(A, mesh, **kw)
        from lsbench_tpu.parallel.dist_gmres import DistributedGmres
        return DistributedGmres(A, mesh, dtype=dtype, **kw)
    if solver_name == "block_cg":
        # --nrhs k --devices N composing: the k RHS ride the same halo
        # exchange + matrix pass (parallel/dist_block_cg.py).
        from lsbench_tpu.parallel.dist_block_cg import DistributedBlockCg
        kw.setdefault("rtol", 1e-10)
        return DistributedBlockCg(A, mesh, nrhs=max(args.nrhs, 1), **kw)
    print(f"solver '{solver_name}' has no distributed implementation "
          "(distributed: cg, cg_ir, block_cg, gmres, gmres_ir, bicgstab, "
          "bicgstab_ir, ginkgo, amg, hypre, amgx, paralmond; all Krylov "
          "families accept --precision fp32_ir).",
          file=sys.stderr)
    return None


def _accepted_params(cls, params: dict) -> dict:
    """Drop params the solver doesn't accept (e.g. rtol for direct)."""
    import inspect
    sig = inspect.signature(cls.__init__)
    has_kwargs = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    if has_kwargs:
        return params
    return {k: v for k, v in params.items() if k in sig.parameters}


if __name__ == "__main__":
    sys.exit(main())
