"""Scaling harness: nnz/s efficiency across device counts.

The reference has nothing to scale (single device everywhere, SURVEY.md
§2.2). This tool runs the distributed solvers at a sweep of device counts
on whatever mesh is available — real cards, or the CPU-simulated mesh
(--xla_force_host_platform_device_count), which exercises the identical
shard_map/collective code paths (timings on the simulated mesh validate
the path, not link bandwidth).

Protocol: fixed-iteration CG (rtol=0, maxiter=N) so every device count
does identical work; throughput = nnz·iters/elapsed; efficiency(D) =
throughput(D) / (D · throughput(1)) for strong scaling on a fixed matrix.

Usage:
    python -m lsbench_tpu.scale --matrix tests/xn3b_A_10.txt \
        --devices 1,2,4,8 --iters 100 [--mesh2d] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lsbench_tpu.scale", description=__doc__)
    p.add_argument("--matrix", required=True)
    p.add_argument("--devices", default="1,2,4,8",
                   help="comma-separated device counts to sweep")
    p.add_argument("--iters", type=int, default=100,
                   help="fixed CG iterations per measurement")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions (median reported)")
    p.add_argument("--strategy", default="auto",
                   help="1-D exchange strategy: auto | halo | all_gather")
    p.add_argument("--ordering", default="none",
                   help="fill-reducing/banding ordering applied inside the "
                        "solvers (rcm enables the halo strategy on the "
                        "reference matrices)")
    p.add_argument("--mesh2d", action="store_true",
                   help="also sweep 2-D (rows x cols) meshes where D = r*c")
    p.add_argument("--platform", default=None,
                   help="force jax platform (cpu enables the simulated mesh)")
    p.add_argument("--json", action="store_true", help="emit JSON records")
    return p


def _time_solver(solver, b, reps: int) -> float:
    import jax
    fn = solver.solve_fn()
    jax.block_until_ready(fn(b))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(b))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2]


def _mesh2d_shape(d: int) -> tuple[int, int]:
    """Most-square factorization r*c = d with r <= c."""
    r = int(d ** 0.5)
    while d % r:
        r -= 1
    return r, d // r


def run_sweep(A, counts, iters=100, reps=3, strategy="auto",
              ordering="none", mesh2d=False):
    """Device-count sweep of fixed-iteration distributed CG on `A`.
    Returns the list of per-configuration records (the importable core of
    `python -m lsbench_tpu.scale`)."""
    import sys

    import numpy as np

    import jax

    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_mesh_2d, make_row_mesh

    # Validate here, not only in main(): importers would otherwise crash
    # mid-sweep on a mesh-construction error and lose earlier records.
    avail = jax.device_count()
    usable = [d for d in counts if d <= avail]
    for d in counts:
        if d > avail:
            print(f"run_sweep: skipping {d} devices (have {avail})",
                  file=sys.stderr)
    counts = usable

    b = np.arange(A.nrows, dtype=np.float64)
    work = A.nnz * iters
    records = []
    base = None
    for d in counts:
        solver = DistributedCg(A, make_row_mesh(d), rtol=0.0,
                               maxiter=iters, strategy=strategy,
                               ordering=ordering)
        elapsed = _time_solver(solver, b, reps)
        thru = work / elapsed
        if base is None:
            base = thru
        rec = {"mesh": f"{d}x1", "devices": d, "elapsed_s": round(elapsed, 6),
               "nnz_per_s": round(thru, 1),
               "speedup": round(thru / base, 3),
               "efficiency": round(thru / (base * d), 3),
               "strategy": solver.strategy}
        records.append(rec)
        if mesh2d and d >= 4:
            r, c = _mesh2d_shape(d)
            if r > 1:
                from lsbench_tpu.parallel.dist2d import DistributedCg2d
                s2 = DistributedCg2d(A, make_mesh_2d(r, c), rtol=0.0,
                                     maxiter=iters, ordering=ordering)
                e2 = _time_solver(s2, b, reps)
                t2 = work / e2
                records.append({
                    "mesh": f"{r}x{c}", "devices": d,
                    "elapsed_s": round(e2, 6), "nnz_per_s": round(t2, 1),
                    "speedup": round(t2 / base, 3),
                    "efficiency": round(t2 / (base * d), 3),
                    "strategy": "2d"})
    return records


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os
    if args.platform:
        os.environ.setdefault("JAX_PLATFORMS", args.platform)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from lsbench_tpu.matrix.io import read_matrix

    counts = [int(x) for x in args.devices.split(",") if x]
    have = jax.device_count()
    usable = [d for d in counts if d <= have]
    skipped = [d for d in counts if d > have]
    if skipped:
        print(f"# skipping device counts {skipped}: only {have} devices "
              f"({jax.devices()[0].platform})", file=sys.stderr)
    if not usable:
        print("no usable device counts", file=sys.stderr)
        return 1

    A = read_matrix(args.matrix)
    records = run_sweep(A, usable, iters=args.iters, reps=args.reps,
                        strategy=args.strategy, ordering=args.ordering,
                        mesh2d=args.mesh2d)

    hdr = f"{'mesh':>6} {'devices':>7} {'elapsed_s':>10} {'Gnnz/s':>8} " \
          f"{'speedup':>8} {'eff':>6} {'strategy':>10}"
    print(hdr)
    for r in records:
        print(f"{r['mesh']:>6} {r['devices']:>7} {r['elapsed_s']:>10.4f} "
              f"{r['nnz_per_s'] / 1e9:>8.3f} {r['speedup']:>8.2f} "
              f"{r['efficiency']:>6.2f} {r['strategy']:>10}")
    if args.json:
        for r in records:
            print(json.dumps({"matrix": args.matrix, "iters": args.iters,
                              "n": A.nrows, "nnz": A.nnz, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
