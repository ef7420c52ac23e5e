#!/usr/bin/env python
"""GPU benchmark: SpMV throughput and CG time to solution on one card.

    python bench.py [--ne 256] [--order 2] [--seed 0] [--sweep]

Matrix: sem_2d(ne, order, seed) from lsbench_tpu/matrix/generate.py (a
seeded SEM pressure-Poisson-type SPD matrix; ne=256, order=2 gives
n = 263,169 and ~4.2 M nonzeros), RCM-ordered. Prints ONE JSON line with
the SpMV time of the auto layout in f64 and f32 (a jitted chain of SpMVs
fenced with `block_until_ready`), its bytes/s and share of the card's
published memory bandwidth, and the wall time of a native-f64
Jacobi-CG solve to rtol 1e-10 (the reference's direct-solve tolerance,
cusparse.c:184) with its host fp64 true residual. Fails without a GPU.

`--sweep` instead prints one JSON line per setting of the Triton SpMV
(ops/spmv_triton.py) on the same matrix: slots per loop step, then rows
per program x warps, beside XLA's ELL, each with its compile seconds and
its error against the host fp64 product; then both in f64 on banded
random matrices of n rows and k entries per row (the shapes of AMG's
level operators; `solvers/cg.py::TRITON_MAX_K`); then the compile seconds
of one kernel as k grows, with and without the slot loop. The
persistent compile cache is off for the sweep, so every compile counts.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.harness.profile import device_peaks, time_op
from lsbench_tpu.matrix.generate import sem_2d
from lsbench_tpu.ordering.rcm import rcm_ordering
from lsbench_tpu.solvers.base import get_solver
from lsbench_tpu.solvers.cg import build_matvec, resolve_layout


def sweep(A, x, peak) -> None:
    """Settings of the Triton SpMV on A (see the module docstring)."""
    from lsbench_tpu.matrix.csr import CsrMatrix
    from lsbench_tpu.ops import spmv_triton as st

    jax.config.update("jax_enable_compilation_cache", False)
    y_ref = A.matvec(x)

    def run(tag, fn, op, dtype, **fields):
        xd = jnp.asarray(x, dtype)
        t0 = time.perf_counter()
        jax.jit(fn).lower(op, xd).compile()
        compile_s = time.perf_counter() - t0
        y = np.asarray(jax.jit(fn)(op, xd), np.float64)
        sec = time_op(fn, op, xd, chain=50, reps=5)
        nbytes = (op.bytes_streamed if isinstance(op, st.EllSlotMajor)
                  else op.vals.size * (op.vals.dtype.itemsize + 4))
        row = {"sweep": tag, "dtype": jnp.dtype(dtype).name, **fields,
               "us": sec * 1e6, "gb_per_s": nbytes / sec / 1e9,
               "share_of_peak": nbytes / sec / 1e9 / peak,
               "compile_s": compile_s,
               "rel_err": float(np.linalg.norm(y - y_ref)
                                / np.linalg.norm(y_ref))}
        print(json.dumps(row), flush=True)
        return row

    best = {}
    for dtype in (jnp.float64, jnp.float32):
        apply, op, _ = build_matvec(A, dtype, "ell")
        run("xla_ell", apply, op, dtype)
        op = st.EllSlotMajor.from_csr(A, dtype=dtype)
        rows = [run("unroll", lambda op, v, u=u: st.spmv_ell_triton(
                        op, v, unroll=u), op, dtype, unroll=u,
                    k=int(op.vals_t.shape[0]))
                for u in (1, 2, 4, 8, None)]
        best[dtype] = min(rows, key=lambda r: r["us"])["unroll"]
    for dtype in (jnp.float64, jnp.float32):
        for tile in (128, 256, 512):
            op = st.EllSlotMajor.from_csr(A, dtype=dtype, tile=tile)
            for warps in (4, 8):
                run("tile", lambda op, v, w=warps: st.spmv_ell_triton(
                        op, v, unroll=best[dtype], num_warps=w), op, dtype,
                    unroll=best[dtype], tile=tile, num_warps=warps)

    rng = np.random.default_rng(0)

    def banded(n, k):
        """n rows of k distinct columns within 4k of the diagonal."""
        offs = np.stack([rng.permutation(8 * k)[:k] for _ in range(64)])
        cols = (np.arange(n)[:, None] - 4 * k + offs[np.arange(n) % 64]) % n
        return CsrMatrix.from_coo(np.repeat(np.arange(n), k), cols.ravel(),
                                  rng.standard_normal(n * k), nrows=n,
                                  ncols=n)

    for n in (4096, 65536, 262144):
        for k in (16, 32, 64, 128):
            W = banded(n, k)
            xw = jnp.asarray(rng.standard_normal(n))
            row = {"sweep": "width", "n": n, "k": k}
            for layout in ("ell", "ell_triton"):
                apply, op, _ = build_matvec(W, jnp.float64, layout)
                row[layout + "_us"] = 1e6 * time_op(apply, op, xw, chain=50,
                                                    reps=5)
            print(json.dumps(row), flush=True)

    # Compile time against ELL width (AMG's restriction and coarse
    # operators reach k = 100-900).
    n = 65536
    for k in (32, 128, 256):
        W = banded(n, k)
        op = st.EllSlotMajor.from_csr(W)
        xw = jnp.asarray(rng.standard_normal(n))
        for u in (st.UNROLL, None):
            if u is None and k > 128:
                continue     # minutes of compile: the point is made at 128
            fn = lambda op, v, u=u: st.spmv_ell_triton(op, v, unroll=u)
            t0 = time.perf_counter()
            jax.block_until_ready(jax.jit(fn)(op, xw))
            print(json.dumps({"sweep": "compile_vs_k", "k": k,
                              "k_ell": int(op.vals_t.shape[0]), "unroll": u,
                              "first_call_s": time.perf_counter() - t0}),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ne", type=int, default=256)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    peak = device_peaks()["hbm_gbps"]

    A = sem_2d(args.ne, args.order, seed=args.seed)
    A = A.permuted(rcm_ordering(A))
    x = np.random.default_rng(args.seed).standard_normal(A.ncols)
    if args.sweep:
        sweep(A, x, peak)
        return 0
    spmv = {}
    for dtype in (jnp.float64, jnp.float32):
        layout = resolve_layout("auto", dtype, A)
        apply, op, nbytes = build_matvec(A, dtype, layout)
        sec = time_op(apply, op, jnp.asarray(x, dtype))
        spmv[jnp.dtype(dtype).name] = {
            "layout": layout, "us": sec * 1e6, "layout_bytes": nbytes,
            "gb_per_s": nbytes / sec / 1e9,
            "share_of_peak": nbytes / sec / 1e9 / peak}

    cls, params = get_solver("cg")
    solver = cls(A, **{**params, "rtol": 1e-10})
    fn = solver.solve_fn()
    b = np.arange(A.nrows, dtype=np.float64)
    jax.block_until_ready(fn(b))           # compile + warm
    t0 = time.perf_counter()
    x_sol = jax.block_until_ready(fn(b))
    cg_s = time.perf_counter() - t0
    res = solver.solve(b)
    true_rel = float(np.linalg.norm(b - A.matvec(np.asarray(x_sol)))
                     / np.linalg.norm(b))

    print(json.dumps({
        "matrix": f"sem_2d({args.ne},{args.order},seed={args.seed})+rcm",
        "n": A.nrows, "nnz": A.nnz,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "peak_gb_per_s": peak, "spmv": spmv,
        "cg": {"seconds": cg_s, "iters": res.iters,
               "true_relres": true_rel}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
