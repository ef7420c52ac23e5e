#!/usr/bin/env python
"""Chip smoke test: drive the CLI solve path once on one NVIDIA GPU.

    python chip_smoke.py              # one card: phases below, in order
    python chip_smoke.py --devices 4  # only the 4-card path + 1-card twins

One card:
  gpu_tests  `pytest -m gpu` in a child process, before this process
             touches a JAX backend (one JAX process per card at a time)
  device     platform must be "gpu"; compile-cache dir; native libs built
  spmv       every SpMV layout of solvers/cg.py at sem_2d(256, 2) + RCM
             (n = 263,169), f64 and f32, timed and checked against
             scipy's fp64 A @ x
  solves     ten CLI calls (`lsbench_tpu.harness.cli.main`) on the same
             matrix written as a COO text file; host fp64 true residual
             checked against each solver's tolerance
  dense      cusolver / cholmod dense direct solves at sem_2d(40, 2)

Every phase prints one JSON line naming the card (the 4-card path one
per case, as soon as the case is done); any failure raises and
the script exits non-zero. The last line is the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NE, ORDER = 256, 2           # sem_2d(256, 2): n = 263,169, ~4.2 M nnz
DENSE_NE = 40                # sem_2d(40, 2): n = 6,561

# (name, argv, true-residual bound; None = fixed-cycle alias, whose
# residual must only fall below the initial one). CG and GMRES stop on
# their recurrence residual; the host fp64 true residual sits slightly
# above it (1.06e-10 at rtol 1e-10 on this matrix), hence 1.5 x rtol.
# The IR and direct solvers stop on a true f64 residual: bound = rtol.
SOLVES = [
    ("cg", ["--solver", "cg", "--rtol", "1e-10"], 1.5e-10),
    ("cg_amg_classical", ["--solver", "cg", "--precond", "amg_classical",
                          "--rtol", "1e-10"], 1e-10),
    ("hypre", ["--solver", "hypre"], None),
    ("amgx", ["--solver", "amgx"], None),
    ("paralmond", ["--solver", "paralmond"], None),
    ("ginkgo", ["--solver", "ginkgo"], 1e-4),
    ("gmres", ["--solver", "gmres", "--rtol", "1e-10"], 1.5e-10),
    ("cg_fp32_ir", ["--solver", "cg", "--precision", "fp32_ir",
                    "--rtol", "1e-10"], 1e-10),
    ("cg_nrhs8", ["--solver", "cg", "--nrhs", "8", "--rtol", "1e-10"],
     1e-10),
    ("cholmod", [], 1e-10),
]

# 4-card path: each argv runs with --devices 4 and without.
MULTI = [
    ("cg", ["--solver", "cg", "--rtol", "1e-10"], 1.5e-10),
    ("cg_fp32_ir", ["--solver", "cg", "--precision", "fp32_ir",
                    "--rtol", "1e-10"], 1e-10),
    ("hypre", ["--solver", "hypre"], None),
    ("cg_mesh_2x2", ["--solver", "cg", "--rtol", "1e-10"], 1.5e-10),
]


def card_line() -> str:
    """`name, power.limit` of the first card, read by nvidia-smi (a child
    process that never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(card: str, kind: str, phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, "device_kind": kind,
                      **fields}), flush=True)


def run_cli(argv: list[str]) -> dict:
    """One in-process CLI call; returns its JSON record."""
    from lsbench_tpu.harness.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_residual(name: str, rec: dict, bound) -> None:
    rel = rec["true_relres"]
    if not np.isfinite(rel):
        raise AssertionError(f"{name}: true_relres {rel}")
    if bound is None:
        if not rel < 1.0:
            raise AssertionError(f"{name}: residual did not fall ({rel})")
    elif not rel <= bound:
        raise AssertionError(f"{name}: true_relres {rel} > {bound}")


def phase_gpu_tests() -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests")],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-8000:] + proc.stderr[-4000:])
        raise RuntimeError(f"pytest -m gpu exited {proc.returncode}")
    return {"rc": proc.returncode, "summary": tail[0],
            "seconds": time.perf_counter() - t0}


def phase_device() -> dict:
    import jax

    import lsbench_tpu
    from lsbench_tpu.native import NativeUnavailable, load_library

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: first JAX device is {dev.platform}")
    native = {}
    for src in ("reader", "spchol", "mindeg", "spgemm"):
        try:
            load_library(f"{src}.cpp", f"lib{src}.so")
            native[src] = True
        except NativeUnavailable:
            native[src] = False
    return {"platform": dev.platform, "count": len(jax.devices()),
            "compile_cache_dir": lsbench_tpu.compile_cache_dir(),
            "native_built": native}


def phase_spmv(A) -> dict:
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from lsbench_tpu.harness.profile import device_peaks, time_op
    from lsbench_tpu.ordering.rcm import rcm_ordering
    from lsbench_tpu.solvers.cg import LAYOUTS, build_matvec, resolve_layout

    Ap = A.permuted(rcm_ordering(A))
    S = sp.csr_matrix((Ap.vals, Ap.cols, Ap.offs), shape=(Ap.nrows, Ap.ncols))
    x = np.random.default_rng(SEED).standard_normal(Ap.ncols)
    y_ref = S @ x
    peak = device_peaks()["hbm_gbps"]
    rows = []
    for dtype, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        for layout in LAYOUTS:
            apply, op, nbytes = build_matvec(Ap, dtype, layout)
            xd = jnp.asarray(x, dtype=dtype)
            y = np.asarray(jax.jit(apply)(op, xd), dtype=np.float64)
            err = float(np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref))
            if not err <= tol:
                raise AssertionError(
                    f"spmv {layout} {jnp.dtype(dtype).name}: rel err {err}")
            sec = time_op(apply, op, xd, chain=50, reps=5)
            rows.append({"layout": layout, "dtype": jnp.dtype(dtype).name,
                         "us": sec * 1e6, "layout_bytes": nbytes,
                         "gb_per_s": nbytes / sec / 1e9,
                         "share_of_peak": nbytes / sec / 1e9 / peak,
                         "rel_err": err})
            del op, apply
    picks = {}
    for dtype in ("float64", "float32"):
        mine = [r for r in rows if r["dtype"] == dtype]
        fastest = min(mine, key=lambda r: r["us"])
        auto = resolve_layout("auto", jnp.dtype(dtype), Ap)
        t_auto = next(r["us"] for r in mine if r["layout"] == auto)
        # 10% covers run-to-run spread between near-equal candidates.
        picks[dtype] = {"auto": auto, "fastest": fastest["layout"],
                        "auto_ok": t_auto <= 1.1 * fastest["us"]}
    return {"matrix": f"sem_2d({NE},{ORDER},seed={SEED})+rcm",
            "n": Ap.nrows, "nnz": Ap.nnz, "peak_gb_per_s": peak,
            "candidates": rows, "picks": picks}


def phase_solves(path: str, cases, extra: list[str] = ()) -> list[dict]:
    rows = []
    for name, argv, bound in cases:
        rec = run_cli(["--matrix", path, *argv, *extra, "--json",
                       "--trials", "3", "--warmups", "1"])
        check_residual(name, rec, bound)
        rows.append({"case": name, "argv": argv, "iters": rec["iters"],
                     "true_relres": rec["true_relres"],
                     "solve_s": rec["solve_s"], "setup_s": rec["setup_s"],
                     "first_call_s": rec["first_call_s"],
                     "precision": rec["precision"]})
    return rows


def phase_multi(path: str, workdir: str, report) -> None:
    """Each MULTI case on four cards and on one; `report` gets each
    case's row as soon as the case is done."""
    for name, argv, bound in MULTI:
        mesh = ["--mesh", "2x2"] if name == "cg_mesh_2x2" else []
        xs, recs = [], []
        for dev in (["--devices", "4", *mesh], []):
            xfile = os.path.join(workdir, f"{name}{len(dev)}.npy")
            rec = run_cli(["--matrix", path, *argv, *dev, "--json",
                           "--trials", "1", "--warmups", "1",
                           "--save-x", xfile])
            check_residual(name, rec, bound)
            xs.append(np.load(xfile))
            recs.append(rec)
        diff = float(np.linalg.norm(xs[0] - xs[1]) / np.linalg.norm(xs[1]))
        report({"case": name, "argv": argv + mesh, "rel_diff": diff,
                "shard_devices": recs[0].get("shard_devices"),
                "iters": [r["iters"] for r in recs],
                "true_relres": [r["true_relres"] for r in recs],
                "solve_s": [r["solve_s"] for r in recs]})
        if not diff <= 1e-8:
            raise AssertionError(f"{name}: 4-card and 1-card solutions "
                                 f"differ by {diff}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    from lsbench_tpu.matrix.generate import sem_2d
    from lsbench_tpu.matrix.io import write_matrix

    card = card_line()
    if args.devices == 1:
        res = phase_gpu_tests()      # before this process touches a backend
    import jax
    kind = jax.devices()[0].device_kind
    dev = phase_device()
    if args.devices == 1:
        emit(card, kind, "gpu_tests", **res)
    emit(card, kind, "device", **dev)
    if dev["count"] < args.devices:
        raise RuntimeError(f"need {args.devices} GPUs, have {dev['count']}")

    A = sem_2d(NE, ORDER, seed=SEED)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, f"sem2d_{NE}_{ORDER}.txt")
        write_matrix(A, path)
        if args.devices == 4:
            phase_multi(path, work,
                        lambda row: emit(card, kind, "multi", **row))
        else:
            spmv = phase_spmv(A)
            emit(card, kind, "spmv", **spmv)
            for dtype, pick in spmv["picks"].items():
                if not pick["auto_ok"]:
                    raise AssertionError(f"auto layout {pick['auto']} is not "
                                         f"the fastest ({pick['fastest']}) "
                                         f"in {dtype}")
            emit(card, kind, "solves", solves=phase_solves(path, SOLVES))
            small = os.path.join(work, f"sem2d_{DENSE_NE}_{ORDER}.txt")
            write_matrix(sem_2d(DENSE_NE, ORDER, seed=SEED), small)
            emit(card, kind, "dense", solves=phase_solves(
                small, [("cusolver", ["--solver", "cusolver"], 1e-10),
                        ("cholmod", ["--solver", "cholmod"], 1e-10)]))

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform, "kind": kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
