"""Multi-host seam test: 2 CPU processes, localhost
coordinator, 4 virtual devices each — `init_distributed`
(parallel/mesh.py:21-46, the jax.distributed replacement for the
reference's vestigial MPI, paralmond.cpp:94-102) actually exercised:
DistributedCg runs over an 8-device mesh SPANNING both processes, with
Gloo carrying the cross-process collectives and `fetch_global`
reassembling the solution on every process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import jax
pid, nproc, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])

from lsbench_tpu.parallel.mesh import init_distributed, make_row_mesh
got_pid = init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert got_pid == pid == jax.process_index()
assert jax.process_count() == nproc
ndev = len(jax.devices())

import numpy as np
from lsbench_tpu.matrix.io import read_matrix
from lsbench_tpu.parallel.dist_cg import DistributedCg

A = read_matrix(path)
b = np.arange(A.nrows, dtype=np.float64)
mesh = make_row_mesh()  # all GLOBAL devices, both processes
s = DistributedCg(A, mesh, dtype="float64", rtol=1e-8)
res = s.solve(b)
x = np.asarray(res.x, np.float64)
true_rr = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
print(f"RESULT pid={pid} ndev={ndev} iters={res.iters} "
      f"relres={res.relres:.6e} true={true_rr:.6e} "
      f"xsum={float(x.sum()):.12e}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_cg(tmp_path, ref_data_dir):
    ref = str(ref_data_dir / "xn3b_A_18.txt")
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # The workers stay on the CPU and never claim a GPU.
    env["JAX_PLATFORMS"] = "cpu"
    # Workers run from a tmp script path: sys.path gets the script dir,
    # not the cwd — point it at the repo explicitly.
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port), ref],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        if "connect" in "".join(outs).lower():
            pytest.skip("sandbox forbids localhost sockets")
        raise
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and ("Connection" in out or "socket" in out):
            pytest.skip(f"sandbox forbids localhost sockets: {out[-500:]}")
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, out[-2000:]
        results.append(dict(kv.split("=") for kv in line[0].split()[1:]))

    # The mesh really spanned both processes (8 global devices)...
    assert all(r["ndev"] == "8" for r in results)
    # ...both processes agree on the run and the solution...
    assert results[0]["iters"] == results[1]["iters"]
    assert results[0]["xsum"] == results[1]["xsum"]
    # ...and the solve is correct by the host oracle.
    assert float(results[0]["true"]) <= 1e-7

    # Cross-check against the in-process (single-host) mesh solve.
    from lsbench_tpu.matrix.io import read_matrix
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    A = read_matrix(ref)
    b = np.arange(A.nrows, dtype=np.float64)
    single = DistributedCg(A, make_row_mesh(8), dtype="float64",
                           rtol=1e-8).solve(b)
    assert int(results[0]["iters"]) == single.iters
    ref_sum = float(np.asarray(single.x, np.float64).sum())
    assert abs(float(results[0]["xsum"]) - ref_sum) <= 1e-6 * abs(ref_sum)
