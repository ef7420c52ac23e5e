"""Device table, compile-cache location, and f32 product precision."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lsbench_tpu
from lsbench_tpu.harness.profile import DEVICE_PEAKS, device_peaks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_peaks_h100_from_table():
    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"hbm_gbps": 3350.0, "link_gbps": 450.0}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_unknown_device_is_an_error(kind):
    assert kind not in DEVICE_PEAKS
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(kind)


def test_roofline_refuses_a_device_without_peaks():
    from lsbench_tpu.harness.profile import spmv_roofline
    if jax.devices()[0].device_kind in DEVICE_PEAKS:
        pytest.skip("runs where the device has no table entry")
    with pytest.raises(ValueError, match="no published peaks"):
        spmv_roofline(lambda v: v, jnp.ones(4), 4, 64)


def _cache_dir_in_child(env_value, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax, lsbench_tpu; "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0); "
            "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0); "
            "print(lsbench_tpu.compile_cache_dir()); "
            "print(jax.config.jax_compilation_cache_dir); "
            "jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7.0)).block_until_ready()")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_uses_env_dir_only(tmp_path):
    cache = tmp_path / "jaxcache"
    resolved, config = _cache_dir_in_child(str(cache), tmp_path)
    assert resolved == config == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_defaults_to_checkout(tmp_path):
    resolved, config = _cache_dir_in_child(None, tmp_path)
    assert resolved == config == os.path.join(REPO, ".jax_cache")
    assert lsbench_tpu.CHECKOUT_DIR == REPO


def _f32_matmul_precisions(fn, *args):
    """Precision of every f32 dot_general with a matrix operand in the
    jaxpr of fn(*args), sub-jaxprs (loops, shard_map) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                avs = [v.aval for v in eqn.invars]
                if (all(a.dtype == jnp.float32 for a in avs)
                        and max(a.ndim for a in avs) >= 2):
                    found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _ell32(A):
    from lsbench_tpu.matrix.ell import EllMatrix
    from lsbench_tpu.ops.spmv import spmv_ell
    op = EllMatrix.from_csr(A, dtype=jnp.float32)
    return lambda v: spmv_ell(op, v)


def _case_gmres(A):
    from lsbench_tpu.solvers.gmres import gmres_loop
    mv = _ell32(A)
    b = jnp.ones(A.nrows, jnp.float32)
    return (lambda b: gmres_loop(mv, lambda r: r, b, 1e-5, 3, 8,
                                 jnp.float32)), b


def _case_block_cg_shared(A):
    from lsbench_tpu.solvers.block_cg import block_cg_shared_loop
    mv = _ell32(A)
    mm = jax.vmap(mv, in_axes=1, out_axes=1)
    B = jnp.ones((A.nrows, 3), jnp.float32)
    ih = jnp.ones(A.nrows, jnp.float32)
    return (lambda B: block_cg_shared_loop(mm, ih, B, 1e-5, 5,
                                           jnp.float32)), B


def _case_block_cg_simultaneous(A):
    from lsbench_tpu.solvers.block_cg import block_cg_loop
    mm = jax.vmap(_ell32(A), in_axes=1, out_axes=1)
    B = jnp.ones((A.nrows, 3), jnp.float32)
    return (lambda B: block_cg_loop(mm, lambda R: R, B, 1e-5, 5,
                                    jnp.float32)), B


def _case_block_jacobi(A):
    from lsbench_tpu.solvers.preconditioners import block_jacobi_precond
    state, apply = block_jacobi_precond(A, jnp.float32, block_size=8)
    r = jnp.ones(A.nrows, jnp.float32)
    return (lambda r: apply(state, r)), r


def _dist_case(cls_path, **kw):
    def make(A):
        import importlib
        mod, name = cls_path.rsplit(".", 1)
        cls = getattr(importlib.import_module(mod), name)
        from lsbench_tpu.parallel.mesh import make_row_mesh
        s = cls(A, make_row_mesh(2), **kw)
        fn = s.solve_fn()
        b = np.ones(A.nrows)   # padded on the host before the jitted solve
        return (lambda _: fn(b)), 0.0
    return make


@pytest.mark.parametrize("case", [
    _case_gmres, _case_block_cg_shared, _case_block_cg_simultaneous,
    _case_block_jacobi,
    _dist_case("lsbench_tpu.parallel.dist_gmres.DistributedGmres",
               dtype=jnp.float32, restart=6, maxiter=12),
    _dist_case("lsbench_tpu.parallel.dist_cg_ir.DistributedGmresIr",
               restart=6, maxiter=12),
    _dist_case("lsbench_tpu.parallel.dist_cg.DistributedCg",
               dtype=jnp.float32, precond="block_jacobi", block_size=8,
               maxiter=5),
], ids=["gmres", "block_cg_shared", "block_cg_simultaneous",
        "block_jacobi", "dist_gmres", "dist_gmres_ir", "dist_cg_bjacobi"])
def test_f32_products_pin_highest_precision(case):
    """f32 products that XLA could run in TF32 on the GPU ask for HIGHEST
    precision explicitly, visible in the traced program."""
    from lsbench_tpu.matrix.generate import poisson_2d
    fn, arg = case(poisson_2d(8))
    precs = _f32_matmul_precisions(fn, arg)
    assert precs, "expected f32 matrix products in the traced program"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == hi for q in p) for p in precs), precs


def test_dist_block_spmm_pins_highest_precision():
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.parallel.dist_spmv import build_dist_matvec
    from lsbench_tpu.parallel.mesh import ROWS, make_row_mesh
    A = poisson_2d(8)
    mesh = make_row_mesh(2)
    for strategy in ("halo", "all_gather"):
        dm = build_dist_matvec(A, mesh, jnp.float32, strategy=strategy)

        @partial(shard_map, mesh=mesh,
                 in_specs=(*dm.op_specs, P(ROWS, None)),
                 out_specs=P(ROWS, None))
        def run(*args):
            return dm.matmat(args[:-1], args[-1])

        X = jnp.ones((dm.n_pad, 3), jnp.float32)
        precs = _f32_matmul_precisions(run, *dm.op_args, X)
        assert precs and all(
            all(q == jax.lax.Precision.HIGHEST for q in p) for p in precs)
