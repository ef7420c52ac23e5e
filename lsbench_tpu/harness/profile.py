"""Observability: jax.profiler tracing + per-kernel roofline reporting.

The reference's only observability is wall-of-clock() timing and device
syncs (SURVEY.md §5); here every SpMV layout knows its streamed bytes, so
the harness can report achieved vs published memory bandwidth per kernel.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp

# Published peaks per device, keyed by the exact `device_kind` JAX
# reports. Source: NVIDIA H100 data sheet, SXM part — 3.35 TB/s HBM3;
# NVLink 900 GB/s to the other cards, 450 GB/s each way.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "link_gbps": 450.0},
}


def device_peaks(kind: str | None = None) -> dict:
    """Peak rates of `kind` (default: the first JAX device). A device
    that is not in the table is an error, never a default."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add them to "
            "lsbench_tpu/harness/profile.py DEVICE_PEAKS") from None


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_op(fn, op, x, chain: int = 100, reps: int = 5) -> float:
    """Steady-state seconds per application of `fn(op, x)`.

    One jitted `fori_loop` applies fn `chain` times, each step scaled by
    a constant so the iterate stays finite; the median of `reps` runs,
    each fenced with `block_until_ready`, is divided by `chain`. `op` is
    a jit argument, so a large operator is never embedded in the
    executable as a constant.
    """
    y0 = jax.jit(fn)(op, x)
    scale = 1.0 / jnp.maximum(jnp.max(jnp.abs(y0)) / jnp.max(jnp.abs(x)),
                              1e-30)

    @jax.jit
    def chained(op, v, c):
        return jax.lax.fori_loop(0, chain, lambda _, u: fn(op, u) * c, v)

    jax.block_until_ready(chained(op, x, scale))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(op, x, scale))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] / chain


def spmv_roofline(op, x, nnz: int, stream_bytes: int, chain: int = 100) -> dict:
    """Measure one SpMV operator against the device's memory roofline.

    Returns dict with seconds, Gnnz/s, achieved GB/s, and utilization of
    peak memory bandwidth (1.0 = speed of light for this layout's
    traffic)."""
    peak = device_peaks()["hbm_gbps"]
    sec = time_op(lambda _, v: op(v), (), x, chain=chain)
    gbps = stream_bytes / sec / 1e9
    return {
        "spmv_s": sec,
        "gnnz_per_s": nnz / sec / 1e9,
        "achieved_gbps": gbps,
        "peak_gbps": peak,
        "hbm_utilization": gbps / peak,
        "stream_bytes": stream_bytes,
    }
