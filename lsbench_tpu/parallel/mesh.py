"""Device-mesh construction.

The reference has no working distributed path (its MPI is split into
self-communicators, paralmond.cpp:94-102, and every backend pins one GPU —
SURVEY.md §2.2). The replacement here: a 1-D `jax.sharding.Mesh` over the
"rows" axis; matrices are block-row partitioned and vectors row-sharded,
with XLA collectives (NCCL on GPUs) standing in for MPI.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"
COLS = "cols"

_DISTRIBUTED_INITIALIZED = False


def init_distributed(coordinator: str, num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Multi-host seam — the `jax.distributed.initialize` path that
    replaces the reference's vestigial MPI (SURVEY.md §2.2).

    `coordinator` is "host:port" of process 0; pass num_processes and
    process_id explicitly, or neither where the cluster environment
    provides them. After this, `jax.devices()` returns the GLOBAL device
    list, so `make_row_mesh`/`make_mesh_2d` build multi-host meshes
    unchanged.

    Returns this process's id. Idempotent per process.
    """
    global _DISTRIBUTED_INITIALIZED
    if not coordinator or ":" not in coordinator:
        raise ValueError(
            f"coordinator must be 'host:port', got '{coordinator}'")
    if (num_processes is None) != (process_id is None):
        raise ValueError("pass both num_processes and process_id, or "
                         "neither (cluster autodetection)")
    if num_processes is not None and not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range [0, {num_processes})")
    if not _DISTRIBUTED_INITIALIZED:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _DISTRIBUTED_INITIALIZED = True
    return jax.process_index()


def make_mesh_2d(pr: int, pc: int, devices=None) -> Mesh:
    """2-D (rows × cols) mesh for block-partitioned SpMV (parallel/dist2d.py)."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < pr * pc:
        raise ValueError(f"requested {pr}x{pc} devices, have {len(devices)}")
    return jax.make_mesh((pr, pc), (ROWS, COLS), devices=devices[: pr * pc])


def make_row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (ROWS,), devices=devices)


def fetch_global(x, n: int) -> "np.ndarray":
    """Host copy of the first n entries of a (possibly row-sharded) global
    array, correct under multi-process execution: with >1 process a global
    array is not fully addressable, so np.asarray would throw — gather it
    across processes first (every process returns the same full array)."""
    import numpy as np

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)[:n]


def row_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (row) dimension; replicate the rest."""
    return NamedSharding(mesh, P(ROWS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
