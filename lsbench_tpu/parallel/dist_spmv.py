"""Halo-exchange distributed SpMV over a block-row partition.

The reference has no working distributed path (SURVEY.md §2.2); this is the
design here: each device owns a contiguous block of rows, and for a
banded matrix (e.g. after RCM, ordering/rcm.py) the off-block columns its
rows touch lie within a halo of width H of its block boundaries. Per SpMV:

- two `ppermute`s move the H boundary entries of x to the left/right
  neighbors (the neighbor-exchange pattern of ring attention),
- the local (nloc + 2H)-wide extended vector feeds a purely local padded-row
  SpMV whose column ids were remapped to extended coordinates at setup.

This moves O(H) per device instead of all_gather's O(n), and the exchange
overlaps with the local gather under XLA's scheduler. Matrices whose
couplings exceed one neighbor block (H > nloc) report `needs_all_gather`,
and callers fall back to the all_gather strategy.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.parallel.mesh import ROWS


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class HaloSpmvPlan:
    """Host-built plan: sharded ELL arrays with halo-local column ids."""
    vals: jax.Array        # (n_pad, k) row-sharded
    cols: jax.Array        # (n_pad, k) int32, ids into the extended vector
    n: int                 # true rows
    n_pad: int             # D * nloc
    nloc: int
    halo: int              # H
    n_devices: int
    needs_all_gather: bool

    def tree_flatten(self):  # not a pytree; plan holds static metadata
        raise NotImplementedError


def build_halo_plan(A: CsrMatrix, n_devices: int, dtype,
                    row_align: int = 8) -> HaloSpmvPlan:
    n = A.nrows
    nloc = _round_up(-(-n // n_devices), row_align)
    n_pad = nloc * n_devices

    r, c, v = A.to_coo()
    dev = r // nloc
    # Column offset of each nnz relative to its device's block start.
    off = c - dev * nloc
    # Halo width: how far columns reach outside [0, nloc).
    reach_left = int(np.maximum(0, -off).max(initial=0))
    reach_right = int(np.maximum(0, off - (nloc - 1)).max(initial=0))
    H = max(reach_left, reach_right)
    H = _round_up(max(H, 1), 8)
    needs_all_gather = H > nloc

    # ELL with extended-coordinate columns: ext index = off + H ∈ [0, nloc+2H).
    counts = np.diff(A.offs)
    k = max(int(counts.max()), 1)
    vals = np.zeros((n_pad, k), dtype=np.float64)
    cols = np.full((n_pad, k), H, dtype=np.int32)  # padding → safe in-range id
    rows_idx = A.row_indices()
    slot = np.arange(A.nnz) - A.offs[rows_idx]
    vals[rows_idx, slot] = v
    if not needs_all_gather:
        cols[rows_idx, slot] = (off + H).astype(np.int32)
    else:
        cols[rows_idx, slot] = c.astype(np.int32)

    return HaloSpmvPlan(
        vals=jnp.asarray(vals, dtype=dtype), cols=jnp.asarray(cols),
        n=n, n_pad=n_pad, nloc=nloc, halo=H, n_devices=n_devices,
        needs_all_gather=needs_all_gather)


@dataclass
class RectHaloPlan:
    """Halo plan for a RECTANGULAR row-partitioned operator (AMG transfer
    operators P and R — parallel/dist_amg.py).

    Device d owns rows [d·nloc_rows, (d+1)·nloc_rows) of M and holds the
    local block of the SOURCE vector [d·nloc_cols, (d+1)·nloc_cols); the
    halo exchange moves the H boundary rows of the source vector exactly
    as the square-operator plan does (`halo_spmv_local` applies both:
    the math only needs vals/cols rows = nloc_rows and x = nloc_cols).
    `needs_all_gather` when the reach exceeds one neighbor block — the
    caller keeps the all_gather path for that level.
    """
    vals: jax.Array        # (nrow_pad, k) row-sharded
    cols: jax.Array        # (nrow_pad, k) int32 — extended-local source ids
    halo: int
    nloc_rows: int
    nloc_cols: int
    needs_all_gather: bool


def build_rect_halo_plan(M: CsrMatrix, n_devices: int, nloc_rows: int,
                         nloc_cols: int, dtype) -> RectHaloPlan:
    """Rectangular generalization of `build_halo_plan`: the row and source
    partitions have independent block sizes (fine/coarse level pads)."""
    nrow_pad = nloc_rows * n_devices
    r, c, v = M.to_coo()
    dev = r // nloc_rows
    off = c - dev * nloc_cols
    reach_left = int(np.maximum(0, -off).max(initial=0))
    reach_right = int(np.maximum(0, off - (nloc_cols - 1)).max(initial=0))
    H = _round_up(max(max(reach_left, reach_right), 1), 8)
    needs_all_gather = H > nloc_cols

    counts = np.diff(M.offs)
    k = max(int(counts.max(initial=0)), 1)
    vals = np.zeros((nrow_pad, k), dtype=np.float64)
    # Padding slots: val 0 with a safe in-range source id.
    cols = np.full((nrow_pad, k), 0 if needs_all_gather else H,
                   dtype=np.int32)
    rows_idx = M.row_indices()
    slot = np.arange(M.nnz) - M.offs[rows_idx]
    vals[rows_idx, slot] = v
    cols[rows_idx, slot] = (c if needs_all_gather
                            else off + H).astype(np.int32)
    return RectHaloPlan(
        vals=jnp.asarray(vals, dtype=dtype), cols=jnp.asarray(cols),
        halo=H, nloc_rows=nloc_rows, nloc_cols=nloc_cols,
        needs_all_gather=needs_all_gather)


def fused_psum(*scalars, axis=ROWS):
    """One collective for all of an iteration's scalar reductions.

    Stacks the scalars and issues a SINGLE `psum` — the latency-bound
    part of a distributed Krylov iteration is its reductions, so every
    solver here batches them (SURVEY.md §2.2: "one fused psum per CG
    iteration"). Call only inside shard_map over `axis` (an axis name or
    tuple of names for 2-D meshes).
    """
    s = jax.lax.psum(jnp.stack(scalars), axis)
    return tuple(s[i] for i in range(len(scalars)))


def _halo_exchange(x_l, H: int):
    """Ring-exchange the H boundary entries (rows) of the local x
    (ppermute); works for (nloc,) vectors and (nloc, k) blocks alike."""
    ndev = jax.lax.axis_size(ROWS)
    right_halo = jax.lax.ppermute(
        x_l[:H], ROWS, [(d, d - 1) for d in range(1, ndev)])
    left_halo = jax.lax.ppermute(
        x_l[-H:], ROWS, [(d, d + 1) for d in range(ndev - 1)])
    return jnp.concatenate([left_halo, x_l, right_halo])


def halo_spmm_ell_local(halo: int, vals_l, cols_l, X_l):
    """Inside shard_map: halo exchange + jnp gather-ELL local SpMM
    (the any-dtype / CPU fallback). X_l: (nloc, k) → (nloc, k)."""
    X_ext = _halo_exchange(X_l, halo)
    return jnp.einsum("ns,nsk->nk", vals_l, X_ext[cols_l],
                      precision=jax.lax.Precision.HIGHEST)


def force_global_cols(A: CsrMatrix, plan: HaloSpmvPlan) -> HaloSpmvPlan:
    """Rebuild the plan's column ids as global indices (all_gather path)."""
    from dataclasses import replace

    k = plan.vals.shape[1]
    cols = np.zeros((plan.n_pad, k), dtype=np.int32)
    rows_idx = A.row_indices()
    slot = np.arange(A.nnz) - A.offs[rows_idx]
    cols[rows_idx, slot] = A.cols
    return replace(plan, cols=jnp.asarray(cols), needs_all_gather=True)


@dataclass
class DistMatvec:
    """Sharded operator + in-shard matvec, shared by every distributed
    solver (dist_cg / dist_gmres / dist_bicgstab / dist_amg fine level).

    `matvec(op_l, x_l)` is valid only inside shard_map over the ROWS axis:
    op_l is this device's shard of `op_args` (same order as `op_specs`),
    x_l the (nloc,) local x. Output is (nloc,) in the requested dtype.
    """
    op_args: tuple
    op_specs: tuple
    matvec: object          # callable (op_l: tuple, x_l) -> y_l
    matmat: object          # callable (op_l: tuple, X_l (nloc,k)) -> (nloc,k)
    strategy: str           # "halo" | "all_gather"
    local_spmv: str         # "ell"
    halo: int
    nloc: int
    n_pad: int
    n: int
    plan: HaloSpmvPlan


def build_dist_matvec(A: CsrMatrix, mesh, dtype, strategy: str = "auto",
                      local_spmv: str = "auto",
                      row_align: int = 8) -> DistMatvec:
    """Resolve the exchange strategy and build the sharded ELL operator.

    local_spmv: the in-shard SpMV; "auto" and "ell" (the XLA gather
    path) are the only values.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    check_local_spmv(local_spmv)
    dtype = jnp.dtype(dtype)
    n_dev = mesh.devices.size
    plan = build_halo_plan(A, n_dev, dtype, row_align=row_align)
    if strategy == "auto":
        strategy = "all_gather" if plan.needs_all_gather else "halo"
    if strategy == "halo" and plan.needs_all_gather:
        raise ValueError(
            f"halo strategy impossible: halo {plan.halo} exceeds block "
            f"size {plan.nloc}; use all_gather (or reorder with RCM)")
    if strategy == "all_gather" and not plan.needs_all_gather:
        plan = force_global_cols(A, plan)

    row_shard = NamedSharding(mesh, P(ROWS, None))
    op_args = (jax.device_put(plan.vals, row_shard),
               jax.device_put(plan.cols, row_shard))
    op_specs = (P(ROWS, None), P(ROWS, None))
    if strategy == "halo":
        H = plan.halo

        def matvec(op_l, x_l):
            return halo_spmv_local(H, op_l[0], op_l[1], x_l)

        def matmat(op_l, X_l):
            return halo_spmm_ell_local(H, op_l[0], op_l[1], X_l)
    else:
        def matvec(op_l, x_l):
            full = jax.lax.all_gather(x_l, ROWS, tiled=True)
            return jnp.sum(op_l[0] * full[op_l[1]], axis=1)

        def matmat(op_l, X_l):
            full = jax.lax.all_gather(X_l, ROWS, tiled=True)
            return jnp.einsum("ns,nsk->nk", op_l[0], full[op_l[1]],
                              precision=jax.lax.Precision.HIGHEST)

    return DistMatvec(
        op_args=op_args, op_specs=op_specs, matvec=matvec, matmat=matmat,
        strategy=strategy, local_spmv="ell",
        halo=plan.halo, nloc=plan.nloc, n_pad=plan.n_pad, n=plan.n,
        plan=plan)


def check_local_spmv(local_spmv: str) -> None:
    """Reject in-shard SpMV names other than the ELL gather path."""
    if local_spmv not in ("auto", "ell"):
        raise ValueError(f"unknown local_spmv '{local_spmv}' (auto | ell; "
                         "the block-sparse local kernels were removed)")


def halo_spmv_local(plan_halo: int, vals_l, cols_l, x_l):
    """Inside shard_map: exchange halos with ring neighbors, then local SpMV.

    vals_l/cols_l: this device's (nloc, k) block; x_l: (nloc,) local x.
    Returns (nloc,) local y.
    """
    H = plan_halo
    axis = ROWS
    ndev = jax.lax.axis_size(axis)
    # Send my left edge to my left neighbor (they see it as their right
    # halo), and my right edge to my right neighbor (their left halo).
    right_halo = jax.lax.ppermute(
        x_l[:H], axis, [(d, d - 1) for d in range(1, ndev)])
    left_halo = jax.lax.ppermute(
        x_l[-H:], axis, [(d, d + 1) for d in range(ndev - 1)])
    x_ext = jnp.concatenate([left_halo, x_l, right_halo])
    prod = vals_l * x_ext[cols_l]
    return jnp.sum(prod, axis=1)
