"""Two-pass SpGEMM: host symbolic, device numeric — SURVEY.md §7.5.

The Galerkin product's sparsity pattern is static per hierarchy, so the
symbolic pass (pattern + expansion plan) runs once on host, and the
numeric pass is a pure static-shaped device computation:

    c_vals[out_idx[t]] += a_vals[a_idx[t]] * b_vals[b_idx[t]]

i.e. two gathers, one multiply, one `segment_sum` — XLA-friendly, no
dynamic output sparsity anywhere (the classic obstacle to device SpGEMM,
SURVEY.md §7 "hard parts" item 2). The reference does its RAP inside
Hypre on device (hypre.c:97); this is the equivalent here for
re-forming coarse operators when only VALUES change (same pattern), e.g.
parameter-dependent re-assembly, without leaving the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


@dataclass
class SpgemmPlan:
    """Host-built symbolic plan for C = A @ B (pattern + expansion map).

    The reduction layout is SCATTER-FREE: expansion triples are sorted
    by destination slot, slots are grouped into power-of-two pad classes
    by triple count, and the numeric pass is pure gathers + dense
    row-sums + one permutation gather — no scatter-add (whose summation
    order is nondeterministic) and no giant cumsum (whose prefix-sum
    cancellation loses digits). Padding targets the appended ZERO sentinel at
    contrib[T], so padded lanes add exactly 0; per-slot sums are plain
    sequential f64 adds (no prefix-sum cancellation).
    """
    a_idx: jax.Array      # (T,) index into A.vals, sorted by dest slot
    b_idx: jax.Array      # (T,) index into B.vals, same order
    pads: tuple           # per class: (n_c, w) int32 into contrib_ext
    slot_pos: jax.Array   # (nnz,) position of slot j in concat(class outs)
    offs: np.ndarray      # C pattern (host)
    cols: np.ndarray
    nrows: int
    ncols: int
    nnz: int


def _class_pads(counts: np.ndarray, total: int):
    """Group output slots into pow-2 pad classes; build gather indices.

    Returns (pads, slot_pos): pads[k] is an (n_k, w_k) int32 array of
    positions into the length-(total+1) extended contribution stream
    (position `total` is the zero sentinel); slot_pos[j] is slot j's row
    in the concatenation of all class outputs.
    """
    nnz = counts.size
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = np.maximum(1, 1 << np.ceil(
        np.log2(np.maximum(counts, 1))).astype(np.int64))
    pads = []
    order_slots = []
    for w in np.unique(width):
        sel = np.flatnonzero(width == w)
        st = starts[sel]
        cnt = counts[sel]
        idx = st[:, None] + np.arange(w)[None, :]
        idx = np.where(np.arange(w)[None, :] < cnt[:, None], idx, total)
        pads.append(jnp.asarray(idx, jnp.int32))
        order_slots.append(sel)
    concat_slots = np.concatenate(order_slots)
    slot_pos = np.empty(nnz, dtype=np.int64)
    slot_pos[concat_slots] = np.arange(nnz)
    return tuple(pads), jnp.asarray(slot_pos, jnp.int32)


def spgemm_symbolic(A: CsrMatrix, B: CsrMatrix) -> SpgemmPlan:
    """Symbolic pass: expansion triples + deduplicated output pattern."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    a_rows = A.row_indices()
    counts = (B.offs[A.cols + 1] - B.offs[A.cols]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        plan_empty = SpgemmPlan(
            a_idx=jnp.zeros(1, jnp.int32), b_idx=jnp.zeros(1, jnp.int32),
            pads=(), slot_pos=jnp.zeros(0, jnp.int32),
            offs=np.zeros(A.nrows + 1, dtype=np.int64),
            cols=np.zeros(0, dtype=np.int64),
            nrows=A.nrows, ncols=B.ncols, nnz=0)
        return plan_empty
    a_idx = np.repeat(np.arange(A.nnz, dtype=np.int64), counts)
    starts = B.offs[A.cols].astype(np.int64)
    ends = np.cumsum(counts)
    b_idx = (np.arange(total, dtype=np.int64)
             - np.repeat(ends - counts, counts) + np.repeat(starts, counts))
    out_i = np.repeat(a_rows, counts)
    out_j = B.cols[b_idx]

    key = out_i * np.int64(B.ncols) + out_j
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // B.ncols).astype(np.int64)
    c_cols = (uniq % B.ncols).astype(np.int64)
    offs = np.zeros(A.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_rows, minlength=A.nrows), out=offs[1:])
    # Sort expansion triples by destination slot (stable), then build the
    # scatter-free class-padded reduction layout.
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=uniq.size)
    pads, slot_pos = _class_pads(counts, total)
    return SpgemmPlan(
        a_idx=jnp.asarray(a_idx[order], jnp.int32),
        b_idx=jnp.asarray(b_idx[order], jnp.int32),
        pads=pads, slot_pos=slot_pos,
        offs=offs, cols=c_cols, nrows=A.nrows, ncols=B.ncols,
        nnz=uniq.size)


def spgemm_numeric(plan: SpgemmPlan, a_vals, b_vals):
    """Device numeric pass (jittable): C values in plan order."""
    return spgemm_numeric_idx(plan.a_idx, plan.b_idx, plan.pads,
                              plan.slot_pos, plan.nnz, a_vals, b_vals)


@dataclass
class RapPlan:
    """Composed device plan for the Galerkin triple product R A P."""
    ra: SpgemmPlan
    rap: SpgemmPlan


def rap_symbolic(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> RapPlan:
    """Symbolic RAP: pattern of RA (with PLACEHOLDER values — the pattern
    is value-independent since expansion keeps structural zeros), then of
    (RA)·P."""
    ra = spgemm_symbolic(R, A)
    RA_pattern = CsrMatrix(nrows=ra.nrows, ncols=ra.ncols, offs=ra.offs,
                           cols=ra.cols, vals=np.ones(max(ra.nnz, 1)))
    rap = spgemm_symbolic(RA_pattern, P)
    return RapPlan(ra=ra, rap=rap)


def rap_numeric(plan: RapPlan, r_vals, a_vals, p_vals):
    """Device numeric RAP (jittable): coarse-operator values."""
    ra_vals = spgemm_numeric(plan.ra, r_vals, a_vals)
    return spgemm_numeric(plan.rap, ra_vals, p_vals)


def spgemm_numeric_idx(a_idx, b_idx, pads, slot_pos, nnz: int,
                       a_vals, b_vals):
    """spgemm_numeric with the plan arrays as EXPLICIT arguments.

    Closing over the plan arrays bakes them into the executable as HLO
    literal constants — at n=262k the RAP expansion triples run to
    hundreds of MB (same concern as Solver.solve_fn_args). Pass them as
    jit arguments instead; only `nnz` is static.

    Reduction (see SpgemmPlan): contributions gathered per pad class and
    row-summed densely, output assembled by ONE permutation gather —
    scatter-free and scan-free (gathers + vector adds, bandwidth-bound).
    """
    if nnz == 0:
        return jnp.zeros(0, dtype=jnp.result_type(a_vals, b_vals))
    contrib = a_vals[a_idx] * b_vals[b_idx]
    contrib_ext = jnp.concatenate(
        [contrib, jnp.zeros(1, dtype=contrib.dtype)])
    parts = [contrib_ext[p].sum(axis=1) for p in pads]
    return jnp.concatenate(parts)[slot_pos]


def rap_numeric_idx(plan_idx, nnz_ra: int, nnz_rap: int,
                    r_vals, a_vals, p_vals):
    """Device numeric RAP with plan arrays as arguments (see
    spgemm_numeric_idx). `plan_idx` is the 8-tuple
    (ra.a_idx, ra.b_idx, ra.pads, ra.slot_pos,
     rap.a_idx, rap.b_idx, rap.pads, rap.slot_pos)."""
    (ra_ai, ra_bi, ra_pd, ra_sp,
     rap_ai, rap_bi, rap_pd, rap_sp) = plan_idx
    ra_vals = spgemm_numeric_idx(ra_ai, ra_bi, ra_pd, ra_sp, nnz_ra,
                                 r_vals, a_vals)
    return spgemm_numeric_idx(rap_ai, rap_bi, rap_pd, rap_sp, nnz_rap,
                              ra_vals, p_vals)


def rap_device(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> CsrMatrix:
    """Galerkin RAP with the numeric phase on device; returns host CSR."""
    plan = rap_symbolic(R, A, P)
    # Eager call: plan holds static host metadata (not a pytree); the
    # gathers/segment_sum inside still execute on the default device. To
    # jit, close over the plan: jax.jit(lambda rv, av, pv:
    # rap_numeric(plan, rv, av, pv)).
    vals = np.asarray(rap_numeric(plan, jnp.asarray(R.vals),
                                  jnp.asarray(A.vals), jnp.asarray(P.vals)))
    return CsrMatrix(nrows=plan.rap.nrows, ncols=plan.rap.ncols,
                     offs=plan.rap.offs, cols=plan.rap.cols,
                     vals=np.asarray(vals, dtype=np.float64))
