"""Hand-written ELL SpMV for the GPU, through Pallas' Triton route.

One program per tile of `tile` rows. The layout is ELL stored slot-major
(`vals_t`, `cols_t` of shape (k, n_pad)), so each slot's load across the
tile is contiguous; the program gathers `x` at its own column indices and
accumulates the k products in registers. The slots run in a loop of
`unroll` slots per step, so the program's size does not grow with k: AMG
coarse levels and matrices with a few long rows have wide ELL rows. On
the H100 it beat XLA's ELL fusion and cuSPARSE's CSR SpMV alone and
inside CG (PERF.md), so it is the GPU's "auto" layout
(solvers/cg.py::resolve_layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from lsbench_tpu.matrix.csr import CsrMatrix
from lsbench_tpu.matrix.ell import EllMatrix

# Rows per program (a power of two, as Triton requires), warps per
# program, and slots per loop step: chosen on the H100 at n = 263,169 in
# f64 and f32 (`python bench.py --sweep`, PERF.md).
TILE = 256
NUM_WARPS = 4
UNROLL = 4


@jax.tree_util.register_pytree_node_class
@dataclass
class EllSlotMajor:
    vals_t: jax.Array   # (k, n_pad)
    cols_t: jax.Array   # (k, n_pad) int32
    nrows: int
    ncols: int
    nnz: int
    tile: int = TILE

    def tree_flatten(self):
        return ((self.vals_t, self.cols_t),
                (self.nrows, self.ncols, self.nnz, self.tile))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def bytes_streamed(self) -> int:
        return self.vals_t.size * (self.vals_t.dtype.itemsize + 4)

    @staticmethod
    def from_csr(A: CsrMatrix, dtype=jnp.float64,
                 tile: int = TILE) -> "EllSlotMajor":
        ell = EllMatrix.from_csr(A, dtype=dtype, row_align=tile)
        return EllSlotMajor(ell.vals.T, ell.cols.T, A.nrows, A.ncols, A.nnz,
                            tile)


def spmv_ell_triton(A: EllSlotMajor, x: jax.Array, interpret: bool = False,
                    unroll: int | None = UNROLL,
                    num_warps: int = NUM_WARPS) -> jax.Array:
    """y = A @ x. `unroll` slots per loop step (None: all k slots, no
    loop). `interpret=True` runs the Pallas interpreter (CPU tests);
    otherwise the call lowers only for the GPU."""
    k, n_pad = A.vals_t.shape
    dtype = A.vals_t.dtype
    tile = A.tile
    u = k if unroll is None else min(unroll, k)
    steps, rest = divmod(k, u)

    def kernel(vals_ref, cols_ref, x_ref, y_ref):
        rows = pl.ds(pl.program_id(0) * tile, tile)

        def slots(j0, count, acc):
            for j in range(count):
                acc = acc + vals_ref[j0 + j, rows] * x_ref[cols_ref[j0 + j,
                                                                    rows]]
            return acc

        acc = jnp.zeros((tile,), dtype)
        if steps == 1:
            acc = slots(0, u, acc)
        else:
            acc = jax.lax.fori_loop(
                0, steps, lambda s, acc: slots(s * u, u, acc), acc)
        y_ref[...] = slots(steps * u, rest, acc)

    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_pad,), dtype),
        grid=(n_pad // tile,),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=pl.BlockSpec((tile,), lambda i: (i,)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="spmv_ell_triton",
    )(A.vals_t, A.cols_t, x.astype(dtype))
    return y[: A.nrows]
