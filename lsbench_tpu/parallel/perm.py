"""Host-side symmetric reordering for distributed solvers.

The reference permutes the matrix (and RHS) on host before the device
solve (cusparse.c:66-96, ordering + csrperm + RHS permute) and
un-permutes the solution after (cusparse.c:203-204). The distributed
solvers do the same: an RCM/AMD ordering narrows the band, which shrinks
the halo width (fewer ppermute bytes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lsbench_tpu.matrix.csr import CsrMatrix


@dataclass
class DistOrdering:
    """perm is None for the identity (no-op) ordering."""
    perm: np.ndarray | None
    inv: np.ndarray | None

    def permute_b(self, b):
        if self.perm is None:
            return b
        b = np.asarray(b)
        return b[self.perm]

    def unpermute_x(self, x_host: np.ndarray) -> np.ndarray:
        if self.inv is None:
            return x_host
        return x_host[self.inv]


def resolve_dist_ordering(A: CsrMatrix,
                          ordering: str) -> tuple[CsrMatrix, DistOrdering]:
    """Resolve an ordering name, permute A symmetrically on host."""
    from lsbench_tpu.ordering import get_ordering

    perm = get_ordering(ordering, A)
    if bool(np.all(perm == np.arange(A.nrows))):
        return A, DistOrdering(None, None)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(A.nrows)
    return A.permuted(perm), DistOrdering(perm, inv)
