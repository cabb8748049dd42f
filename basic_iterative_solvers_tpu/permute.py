"""Matrix reordering (the SMAX permute_mat analog).

The reference optionally permutes A, x0 and b before solving so SMAX's
level-scheduled SpTRSV finds more parallelism
(reference utilities/smax_helpers.hpp:44-80; modes NONE/RS/BFS/C/SC/
PC/PC_BAL via SMAX_PERM_MODE, reference CMakeLists.txt:128-136).  On
the device the exact triangular solve is a `lax.scan` over level sets, so its cost
is proportional to the *level count* — reordering directly shortens the
scan.  Modes here:

* ``none`` — identity.
* ``bfs`` — breadth-first ordering; levels become BFS frontiers.
* ``rcm`` — reverse Cuthill-McKee (BFS with degree-sorted frontiers,
  reversed): the classic bandwidth/level reducer.
* ``color`` / ``color_bal`` — greedy / balanced-greedy graph coloring
  (the SMAX C / PC_BAL modes, smax_helpers.hpp:25-28): rows sorted by
  color.  After this permutation the strict-triangular level count equals
  the COLOR COUNT (2-8 for grid stencils), so exact GS/SGS/ILU(0)
  triangular scans become a handful of full-width parallel steps.  See
  also coloring.py for the implicit (permutation-free) colored sweeps.

`perm[new_index] = old_index`.  The solve runs entirely in the permuted
ordering; `x_star` is mapped back before it reaches the user
(solvers/base.py), exactly like the reference's inverse permutation on
output.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .matrix import MatrixCSR

PERM_MODES = ("none", "bfs", "rcm", "color", "color_bal")


def _bfs_order(A: MatrixCSR, sort_by_degree: bool) -> np.ndarray:
    """NumPy fallback BFS (natural-order seeds, all components)."""
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int32)
    pos = 0
    deg = A.row_nnz()
    for start in range(n):
        if seen[start]:
            continue
        seen[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = col[row_ptr[u]:row_ptr[u + 1]]
            nbrs = nbrs[~seen[nbrs]]
            nbrs = np.unique(nbrs)  # unique preserves ascending order
            if sort_by_degree and nbrs.size > 1:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            seen[nbrs] = True
            order[pos:pos + nbrs.size] = nbrs
            pos += nbrs.size
    return order


def compute_permutation(A: MatrixCSR, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm) for the given mode; perm[new] = old."""
    if mode not in PERM_MODES:
        raise ValueError(f"unknown perm_mode: {mode!r} (choose from "
                         f"{PERM_MODES})")
    n = A.n_rows
    if mode == "none":
        perm = np.arange(n, dtype=np.int32)
        return perm, perm.copy()
    if mode in ("color", "color_bal"):
        from .coloring import colors_to_perm, greedy_coloring
        colors = greedy_coloring(A, balanced=(mode == "color_bal"))
        return colors_to_perm(colors)
    from . import _native
    if _native.available():
        perm = _native.bfs_perm(A, reverse=(mode == "rcm"),
                                sort_by_degree=(mode == "rcm"))
    else:
        perm = _bfs_order(A, sort_by_degree=(mode == "rcm"))
        if mode == "rcm":
            perm = perm[::-1].copy()
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return perm, inv


def permute_csr(A: MatrixCSR, perm: np.ndarray,
                inv_perm: np.ndarray) -> MatrixCSR:
    """Symmetric permutation A' = P A Pᵀ with column-sorted rows."""
    from . import _native
    native = _native.permute_csr(A, perm, inv_perm)
    if native is not None:
        return native
    counts = A.row_nnz()[perm]
    row_ptr = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    # gather old rows in new order
    lens = counts
    total = int(lens.sum())
    excl = row_ptr[:-1]
    lane = np.arange(total, dtype=np.int64) - np.repeat(excl, lens)
    src = np.repeat(A.row_ptr[perm], lens) + lane
    col = inv_perm[A.col[src]].astype(np.int32)
    val = A.val[src].copy()
    # column-sort within rows
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), lens)
    order = np.lexsort((col, rows))
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr,
                     col[order], val[order])
