"""Device-resident sparse-matrix formats.

The reference computes SpMV straight off CPU CSR with an OpenMP row loop
(reference kernels.hpp:22-42).  CSR's indirect, variable-length rows
map poorly onto wide vector hardware, so matrices are re-laid-out at setup
time into one of two device formats:

* **DIA (diagonal)** — for matrices whose nonzeros live on a small number of
  distinct diagonals (every matrix family the reference ships: HPCG 27-point
  stencils, FDM Laplacians, banded matrices, Anderson lattices).  SpMV
  becomes a sum of elementwise products with *shifted* x slices — no gather
  at all, pure elementwise work + contiguous memory streams:  y = Σ_d data[d] * x[· + off_d].

* **ELL (padded rows)** — general fallback: fixed-width rows, column indices
  + values as dense (n_pad, K) arrays; SpMV is one vectorized gather plus a
  row reduction.

Both are registered pytrees so they pass straight through jit/shard_map.
Auto-selection happens in :func:`from_csr`.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import MatrixCSR

#: pad row lengths to a multiple of this in ELL
_ELL_PAD = 4

#: DIA data rows are padded to a multiple of this (and to at least the
#: halo width)
MIN_ROW_TILE = 8192


@partial(jax.tree_util.register_dataclass,
         data_fields=["data"],
         meta_fields=["offsets", "n_rows", "n_cols", "row_tile"])
@dataclasses.dataclass
class DeviceDIA:
    """Diagonal storage: data[d, i] = A[i, i + offsets[d]] (0 when out of
    range or not stored). offsets are static metadata (trace-time constants),
    so every shifted slice in SpMV is a *static* slice XLA can fuse.
    row_tile is the row padding unit; the data row dimension is padded to
    a multiple of it and it is ≥ the halo width."""

    data: jax.Array               # (n_diags, n_rows_padded) dtype
    offsets: Tuple[int, ...]      # static, sorted ascending
    n_rows: int
    n_cols: int
    row_tile: int = 8192

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz_stored(self) -> int:
        return self.data.shape[0] * self.data.shape[1]


@partial(jax.tree_util.register_dataclass,
         data_fields=["data", "cols"],
         meta_fields=["n_rows", "n_cols"])
@dataclasses.dataclass
class DeviceELL:
    """Padded-row storage: row i's nonzeros in cols[i, :]/data[i, :], padded
    with (col=0, val=0)."""

    data: jax.Array               # (n_rows, K) dtype
    cols: jax.Array               # (n_rows, K) int32
    n_rows: int
    n_cols: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz_stored(self) -> int:
        return self.data.shape[0] * self.data.shape[1]


def analyze_diagonals(A: MatrixCSR, cap: int = 1 << 20):
    """Distinct diagonal offsets of A and the DIA fill ratio.  One C sweep
    when available (bis_csr_pattern_stats); NumPy repeat/unique otherwise.
    Offsets beyond `cap` distinct diagonals return a truncated-size array
    only through the NumPy path (callers only compare counts to small
    thresholds, so the cap never changes a format decision)."""
    if A.nnz == 0:
        return np.zeros(0, dtype=np.int64), 1.0
    from . import _native
    stats = _native.csr_pattern_stats(A, cap=min(cap, A.n_rows + A.n_cols))
    if stats is not None and stats[0] is not None:
        uniq = stats[0]
        return uniq, A.nnz / float(max(1, uniq.size * A.n_rows))
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    offs = A.col.astype(np.int64) - rows
    uniq = np.unique(offs)
    fill = A.nnz / float(max(1, uniq.size * A.n_rows))
    return uniq, fill


def csr_to_dia(A: MatrixCSR, dtype=np.float32) -> DeviceDIA:
    offsets, _ = analyze_diagonals(A)
    # Row tile: at least the halo width.
    hneg = int(max(0, -offsets.min())) if offsets.size else 0
    hpos = int(max(0, offsets.max())) if offsets.size else 0
    row_tile = max(MIN_ROW_TILE,
                   -(-(hneg + hpos) // MIN_ROW_TILE) * MIN_ROW_TILE)
    # Row dimension padded to a multiple of the tile (padding rows are
    # structural zeros).
    npad = max(row_tile, -(-A.n_rows // row_tile) * row_tile)
    from . import _native
    data = _native.csr_to_dia_pack(A, offsets, npad, dtype)
    if data is None:
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
        offs = A.col.astype(np.int64) - rows
        d_idx = np.searchsorted(offsets, offs)
        data = np.zeros((max(1, offsets.size), npad), dtype=dtype)
        data[d_idx, rows] = A.val.astype(dtype)
    return DeviceDIA(data=jnp.asarray(data),
                     offsets=tuple(int(o) for o in offsets),
                     n_rows=A.n_rows, n_cols=A.n_cols, row_tile=row_tile)


def csr_to_ell(A: MatrixCSR, dtype=np.float32) -> DeviceELL:
    row_nnz = A.row_nnz()
    K = int(row_nnz.max()) if A.n_rows else 0
    K = max(_ELL_PAD, -(-K // _ELL_PAD) * _ELL_PAD)
    from . import _native
    packed = _native.csr_to_ell_pack(A, K, dtype)
    if packed is not None:
        data, cols = packed
    else:
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), row_nnz)
        starts = A.row_ptr[:-1]
        lane = np.arange(A.nnz, dtype=np.int64) - starts[rows]
        cols = np.zeros((A.n_rows, K), dtype=np.int32)
        data = np.zeros((A.n_rows, K), dtype=dtype)
        cols[rows, lane] = A.col
        data[rows, lane] = A.val.astype(dtype)
    return DeviceELL(data=jnp.asarray(data), cols=jnp.asarray(cols),
                     n_rows=A.n_rows, n_cols=A.n_cols)


#: lane-ELL eligibility: max |j//128 − i//128| span the windowed format
#: accepts before falling back to plain ELL
LANE_ELL_MAX_SPAN = 2048


class GatherFallbackWarning(UserWarning):
    """The solve is about to run on the plain ELL gather path instead of
    lane-ELL.  Emitted so the format change is never silent."""


def auto_format_choice(A: MatrixCSR, dia_max_diags: int = 96,
                       dia_min_fill: float = 0.25,
                       max_span: int = None) -> str:
    """The format `from_csr(matrix_format="auto")` would pick:
    "dia" | "lane_ell" | "ell".  "ell" is the XLA-gather cliff (~200x
    slower than the lane-ELL kernel) — preprocessing auto-RCMs to avoid
    it when possible."""
    from .ops.lane_ell import lane_ell_span
    if max_span is None:
        max_span = LANE_ELL_MAX_SPAN
    offsets, fill = analyze_diagonals(A)
    if (A.n_rows == A.n_cols and 0 < offsets.size <= dia_max_diags
            and fill >= dia_min_fill):
        return "dia"
    if (A.n_rows == A.n_cols and A.nnz
            and lane_ell_span(A) <= max_span):
        return "lane_ell"
    return "ell"


def from_csr(A: MatrixCSR, dtype=np.float32, matrix_format: str = "auto",
             dia_max_diags: int = 96, dia_min_fill: float = 0.25):
    """Pick the device format for A (config.matrix_format overrides):
    DIA for few-diagonal matrices, windowed lane-ELL (ops/lane_ell.py) for
    general bounded-span sparsity (what RCM reordering produces), XLA-gather
    ELL as the last resort."""
    from .ops.lane_ell import csr_to_lane_ell
    if matrix_format == "dia":
        return csr_to_dia(A, dtype)
    if matrix_format == "ell":
        return csr_to_ell(A, dtype)
    if matrix_format == "lane_ell":
        return csr_to_lane_ell(A, dtype)
    if matrix_format != "auto":
        raise ValueError(f"unknown matrix_format: {matrix_format}")
    choice = auto_format_choice(A, dia_max_diags, dia_min_fill)
    if choice == "dia":
        return csr_to_dia(A, dtype)
    if choice == "lane_ell":
        return csr_to_lane_ell(A, dtype)
    return csr_to_ell(A, dtype)


def device_matrix_nnz_bytes(M) -> int:
    """Bytes of matrix data streamed per SpMV (roofline accounting)."""
    from .ops.lane_ell import DeviceLaneELL
    itemsize = np.dtype(M.dtype).itemsize
    if isinstance(M, DeviceDIA):
        return M.nnz_stored * itemsize
    if isinstance(M, (DeviceELL, DeviceLaneELL)):
        return M.nnz_stored * (itemsize + 4)  # values + int32 indices
    # matrix-free stencil: only the dense diagonal (if any) is streamed
    return M.nnz_stored * itemsize
