"""Windowed lane-ELL: a general-sparsity ELL layout with bounded column span.

The reference's core object is arbitrary CSR, and `native_spmv`
(reference kernels.hpp:22-42) walks it row by row.  This format stores
each nonzero relative to a 2-D view of x so that every row's sources lie
in a narrow window of x rows.

Layout (built once at setup from CSR):

* x lives as a 2-D planar array ``x2 = pad(x).reshape(R, 128)``; matrix row
  i maps to slot (i // 128, i % 128).
* Every nonzero A[i, j] is stored at one of K ELL slots of row i as
  ``val`` + a packed index ``(rowoff + S) * 128 + lane`` where
  ``rowoff = j//128 - i//128`` and ``lane = j % 128``.
* S = max |rowoff| over the matrix; eligibility requires S ≤ TB (bounded
  column span — what RCM/BFS reordering (permute.py) produces for general
  matrices; wide scattered patterns fall back to DeviceELL).

The SpMV is one XLA gather per slot plane.  Memory traffic is 8 bytes per
ELL slot (f32 val + packed int32 index) plus x and y.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..matrix import MatrixCSR

#: lanes per x2 row
LANES = 128

#: default row tile of the slot planes; eligibility needs S ≤ TB
_TB = 256


@partial(jax.tree_util.register_dataclass,
         data_fields=["vals", "idx"],
         meta_fields=["n_rows", "n_cols", "K", "S", "R", "TB",
                      "slot_ranges"])
@dataclasses.dataclass
class DeviceLaneELL:
    """Lane-gather ELL storage (see module docstring).

    vals[k, r, l] multiplies x2[r + rowoff, lane] where the packed
    idx[k, r, l] = (rowoff + S)·128 + lane; padding slots have val 0 and
    idx = S·128 (rowoff 0, lane 0 — always in range)."""

    vals: jax.Array               # (K, R, 128) dtype
    idx: jax.Array                # (K, R, 128) int32, packed (rowoff, lane)
    n_rows: int
    n_cols: int
    K: int
    S: int
    R: int
    TB: int
    #: per-slot (min, max) rowoff over all rows — rows are rowoff-sorted at
    #: build time, so each slot's shift range is a small static window and
    #: the kernel gathers only those shifts (instead of all 2S+1)
    slot_ranges: Tuple[Tuple[int, int], ...] = ()

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz_stored(self) -> int:
        return self.vals.size


def lane_ell_span(A: MatrixCSR) -> int:
    """Max |j//128 − i//128| over nonzeros — the kernel's shift radius S."""
    if A.nnz == 0:
        return 0
    from .. import _native
    stats = _native.csr_pattern_stats(A, cap=1)   # only span needed
    if stats is not None:
        return stats[1]
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    return int(np.abs(A.col.astype(np.int64) // LANES
                      - rows // LANES).max())


def csr_to_lane_ell(A: MatrixCSR, dtype=np.float32,
                    tile_rows: int = _TB) -> DeviceLaneELL:
    if A.n_rows != A.n_cols:
        raise ValueError("lane-ELL requires a square matrix")
    n = A.n_rows
    R = max(1, -(-n // LANES))
    S = lane_ell_span(A)
    # window constraint: S ≤ TB (3-block window); small matrices shrink the
    # tile to R so grid padding never dominates
    TB = max(8 * -(-S // 8), min(tile_rows, 8 * -(-R // 8)), 8)
    R_pad = -(-R // TB) * TB
    row_nnz = A.row_nnz()
    K = max(1, int(row_nnz.max()) if n else 1)

    # C fast path: CSR columns ascend within each row, so the (rowoff,
    # lane)-sorted slot order IS the storage order — two sequential C
    # sweeps replace the global nnz lexsort + fancy scatters + per-slot
    # pad-fix passes below (~20x on the throttled host at 90M nnz)
    from .. import _native
    built = _native.lane_ell_build(A, K, S, R_pad, dtype)
    if built is not None:
        vals_n, idx_n, ranges_n = built
        return DeviceLaneELL(vals=jnp.asarray(vals_n),
                             idx=jnp.asarray(idx_n),
                             n_rows=n, n_cols=n, K=K, S=S, R=R_pad, TB=TB,
                             slot_ranges=ranges_n)

    rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    cols = A.col.astype(np.int64)
    rowoff = cols // LANES - rows // LANES
    lane = cols % LANES
    # rowoff-sort each row's entries so slot k sees a narrow static shift
    # window across the whole matrix (kernel loops only those shifts)
    order = np.lexsort((lane, rowoff, rows))
    rows, rowoff, lane = rows[order], rowoff[order], lane[order]
    val_sorted = A.val[order]
    slot = np.arange(A.nnz, dtype=np.int64) - A.row_ptr[:-1][rows]

    vals = np.zeros((K, R_pad, LANES), dtype=dtype)
    idx = np.zeros((K, R_pad, LANES), dtype=np.int32)
    r2, l2 = rows // LANES, rows % LANES
    vals[slot, r2, l2] = val_sorted.astype(dtype)
    idx[slot, r2, l2] = ((rowoff + S) * LANES + lane).astype(np.int32)
    # per-slot static shift ranges; pad slots reuse each slot's own lo so
    # they never widen the range (their val is 0, gather target irrelevant,
    # but the packed rowoff must lie inside the slot's range)
    ranges = []
    for k in range(K):
        sel = slot == k
        if np.any(sel):
            lo = int(rowoff[sel].min())
            hi = int(rowoff[sel].max())
        else:
            lo = hi = 0
        ranges.append((lo, hi))
        pad_mask = vals[k] == 0
        # all-pad positions get packed index (lo + S)*LANES (lane 0)
        idx[k] = np.where(pad_mask & (idx[k] == 0),
                          np.int32((lo + S) * LANES), idx[k])
    return DeviceLaneELL(vals=jnp.asarray(vals), idx=jnp.asarray(idx),
                         n_rows=n, n_cols=n, K=K, S=S, R=R_pad, TB=TB,
                         slot_ranges=tuple(ranges))


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _pad_x2(M: DeviceLaneELL, x: jax.Array) -> jax.Array:
    npad = M.R * LANES
    return jnp.pad(x, (0, npad - M.n_rows)).reshape(M.R, LANES)


def lane_ell_spmv(M: DeviceLaneELL, x: jax.Array) -> jax.Array:
    """y = M @ x: one flat gather per slot plane."""
    x2 = _pad_x2(M, x)
    xf = x2.reshape(-1)
    r = jax.lax.broadcasted_iota(jnp.int32, (M.R, LANES), 0)
    y = jnp.zeros((M.R, LANES), dtype=x.dtype)
    for k in range(M.K):
        rowoff = M.idx[k] // LANES - M.S
        lane = M.idx[k] % LANES
        flat = (r + rowoff) * LANES + lane
        flat = jnp.clip(flat, 0, M.R * LANES - 1)  # pad slots stay in range
        y = y + M.vals[k] * jnp.take(xf, flat.reshape(-1),
                                     axis=0).reshape(M.R, LANES)
    return y.reshape(-1)[:M.n_rows]

