"""Sparse triangular solves on the device.

The reference's forward/backward substitutions are inherently sequential row
loops (native_sptrsv / native_bsptrsv, /root/reference/kernels.hpp:54-117);
its only parallel options are (a) SMAX's level-set scheduling after a
permutation and (b) the Jacobi-Richardson ("two-stage") approximation
(/root/reference/kernels.hpp:312-333).  Both are first-class here:

* **Level-scheduled exact solve** — host computes dependency levels
  (factor.level_sets_*); rows are permuted into level order and packed into
  fixed-width padded ELL blocks; the device runs ``lax.scan`` over levels,
  each level solving all its rows in parallel (gather x at the level's
  column pattern, fused multiply-add, masked scatter back).  Exact same
  arithmetic as the reference recurrence, different evaluation order only
  within a level (float-sum order inside a row is preserved per-row).

* **Two-stage Richardson** — out = Σ_{k=0..inner_iters} (−D⁻¹T)ᵏ D⁻¹ y,
  pure SpMV chains (kernels.hpp:312-333), the natural data-parallel form.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..matrix import MatrixCSR
from ..factor import level_sets_lower, level_sets_upper
from .spmv import spmv


@partial(jax.tree_util.register_dataclass,
         data_fields=["rows", "cols", "vals", "dinv"],
         meta_fields=["n_rows", "n_levels", "max_width"])
@dataclasses.dataclass
class TriSolveLevels:
    """Level-packed strictly-triangular system plus the diagonal to divide by.

    rows:  (n_levels, W) int32 — row index per slot, sentinel n_rows for pads
    cols:  (n_levels, W, K) int32 — column pattern (pad col 0 / val 0)
    vals:  (n_levels, W, K) dtype
    dinv:  (n_levels, W) dtype — 1 / D[row] per slot (0 for pads)
    Solves x[r] = (b[r] - Σ_j vals[r, j] * x[cols[r, j]]) * dinv[r],
    level by level.
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    dinv: jax.Array
    n_rows: int
    n_levels: int
    max_width: int


def build_trisolve(T_strict: MatrixCSR, D: np.ndarray, *, upper: bool,
                   dtype=np.float32,
                   levels: Optional[np.ndarray] = None) -> TriSolveLevels:
    """Pack a strictly-triangular CSR + diagonal into level-scheduled form."""
    n = T_strict.n_rows
    if levels is None:
        levels = (level_sets_upper(T_strict) if upper
                  else level_sets_lower(T_strict))
    n_levels = int(levels.max()) + 1 if n else 0
    order = np.argsort(levels, kind="stable").astype(np.int64)
    counts = np.bincount(levels, minlength=n_levels)
    W = int(counts.max()) if n_levels else 0
    row_nnz = T_strict.row_nnz()
    K = int(row_nnz.max()) if n else 0
    K = max(1, K)
    W = max(1, W)

    rows = np.full((n_levels, W), n, dtype=np.int32)
    cols = np.zeros((n_levels, W, K), dtype=np.int32)
    vals = np.zeros((n_levels, W, K), dtype=dtype)
    dinv = np.zeros((n_levels, W), dtype=dtype)

    lvl_of = levels[order]
    # slot index within level
    slot = np.arange(n) - np.concatenate([[0], np.cumsum(counts)])[lvl_of]
    rows[lvl_of, slot] = order
    dinv[lvl_of, slot] = (1.0 / D[order]).astype(dtype)
    # scatter each row's pattern (fully vectorized gather of CSR segments)
    lens = row_nnz[order]
    total = int(lens.sum())
    excl = np.concatenate([[0], np.cumsum(lens)])[:-1]
    lane = np.arange(total, dtype=np.int64) - np.repeat(excl, lens)
    src = np.repeat(T_strict.row_ptr[order], lens) + lane
    lv = np.repeat(lvl_of, lens)
    sl = np.repeat(slot, lens)
    cols[lv, sl, lane] = T_strict.col[src]
    vals[lv, sl, lane] = T_strict.val[src].astype(dtype)

    return TriSolveLevels(rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                          vals=jnp.asarray(vals), dinv=jnp.asarray(dinv),
                          n_rows=n, n_levels=n_levels, max_width=W)


def trisolve(ts: TriSolveLevels, b: jax.Array) -> jax.Array:
    """x such that (T_strict + D) x = b, via the level scan.

    Matches native_sptrsv/native_bsptrsv arithmetic
    (/root/reference/kernels.hpp:54-117): x[r] = (b[r] − Σ T[r,:]·x) / D[r].
    TIME'd as "sptrsv" in kernel-timing mode (kernels.hpp:56).
    """
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _trisolve_impl, ts, b)


def _trisolve_impl(ts: TriSolveLevels, b: jax.Array) -> jax.Array:
    n = ts.n_rows
    bp = jnp.pad(b, (0, 1))  # sentinel row reads 0

    def body(x, level):
        rows, cols, vals, dinv = level
        xg = jnp.take(x, cols, axis=0)                     # (W, K)
        s = jnp.sum(vals * xg, axis=1)                     # (W,)
        xi = (jnp.take(bp, rows) - s) * dinv
        x = x.at[rows].set(xi, mode="drop")
        return x, None

    x0 = jnp.zeros(n, dtype=b.dtype)
    x, _ = jax.lax.scan(body, x0, (ts.rows, ts.cols, ts.vals, ts.dinv))
    return x


def two_stage_solve(T_strict, D_inv: jax.Array, y: jax.Array,
                    inner_iters: int) -> jax.Array:
    """Jacobi-Richardson approximate triangular solve
    (reference two_stage_gauss_seidel, kernels.hpp:312-333):

        work_0 = D⁻¹ y;  work_k = −D⁻¹ (T · work_{k−1});  out = Σ_k work_k
    """
    work = D_inv * y
    out = work
    for _ in range(inner_iters):
        work = -D_inv * spmv(T_strict, work)
        out = out + work
    return out
