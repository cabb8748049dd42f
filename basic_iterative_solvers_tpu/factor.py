"""Preconditioner setup: L/U splitting, diagonal peeling, ILU(0), scaling,
and level-set analysis for parallel triangular solves.

Behavioral re-implementation of /root/reference/utilities/LU_factors.hpp:
  * split_LU            (LU_factors.hpp:122-318)
  * peel_diag           (LU_factors.hpp:783-878) — here the diagonal is
                        *stored separately* instead of being swapped to the
                        end of each CRS row (a CPU trick our device formats
                        don't need)
  * factor_ilu0         (LU_factors.hpp:320-539 semantics, incl. pivot
                        guards); unlike the reference, it does NOT require an
                        external library (the reference's active ILU(0) path
                        only works under USE_SMAX, LU_factors.hpp:765-781)
  * extract_scale       (LU_factors.hpp:880-898)
  * factor_LU           (LU_factors.hpp:900-934) orchestrator
plus the level-set computation the reference delegates to SMAX
(smax->get_n_levels(), LU_factors.hpp:559-569) — needed on the device to turn the
sequential SpTRSV recurrence into a scan over parallel wavefronts.

All of this is setup-time host work (NumPy).  A C++ fast path for the hot
loops (ILU(0), level sets) lives in csrc/ and is used when built; the NumPy
versions here are the reference oracles for its tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .matrix import MatrixCSR

ZERO_DIAG_TOL = 1e-16  # reference LU_factors.hpp:800,844


class ZeroDiagonalError(ValueError):
    """Reference aborts via SanityChecker::zero_diag (common.hpp:388-396)."""


class MissingDiagonalError(ValueError):
    """Reference aborts via SanityChecker::no_diag (common.hpp:388-396)."""


def split_LU(A: MatrixCSR) -> Tuple[MatrixCSR, MatrixCSR, MatrixCSR, MatrixCSR]:
    """Split A into (L, L_strict, U, U_strict).

    L = strictly-lower + diagonal, U = strictly-upper + diagonal, matching
    reference split_LU_new (LU_factors.hpp:122-309). Native C++ one-pass
    count+fill when built (csrc/bis_host.cpp); vectorized NumPy otherwise.
    """
    from . import _native
    native = _native.split_lu(A)
    if native is not None:
        return native
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    cols = A.col.astype(np.int64)
    lower = cols <= rows
    lower_strict = cols < rows
    upper = cols >= rows
    upper_strict = cols > rows

    def build(mask):
        counts = np.bincount(rows[mask], minlength=A.n_rows)
        row_ptr = np.zeros(A.n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return MatrixCSR(A.n_rows, A.n_cols, int(mask.sum()), row_ptr,
                         A.col[mask].copy(), A.val[mask].copy())

    return build(lower), build(lower_strict), build(upper), build(upper_strict)


def peel_diag(A: MatrixCSR, need_inv: bool = True,
              check: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Extract the main diagonal as dense D (and 1/D).

    Matches reference peel_diag_crs semantics (LU_factors.hpp:827-869) for
    the produced D/D_inv; raises instead of exit() on zero/missing diagonal.
    The matrix is NOT mutated (the reference swaps the diagonal entry to the
    row end as a CPU-kernel optimization we don't need).
    """
    from . import _native
    if _native.available():
        D = _native.peel_diag(A, ZERO_DIAG_TOL, check, check)
        D_inv = None
        if need_inv:
            with np.errstate(divide="ignore"):
                D_inv = np.where(D != 0.0,
                                 1.0 / np.where(D == 0.0, 1.0, D), 0.0)
        return D, D_inv
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    is_diag = A.col == rows
    diag_rows = rows[is_diag]
    if check and diag_rows.size < A.n_rows:
        missing = np.setdiff1d(np.arange(A.n_rows), diag_rows)[0]
        raise MissingDiagonalError(
            f"ERROR: No diagonal element found in row {missing}")
    D = np.zeros(A.n_rows, dtype=A.val.dtype)
    D[diag_rows] = A.val[is_diag]
    if check and np.any(np.abs(D[diag_rows]) < ZERO_DIAG_TOL):
        bad = diag_rows[np.abs(D[diag_rows]) < ZERO_DIAG_TOL][0]
        raise ZeroDiagonalError(f"ERROR: Zero diagonal element in row {bad}")
    D_inv = None
    if need_inv:
        with np.errstate(divide="ignore"):
            D_inv = np.where(D != 0.0, 1.0 / np.where(D == 0.0, 1.0, D), 0.0)
    return D, D_inv


def extract_scale(A: MatrixCSR) -> np.ndarray:
    """D_scale[i] = 1/sqrt(|a_ii|) for symmetric equilibration
    (reference extract_scale, LU_factors.hpp:880-898)."""
    D, _ = peel_diag(A, need_inv=False, check=True)
    return 1.0 / np.sqrt(np.abs(D))


def scale_mat(A: MatrixCSR, scale: np.ndarray) -> MatrixCSR:
    """A' = diag(s) A diag(s) in place (reference scale_mat,
    preprocessing.hpp:15-24). Returns A for chaining."""
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    A.val *= scale[rows] * scale[A.col]
    return A


def factor_ilu0(A: MatrixCSR, pivot_tolerance: float = 1e-8,
                pivot_replacement: float = 1e-4):
    """ILU(0) factorization: A ≈ L·U restricted to A's sparsity pattern.

    Row-wise IKJ elimination with the reference's numerical safeguards
    (LU_factors.hpp:337-430):
      * elimination pivots with |U(k,k)| < 1e-16 are skipped;
      * final diagonals with |U(i,i)| < pivot_tolerance are replaced by
        sign(U(i,i)) * pivot_replacement;
      * L has an implicit unit diagonal (L_D = ones).

    Returns (L, L_strict, L_D, U, U_strict, U_D) where L contains the unit
    diagonal explicitly, U contains its diagonal, and U_D is the peeled
    diagonal of U (reference factor_LU, LU_factors.hpp:915-918).
    """
    return _assemble_ilu0(A, _ilu0_values(A, pivot_tolerance,
                                          pivot_replacement))


def _assemble_ilu0(A: MatrixCSR, lu_val: np.ndarray):
    """Split in-pattern LU values into L (unit diag), L_strict, U, U_strict."""
    n = A.n_rows
    rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
    cols = A.col.astype(np.int64)

    def build(mask, extra_diag=False):
        counts = np.bincount(rows[mask], minlength=n)
        if extra_diag:
            counts = counts + 1
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        nnz = int(row_ptr[-1])
        out_col = np.empty(nnz, dtype=np.int32)
        out_val = np.empty(nnz, dtype=np.float64)
        if extra_diag:
            # Strict-lower entries keep their order; the unit diagonal is
            # appended as the last entry of each (column-sorted) row.
            sel = np.nonzero(mask)[0]
            r = rows[sel]
            strict_counts = counts - 1
            strict_start = np.zeros(n, dtype=np.int64)
            np.cumsum(strict_counts[:-1], out=strict_start[1:])
            write = row_ptr[r] + (np.arange(sel.size) - strict_start[r])
            out_col[write] = cols[sel]
            out_val[write] = lu_val[sel]
            diag_write = row_ptr[1:] - 1
            out_col[diag_write] = np.arange(n)
            out_val[diag_write] = 1.0
        else:
            out_col[:] = cols[mask]
            out_val[:] = lu_val[mask]
        return MatrixCSR(n, A.n_cols, nnz, row_ptr, out_col, out_val)

    lower_strict = cols < rows
    upper = cols >= rows
    upper_strict = cols > rows
    L = build(lower_strict, extra_diag=True)
    L_strict = build(lower_strict)
    U = build(upper)
    U_strict = build(upper_strict)
    L_D = np.ones(n, dtype=np.float64)
    U_D, _ = peel_diag(U, need_inv=False, check=False)
    return L, L_strict, L_D, U, U_strict, U_D


@dataclasses.dataclass
class LUFactors:
    """Everything factor_LU produces (reference Solver struct fields,
    solver.hpp:18-48)."""

    L: MatrixCSR
    L_strict: MatrixCSR
    U: MatrixCSR
    U_strict: MatrixCSR
    A_D: np.ndarray
    A_D_inv: np.ndarray
    L_D: np.ndarray
    U_D: np.ndarray


def factor_LU(A: MatrixCSR, ilu0: bool = False,
              pivot_tolerance: float = 1e-8,
              pivot_replacement: float = 1e-4) -> LUFactors:
    """Orchestrator matching reference factor_LU (LU_factors.hpp:900-934):
    split → peel A_D; if ILU(0), overwrite L/U with the incomplete factors
    and peel U_D."""
    L, L_strict, U, U_strict = split_LU(A)
    A_D, A_D_inv = peel_diag(L)
    n = A.n_rows
    L_D = np.ones(n, dtype=np.float64)
    U_D = A_D.copy()
    if ilu0:
        L, L_strict, L_D, U, U_strict, U_D = factor_ilu0(
            A, pivot_tolerance, pivot_replacement)
    return LUFactors(L, L_strict, U, U_strict, A_D, A_D_inv, L_D, U_D)


def factor_ilu0_colored(A: MatrixCSR, colors: np.ndarray,
                        pivot_tolerance: float = 1e-8,
                        pivot_replacement: float = 1e-4):
    """ILU(0) with respect to the COLOR-SORTED ordering, returned in the
    ORIGINAL ordering — the multicolor-parallel exact ILU(0).

    Factor in the permuted space (where the elimination order is
    color-major), then map the factor values back to original row/column
    indices.  The "lower"/"upper" split is by COLOR comparison, not index
    comparison: L = entries with color(j) < color(i) (unit diagonal
    implicit), U = color(j) > color(i) plus the diagonal.  Both strict
    parts keep A's sparsity pattern (positions), so for stencil/banded
    matrices they remain DIA-able in the original ordering, and the
    triangular solves apply as multicolor masked sweeps (coloring.py) —
    #colors parallel SpMV steps each, no level scan.

    Like any reordered ILU(0), the factor VALUES differ from the
    natural-order factorization (a different, equally valid
    preconditioner).

    Returns (L_strict, U_strict, U_D) in the original ordering.
    """
    rows_o, cols_o, lu_val_p, U_D = factor_ilu0_colored_triplets(
        A, colors, pivot_tolerance=pivot_tolerance,
        pivot_replacement=pivot_replacement)
    n = A.n_rows
    ci, cj = colors[rows_o], colors[cols_o]

    def build(mask):
        from .matrix import MatrixCOO, convert_coo_to_csr
        coo = MatrixCOO.from_arrays(rows_o[mask], cols_o[mask],
                                    lu_val_p[mask], n_rows=n, n_cols=n)
        return convert_coo_to_csr(coo)

    return build(cj < ci), build(cj > ci), U_D


def factor_ilu0_colored_triplets(A: MatrixCSR, colors: np.ndarray,
                                 pivot_tolerance: float = 1e-8,
                                 pivot_replacement: float = 1e-4):
    """Colored ILU(0) factor values as raw triplets in the original
    ordering: (rows, cols, vals, U_D).  The triplets carry ALL factor
    entries (L, U and the diagonal); consumers split by color comparison.
    This avoids the two 27M-entry COO→CSR sorts of factor_ilu0_colored —
    the blocked-trisolve builders group entries themselves and never need
    CSR structure."""
    from . import _native
    from .coloring import colors_to_perm
    from .permute import permute_csr

    perm, inv = colors_to_perm(colors)
    # one fused C sweep when available (permute + factor, no intermediate
    # matrix copy — bis_permute_factor_csr); two-pass fallback otherwise
    fused_pf = _native.permute_factor_csr(A, perm, inv, pivot_tolerance,
                                          pivot_replacement)
    if fused_pf is not None:
        Ap, lu_val_p = fused_pf
    else:
        Ap = permute_csr(A, perm, inv)
        lu_val_p = _ilu0_values(Ap, pivot_tolerance, pivot_replacement)

    n = A.n_rows
    if _native.available() and n < 2**31:
        rows_o, cols_o, U_D = _native.expand_perm_triplets(Ap, lu_val_p,
                                                           perm)
        return rows_o, cols_o, lu_val_p, U_D
    rows_p = np.repeat(np.arange(n, dtype=np.int64), Ap.row_nnz())
    rows_o = perm[rows_p].astype(np.int64)
    cols_o = perm[Ap.col].astype(np.int64)
    diag_mask = rows_o == cols_o
    U_D = np.zeros(n, dtype=np.float64)
    U_D[rows_o[diag_mask]] = lu_val_p[diag_mask]
    return rows_o, cols_o, lu_val_p, U_D


def _ilu0_values(A: MatrixCSR, pivot_tolerance: float,
                 pivot_replacement: float) -> np.ndarray:
    """In-pattern ILU(0) values for A: row-wise IKJ elimination with the
    reference's pivot guards (LU_factors.hpp:337-430,602,639-642) — the raw
    value array before any L/U assembly.  C++ fast path, NumPy fallback
    (the dense-workspace trick of LU_factors.hpp:332-347)."""
    from . import _native
    lu_val = _native.ilu0(A, pivot_tolerance, pivot_replacement)
    if lu_val is not None:
        return lu_val
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    lu_val = A.val.astype(np.float64).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
    is_diag = col == rows
    diag_pos[rows[is_diag]] = np.nonzero(is_diag)[0]
    if np.any(diag_pos < 0):
        missing = int(np.nonzero(diag_pos < 0)[0][0])
        raise MissingDiagonalError(
            f"ERROR: ILU(0) requires a full diagonal; missing in row {missing}")
    w_pos = np.full(A.n_cols, -1, dtype=np.int64)
    for i in range(n):
        s, e = row_ptr[i], row_ptr[i + 1]
        cols_i = col[s:e]
        w_pos[cols_i] = np.arange(s, e)
        for p_ in range(s, e):
            k = col[p_]
            if k >= i:
                break
            pivot = lu_val[diag_pos[k]]
            if abs(pivot) < 1e-16:
                continue
            factor = lu_val[p_] / pivot
            lu_val[p_] = factor
            for q in range(diag_pos[k] + 1, row_ptr[k + 1]):
                tgt = w_pos[col[q]]
                if tgt >= 0:
                    lu_val[tgt] -= factor * lu_val[q]
        d = lu_val[diag_pos[i]]
        if abs(d) < pivot_tolerance:
            lu_val[diag_pos[i]] = (1.0 if d >= 0 else -1.0) * pivot_replacement
        w_pos[cols_i] = -1
    return lu_val


# ---------------------------------------------------------------------------
# Level-set analysis (the SMAX analog) for parallel triangular solves.
# ---------------------------------------------------------------------------

def level_sets_lower(L_strict: MatrixCSR) -> np.ndarray:
    """level[i] = 1 + max(level[j] : j in strictly-lower pattern of row i).

    Rows within the same level are independent in the forward substitution
    x[i] = (b[i] - Σ L[i,j] x[j]) / D[i]; the device solve scans levels and
    processes each level's rows in parallel. The reference gets this from
    SMAX's level scheduler (LU_factors.hpp:559-569, smax_helpers.hpp:25-28).
    """
    from . import _native
    levels = _native.level_sets(L_strict)
    if levels is not None:
        return levels
    n = L_strict.n_rows
    level = np.zeros(n, dtype=np.int32)
    row_ptr, col = L_strict.row_ptr, L_strict.col
    for i in range(n):
        s, e = row_ptr[i], row_ptr[i + 1]
        if e > s:
            level[i] = level[col[s:e]].max() + 1
    return level


def level_sets_upper(U_strict: MatrixCSR) -> np.ndarray:
    """Level sets for the backward substitution (rows processed N-1 → 0)."""
    from . import _native
    levels = _native.level_sets_upper(U_strict)
    if levels is not None:
        return levels
    n = U_strict.n_rows
    level = np.zeros(n, dtype=np.int32)
    row_ptr, col = U_strict.row_ptr, U_strict.col
    for i in range(n - 1, -1, -1):
        s, e = row_ptr[i], row_ptr[i + 1]
        if e > s:
            level[i] = level[col[s:e]].max() + 1
    return level
