"""Multicolor orderings → parallel exact Gauss-Seidel.

The reference parallelizes exact triangular sweeps only through SMAX's
permutation modes, which include graph COLORING (SMAX_PERM_MODE ∈
{C, SC, PC, PC_BAL}, reference utilities/smax_helpers.hpp:25-28,
reference CMakeLists.txt:128-136): after a proper coloring, rows of
one color are mutually independent, so a Gauss-Seidel sweep in color-sorted
order is #colors fully-parallel steps instead of an n-deep recurrence.

The twist here: the permutation never needs to materialize.  A GS sweep in
the color-sorted ordering is algebraically

    for c in colors (ascending):
        x[i] ← (y[i] − Σ_{j≠i} A[i,j]·x[j]) / D[i]      for all i with
                                                         color[i] == c
which, using the residual form, is the masked Jacobi-like update

    x ← x + 1_{color==c} · (y − A·x) / D

evaluated with the FULL operator A — one SpMV + one fused elementwise pass
per color, in the ORIGINAL ordering, on any device format (stencil, DIA,
ELL).  No splits, no gathers, no permuted copies; proper coloring guarantees
the masked parallel update equals the sequential sweep exactly (same-color
rows never couple).  The sweep IS the exact triangular solve for the colored
ordering: starting from x = 0 it computes (L_c + D)⁻¹y (forward) or
(U_c + D)⁻¹y (reverse color order).

Colorings:

* grid   — stencil operators: per-axis block coloring with strides
           s_a = max|leg_a| + 1 (e.g. 2×2×2 = 8 colors for HPCG's 27-point
           stencil), or classic red-black (2 colors) when every leg has odd
           coordinate sum (FDM 5-point, Anderson 7-point).  Color ids are
           computed from index arithmetic at trace time — zero HBM cost.
* mod    — DIA matrices: color[i] = i mod k for the smallest k ≥ 2 that
           divides no stored nonzero offset (rows i, i+d then always differ
           in color).  Also trace-time arithmetic.
* greedy — general CSR (host, C++ fast path): sequential greedy first-fit,
           or balanced (least-loaded admissible color — the PC_BAL analog).

NOTE: coloring CHANGES the sweep order, so colored GS/SGS is a different
(equally valid) iteration than natural-order GS — convergence tests apply,
not history-parity tests against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import MatrixCSR


@dataclasses.dataclass(frozen=True)
class ColorSpec:
    """Static (hashable, trace-time) description of a coloring.

    kind "grid":  params = (nx, ny, nz, sx, sy, sz); color from grid coords.
    kind "parity": params = (nx, ny, nz); color = (x + y + z) mod 2.
    kind "mod":   params = (k,); color = row mod k.
    kind "array": ids carried separately as a device array (greedy colors).
    """

    kind: str
    n_colors: int
    params: Tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def grid_color_spec(legs, dims) -> ColorSpec:
    """Proper coloring of a constant-stencil adjacency graph.

    Red-black (2 colors) when every nonzero leg has odd |dx|+|dy|+|dz|
    (neighbors always flip parity); otherwise per-axis block coloring with
    stride max|d_a|+1 per axis (Chebyshev-ball stencils like HPCG's 27-point
    get 2×2×2 = 8 colors)."""
    nx, ny, nz = dims
    nonzero = [leg for leg in legs if leg != (0, 0, 0)]
    if not nonzero:
        return ColorSpec("mod", 1, (1,))
    if all((abs(dx) + abs(dy) + abs(dz)) % 2 == 1 for dx, dy, dz in nonzero):
        return ColorSpec("parity", 2, (nx, ny, nz))
    sx = min(max(abs(leg[0]) for leg in nonzero) + 1, nx)
    sy = min(max(abs(leg[1]) for leg in nonzero) + 1, ny)
    sz = min(max(abs(leg[2]) for leg in nonzero) + 1, nz)
    return ColorSpec("grid", sx * sy * sz, (nx, ny, nz, sx, sy, sz))


def mod_color_spec(offsets, n_rows: int) -> ColorSpec:
    """color[i] = i mod k with the smallest k ≥ 2 dividing no stored nonzero
    offset: rows i and i+d (d on a stored diagonal) then never share a
    color, so the coloring is proper for any DIA matrix."""
    offs = sorted({abs(int(o)) for o in offsets if int(o) != 0})
    if not offs:
        return ColorSpec("mod", 1, (1,))
    k = 2
    while any(o % k == 0 for o in offs):
        k += 1
        if k > n_rows:
            raise ValueError("no valid modular coloring (dense band?)")
    return ColorSpec("mod", min(k, n_rows), (min(k, n_rows),))


def greedy_coloring(A: MatrixCSR, balanced: bool = False) -> np.ndarray:
    """Sequential greedy coloring of the (structurally symmetric) CSR graph
    — the SMAX C/PC analog; `balanced` picks the least-loaded admissible
    color (PC_BAL).  Host setup work; C++ fast path in csrc/bis_host.cpp."""
    from . import _native
    colors = _native.greedy_color(A, balanced)
    if colors is not None:
        return colors
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    colors = np.full(n, -1, dtype=np.int32)
    loads = []
    for i in range(n):
        nbr = colors[col[row_ptr[i]:row_ptr[i + 1]]]
        used = set(int(c) for c in nbr if c >= 0)
        if balanced:
            best, best_load = None, None
            for c, ld in enumerate(loads):
                if c not in used and (best is None or ld < best_load):
                    best, best_load = c, ld
            c = best if best is not None else len(loads)
        else:
            c = 0
            while c in used:
                c += 1
        if c == len(loads):
            loads.append(0)
        loads[c] += 1
        colors[i] = c
    return colors


def check_coloring(A: MatrixCSR, colors: np.ndarray) -> bool:
    """True iff no off-diagonal nonzero couples two same-colored rows."""
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
    off = A.col != rows
    return not np.any(colors[rows[off]] == colors[A.col[off]])


def colors_to_perm(colors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm) sorting rows by color, stable within a color —
    the explicit-permutation route (perm[new] = old).  After this symmetric
    permutation the strict-triangular level count equals #colors, so the
    level-scheduled trisolve scan (ops/trisolve.py) collapses to a handful
    of full-width steps."""
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


# ---------------------------------------------------------------------------
# Trace-time color ids in the operator's vector layout
# ---------------------------------------------------------------------------

def color_ids(spec: ColorSpec, A_dev) -> jax.Array:
    """int32 color id per vector slot, in A's vector layout.

    Pure iota arithmetic — XLA fuses it into the consuming elementwise op,
    so grid/mod/parity colorings cost zero HBM traffic.  Planar-halo slots
    receive whatever color their (out-of-grid) coordinates imply; that is
    safe because the sweep's update term is exactly zero there (y, A·x and
    x are all zero at halo slots, D_inv is 1)."""
    from .stencil_op import DeviceStencil, _planar_geometry
    if isinstance(A_dev, DeviceStencil) and A_dev.planar:
        # planar vectors are 2-D (rows_pad, L); ids broadcast to that shape
        L, rows_plane, _, _, _, rows_pad = _planar_geometry(A_dev)
        r = jnp.arange(rows_pad, dtype=jnp.int32)[:, None]
        x = jnp.arange(L, dtype=jnp.int32)[None, :]
        y = r % jnp.int32(rows_plane) - 1
        z = r // jnp.int32(rows_plane) - 1
    else:
        i = jnp.arange(A_dev.n_rows, dtype=jnp.int32)
        if spec.kind == "mod":
            return i % jnp.int32(spec.params[0])
        nx, ny = spec.params[0], spec.params[1]
        x = i % jnp.int32(nx)
        y = (i // jnp.int32(nx)) % jnp.int32(ny)
        z = i // jnp.int32(nx * ny)
    if spec.kind == "mod":
        # planar layout never uses mod specs (grid info is always available)
        raise ValueError("mod coloring is not defined for planar vectors")
    if spec.kind == "parity":
        return (x + y + z) % jnp.int32(2)
    if spec.kind == "grid":
        sx, sy, sz = spec.params[3], spec.params[4], spec.params[5]
        return ((x % jnp.int32(sx))
                + jnp.int32(sx) * ((y % jnp.int32(sy))
                                   + jnp.int32(sy) * (z % jnp.int32(sz))))
    raise ValueError(f"unknown color spec kind: {spec.kind}")


def spec_for_device(A_dev) -> ColorSpec:
    """Pick the natural zero-cost coloring for a device operator."""
    from .stencil_op import DeviceStencil
    from .device_matrix import DeviceDIA
    if isinstance(A_dev, DeviceStencil):
        return grid_color_spec(A_dev.legs, A_dev.dims)
    if isinstance(A_dev, DeviceDIA):
        return mod_color_spec(A_dev.offsets, A_dev.n_rows)
    raise TypeError(
        f"no structural coloring for {type(A_dev).__name__}; use "
        "greedy_coloring on the host CSR")


# ---------------------------------------------------------------------------
# The colored sweep (exact GS in the colored ordering)
# ---------------------------------------------------------------------------

def colored_sweep(A_dev, D_inv: jax.Array, y: jax.Array,
                  x: Optional[jax.Array], spec: Optional[ColorSpec],
                  color_arr: Optional[jax.Array], n_colors: int,
                  reverse: bool = False) -> jax.Array:
    """One exact Gauss-Seidel sweep over colors.

    x given:  the GS iteration update x ← (L_c+D)⁻¹(y − U_c·x) computed in
              residual form (reference gs_separate_iteration semantics,
              methods/gauss_seidel.hpp:26-38, in the colored ordering).
    x = None: the triangular solve (L_c+D)⁻¹y (forward) / (U_c+D)⁻¹y
              (reverse) from a zero initial guess — the preconditioner
              apply (reference sptrsv/bsptrsv, kernels.hpp:54-117).  The
              first color's SpMV is skipped (A·0 = 0).

    Color ids come from `color_arr` (greedy colorings) or are iota-computed
    from `spec` at trace time (grid/mod — zero HBM cost).  Per color: one
    SpMV with the FULL operator + one fused masked update; a proper coloring
    makes the parallel within-color update exact.
    """
    from .ops.spmv import spmv

    ids = color_arr if color_arr is not None else color_ids(spec, A_dev)
    order = range(n_colors - 1, -1, -1) if reverse else range(n_colors)
    for step, c in enumerate(order):
        if x is None and step == 0:
            x = jnp.where(ids == jnp.int32(c), y * D_inv, jnp.zeros_like(y))
            continue
        Ax = spmv(A_dev, x)
        x = jnp.where(ids == jnp.int32(c), x + (y - Ax) * D_inv, x)
    return x
