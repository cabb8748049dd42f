"""Preconditioner engine: z ← M⁻¹ y.

Functional re-design of apply_preconditioner
(/root/reference/kernels.hpp:336-414) + its setup half (factor_LU,
/root/reference/utilities/LU_factors.hpp:900-934).  Setup happens once on
the host and produces a `Preconditioner` pytree holding only what the chosen
type needs; apply is pure and jit-traceable.

Type → action (all matching the reference dispatch, kernels.hpp:354-399):
  none   : z = y
  jacobi : z = y / A_D
  gs     : z = (L_strict + D)⁻¹ y                       [exact level solve]
  bgs    : z = (U_strict + D)⁻¹ y
  sgs    : z = (U+D)⁻¹ D (L+D)⁻¹ y
  2st    : Richardson approx of (L+D)⁻¹ (kernels.hpp:312-333)
  s2st   : Richardson (L), multiply by A_D, Richardson (U)
  ilu0   : z = U⁻¹ L⁻¹ y with unit-diagonal L
The whole action is repeated `precond_outer_iters` times (composition),
matching the reference outer loop (kernels.hpp:355-404).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import SolverConfig
from .factor import LUFactors, factor_LU
from .matrix import MatrixCSR
from .types import PrecondType
from .device_matrix import from_csr
from .ops.trisolve import TriSolveLevels, build_trisolve, trisolve, two_stage_solve


@partial(jax.tree_util.register_dataclass,
         data_fields=["A_D", "A_D_inv", "L_solve", "U_solve",
                      "L_strict_dev", "U_strict_dev", "A_full_dev",
                      "color_arr", "L_block", "U_block", "cheby_lmax",
                      "mg_data"],
         meta_fields=["ptype", "outer_iters", "inner_iters",
                      "color_spec", "n_colors", "cheby_degree",
                      "cheby_ratio", "mg_smooth_degree", "mg_coarse_degree",
                      "mg_ratio", "mg_coarse_ratio", "mg_transfer"])
@dataclasses.dataclass
class Preconditioner:
    ptype: PrecondType
    outer_iters: int
    inner_iters: int
    A_D: Optional[jax.Array] = None            # diag of A
    A_D_inv: Optional[jax.Array] = None
    L_solve: Optional[TriSolveLevels] = None   # forward solve data
    U_solve: Optional[TriSolveLevels] = None   # backward solve data
    L_strict_dev: Any = None                   # device matrix for Richardson
    U_strict_dev: Any = None
    # Multicolor exact-GS path (coloring.py): gs/bgs/sgs applied as masked
    # sweeps with the FULL operator — no splits, no level packing.
    A_full_dev: Any = None
    color_arr: Optional[jax.Array] = None      # greedy ids (grid/mod use spec)
    # Blocked multicolor trisolves (ops/block_trisolve.py): the same colored
    # solves with the factors streamed ONCE per solve instead of once per
    # color — used when a separable spec coloring is available.
    L_block: Any = None                        # BlockedTriSolve
    U_block: Any = None
    color_spec: Any = None                     # ColorSpec (static, hashable)
    n_colors: int = 0
    # Chebyshev polynomial preconditioner (SolverConfig.cheby_*): λmax of
    # D⁻¹A (traced scalar, power-iteration estimate incl. headroom) and the
    # static degree / eig-ratio defining the polynomial interval.
    cheby_lmax: Optional[jax.Array] = None
    cheby_degree: int = 0
    cheby_ratio: float = 30.0
    # Geometric multigrid (mg.py): the level tuple (MGLevel pytrees) plus
    # the static V-cycle shape (SolverConfig.mg_*).
    mg_data: Any = None
    mg_smooth_degree: int = 0
    mg_coarse_degree: int = 0
    mg_ratio: float = 4.0
    mg_coarse_ratio: float = 200.0
    mg_transfer: str = "linear"


#: preconditioner types a multicolor ordering can serve (exact sweeps in
#: the color-sorted ordering; coloring.py)
COLORED_PRECONDS = (PrecondType.GAUSS_SEIDEL,
                    PrecondType.BACKWARDS_GAUSS_SEIDEL,
                    PrecondType.SYMMETRIC_GAUSS_SEIDEL)


def resolve_gs_mode(config: SolverConfig, device_native: bool) -> str:
    """"auto" → "levels" on the host-CSR path (reference-order parity),
    "colored" on the device-native path (see SolverConfig.gs_mode)."""
    if config.gs_mode != "auto":
        return config.gs_mode
    return "colored" if device_native else "levels"


def _colors_for_setup(A: MatrixCSR, config: SolverConfig):
    """(colors, spec) for the colored preconditioner paths.

    When the config carries a separable ColorSpec (grid/mod — derived by
    the CLI/bench from generator sources) and no reordering was applied,
    the spec's structural coloring is used and the blocked trisolve
    (ops/block_trisolve.py) becomes available; otherwise greedy colors →
    masked sweeps."""
    spec = config.color_spec
    if (spec is not None and config.perm_mode == "none"
            and spec.kind in ("grid", "mod")):
        from .ops.block_trisolve import spec_colors_np
        try:
            # properness is validated per-entry inside the blocked-trisolve
            # builders (ImproperColoringError → callers recolor greedily);
            # no separate O(nnz) host pass here
            return spec_colors_np(spec, A.n_rows), spec
        except ValueError:
            pass
    from .coloring import greedy_coloring
    return greedy_coloring(A), None


def setup_preconditioner(A: MatrixCSR, config: SolverConfig,
                         factors: Optional[LUFactors] = None,
                         A_dev=None) -> Preconditioner:
    """Build device-side preconditioner data. `factors` may be shared with
    the solver setup to avoid re-factorizing; `A_dev` (the already-built
    device matrix) is reused by the colored-GS path."""
    pt = config.preconditioner
    dtype = config.spec_dtype()
    mat_dtype = config.mat_dtype()
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    if pt == PrecondType.MULTIGRID:
        raise ValueError(
            "multigrid requires the matrix-free stencil operator (a "
            "generator source with matrix_format='stencil'); explicit CSR "
            "matrices take the host path — use '-p cheby' or '-p ilu0' "
            "there")
    if (pt == PrecondType.ILU0
            and resolve_gs_mode(config, device_native=False) == "colored"):
        # Multicolor exact ILU(0): factor w.r.t. the color-sorted ordering,
        # apply the strict factors as blocked trisolves (spec colorings —
        # factors stream once per solve) or masked sweeps (greedy colors —
        # #colors full-operator SpMV steps per solve).
        from .factor import factor_ilu0_colored_triplets
        colors, spec = _colors_for_setup(A, config)
        if spec is not None and spec.kind == "grid" and A_dev is not None:
            # Translation-table fast path: when the solve operator is a
            # constant-coefficient stencil, the exact colored-ILU(0)
            # factors come from a tiny prototype factorization + device
            # class gathers — the host CSR is never touched
            # (build_superblock_ilu0_pair_stencil).
            from .stencil_op import DeviceStencil
            op = A_dev
            if isinstance(op, DeviceStencil):
                from .ops.block_trisolve import (
                    BlockIneligibleError, ImproperColoringError,
                    build_superblock_ilu0_pair_stencil)
                try:
                    L_blk, U_blk = build_superblock_ilu0_pair_stencil(
                        op, spec, dtype=dtype,
                        pivot_tolerance=config.ilu0_pivot_tolerance,
                        pivot_replacement=config.ilu0_pivot_replacement)
                    return Preconditioner(
                        L_block=L_blk, U_block=U_blk,
                        color_spec=spec, n_colors=spec.n_colors, **kw)
                except (BlockIneligibleError, ImproperColoringError):
                    pass   # CSR-direct / triplet pipelines below
        if spec is not None and spec.kind == "grid":
            # CSR-direct fast path: permute → factor → pack the pair in two
            # C passes over the permuted CSR (no triplet materialization;
            # csrc bis_sb_*_csr).  Structural ineligibility falls through
            # to the triplet pipeline below.
            from .coloring import colors_to_perm
            from .factor import _ilu0_values
            from .ops.block_trisolve import (BlockIneligibleError,
                                             ImproperColoringError,
                                             build_superblock_ilu0_pair,
                                             spec_colors_valid)
            from .permute import permute_csr
            from . import _native
            try:
                # gate on the native library BEFORE the expensive
                # permute+factor work — otherwise the triplet fallback
                # would redo both from scratch
                if not _native.available() or A.n_rows >= 2**31:
                    raise BlockIneligibleError("native library unavailable")
                if not spec_colors_valid(colors, spec, A.n_rows):
                    raise BlockIneligibleError("non-spec colors")
                perm, inv = colors_to_perm(colors)
                # one fused C sweep: permute + factor (bis_permute_factor_csr)
                # — the separate permute pass, value copy and factor re-read
                # are the setup bottleneck on the throttled host
                fused_pf = _native.permute_factor_csr(
                    A, perm, inv, config.ilu0_pivot_tolerance,
                    config.ilu0_pivot_replacement)
                if fused_pf is not None:
                    Ap, lu_p = fused_pf
                else:
                    Ap = permute_csr(A, perm, inv)
                    lu_p = _ilu0_values(Ap, config.ilu0_pivot_tolerance,
                                        config.ilu0_pivot_replacement)
                L_blk, U_blk, _U_D = build_superblock_ilu0_pair(
                    Ap, lu_p, perm, spec, dtype=dtype)
                return Preconditioner(
                    L_block=L_blk, U_block=U_blk,
                    color_spec=spec, n_colors=spec.n_colors, **kw)
            except (BlockIneligibleError, ImproperColoringError):
                pass   # triplet pipeline below handles fallback/recolor
        rows_o, cols_o, lu_vals, U_D = factor_ilu0_colored_triplets(
            A, colors, pivot_tolerance=config.ilu0_pivot_tolerance,
            pivot_replacement=config.ilu0_pivot_replacement)
        trip = (rows_o, cols_o, lu_vals, A.n_rows)
        if spec is not None:
            from .ops.block_trisolve import (BlockIneligibleError,
                                             ImproperColoringError,
                                             build_best_trisolve_pair)
            try:
                # triplet form: the builders split L/U by color comparison
                # themselves — no CSR assembly of the factors at all; the
                # PAIR builder guarantees L and U share one block layout
                L_blk, U_blk = build_best_trisolve_pair(
                    trip, None, U_D, colors, spec, dtype=dtype)
                return Preconditioner(
                    L_block=L_blk, U_block=U_blk,
                    color_spec=spec, n_colors=spec.n_colors, **kw)
            except ImproperColoringError:
                # the spec does not properly color this matrix — the
                # factorization itself used invalid colors: recolor
                # greedily and refactor before the sweep fallback
                from .coloring import greedy_coloring
                colors = greedy_coloring(A)
                rows_o, cols_o, lu_vals, U_D = factor_ilu0_colored_triplets(
                    A, colors,
                    pivot_tolerance=config.ilu0_pivot_tolerance,
                    pivot_replacement=config.ilu0_pivot_replacement)
            except BlockIneligibleError:
                pass   # colors proper, layout ineligible → masked sweeps
        # masked-sweep fallback needs the factors as device matrices
        from .matrix import MatrixCOO, convert_coo_to_csr
        ci, cj = colors[rows_o], colors[cols_o]

        def _csr(mask):
            coo = MatrixCOO.from_arrays(rows_o[mask], cols_o[mask],
                                        lu_vals[mask], n_rows=A.n_rows,
                                        n_cols=A.n_cols)
            return convert_coo_to_csr(coo)

        L_s, U_s = _csr(cj < ci), _csr(cj > ci)
        fmt_args = (mat_dtype, config.matrix_format, config.dia_max_diags,
                    config.dia_min_fill)
        return Preconditioner(
            # A_D/A_D_inv carry U's diagonal here (L has an implicit unit
            # diagonal; the forward sweep divides by 1)
            A_D=jnp.asarray(U_D.astype(dtype)),
            A_D_inv=jnp.asarray((1.0 / U_D).astype(dtype)),
            L_strict_dev=from_csr(L_s, *fmt_args),
            U_strict_dev=from_csr(U_s, *fmt_args),
            color_arr=jnp.asarray(colors),
            n_colors=int(colors.max()) + 1, **kw)
    if (pt in COLORED_PRECONDS
            and resolve_gs_mode(config, device_native=False) == "colored"):
        # host-CSR colored setup: spec coloring → blocked trisolves (the
        # color-split strict parts of A, streamed once per solve); greedy
        # colors → masked sweeps with the full device operator (coloring.py).
        # Only the DIAGONAL is needed here — peel it directly instead of
        # the full factor_LU split (a ~1.4 GB host pass at HPCG-128).
        from .factor import peel_diag
        if factors is not None:
            A_D_np, A_D_inv_np = factors.A_D, factors.A_D_inv
        else:
            A_D_np, A_D_inv_np = peel_diag(A)
        A_D = jnp.asarray(A_D_np.astype(dtype))
        A_D_inv = jnp.asarray(A_D_inv_np.astype(dtype))
        colors, spec = _colors_for_setup(A, config)
        if spec is not None:
            from .ops.block_trisolve import (BlockIneligibleError,
                                             ImproperColoringError,
                                             build_best_trisolve,
                                             build_best_trisolve_pair,
                                             build_superblock_gs_pair_from_csr,
                                             spec_colors_valid)
            try:
                sym = pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL
                L_blk = U_blk = None
                if (spec.kind == "grid"
                        and spec_colors_valid(colors, spec, A.n_rows)):
                    # two-pass CSR-direct packing (csrc bis_sb_*_csr) —
                    # no triplet materialization; analyzes/scatters BOTH
                    # triangles at once
                    try:
                        L_blk, U_blk = build_superblock_gs_pair_from_csr(
                            A, A_D_np, spec, dtype=dtype, need_d=sym)
                        if pt == PrecondType.GAUSS_SEIDEL:
                            U_blk = None
                        elif pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
                            L_blk = None
                    except BlockIneligibleError:
                        L_blk = U_blk = None
                if L_blk is None and U_blk is None:
                    if sym:
                        # blocked_sgs chains L's output into U: one layout
                        L_blk, U_blk = build_best_trisolve_pair(
                            A, A_D_np, A_D_np, colors, spec,
                            dtype=dtype, need_d=True)
                    elif pt == PrecondType.GAUSS_SEIDEL:
                        L_blk, U_blk = build_best_trisolve(
                            A, A_D_np, colors, spec, upper=False,
                            dtype=dtype), None
                    else:                 # BACKWARDS_GAUSS_SEIDEL
                        L_blk, U_blk = None, build_best_trisolve(
                            A, A_D_np, colors, spec, upper=True,
                            dtype=dtype)
                return Preconditioner(
                    A_D=A_D, A_D_inv=A_D_inv,
                    L_block=L_blk, U_block=U_blk,
                    color_spec=spec, n_colors=spec.n_colors, **kw)
            except ImproperColoringError:
                # colors invalid for this matrix — re-color for the sweeps
                from .coloring import greedy_coloring
                colors = greedy_coloring(A)
            except BlockIneligibleError:
                pass   # colors proper, layout ineligible → sweeps as-is
        if A_dev is None:
            A_dev = from_csr(A, mat_dtype, config.matrix_format,
                             config.dia_max_diags, config.dia_min_fill)
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv, A_full_dev=A_dev,
            color_arr=jnp.asarray(colors),
            n_colors=int(colors.max()) + 1, **kw)
    if pt == PrecondType.CHEBYSHEV:
        from .factor import peel_diag
        A_D_np, A_D_inv_np = peel_diag(A)
        if A_dev is None:
            A_dev = from_csr(A, mat_dtype, config.matrix_format,
                             config.dia_max_diags, config.dia_min_fill)
        A_D = jnp.asarray(A_D_np.astype(dtype))
        A_D_inv = jnp.asarray(A_D_inv_np.astype(dtype))
        lmax = _power_lmax(A_dev, A_D_inv, A.n_rows,
                           config.cheby_power_iters)
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv, A_full_dev=A_dev, cheby_lmax=lmax,
            cheby_degree=config.cheby_degree,
            cheby_ratio=config.cheby_eig_ratio, **kw)
    if factors is None:
        factors = factor_LU(A, ilu0=(pt == PrecondType.ILU0),
                            pivot_tolerance=config.ilu0_pivot_tolerance,
                            pivot_replacement=config.ilu0_pivot_replacement)
    A_D = jnp.asarray(factors.A_D.astype(dtype))
    A_D_inv = jnp.asarray(factors.A_D_inv.astype(dtype))
    if pt == PrecondType.JACOBI:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, **kw)
    if pt == PrecondType.GAUSS_SEIDEL:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            L_solve=build_trisolve(factors.L_strict, factors.A_D,
                                   upper=False, dtype=dtype), **kw)
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            U_solve=build_trisolve(factors.U_strict, factors.A_D,
                                   upper=True, dtype=dtype), **kw)
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            L_solve=build_trisolve(factors.L_strict, factors.A_D,
                                   upper=False, dtype=dtype),
            U_solve=build_trisolve(factors.U_strict, factors.A_D,
                                   upper=True, dtype=dtype), **kw)
    if pt == PrecondType.TWO_STAGE_GS:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            L_strict_dev=from_csr(factors.L_strict, mat_dtype,
                                  config.matrix_format, config.dia_max_diags,
                                  config.dia_min_fill), **kw)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            L_strict_dev=from_csr(factors.L_strict, mat_dtype,
                                  config.matrix_format, config.dia_max_diags,
                                  config.dia_min_fill),
            U_strict_dev=from_csr(factors.U_strict, mat_dtype,
                                  config.matrix_format, config.dia_max_diags,
                                  config.dia_min_fill), **kw)
    if pt == PrecondType.ILU0:
        return Preconditioner(
            A_D=A_D, A_D_inv=A_D_inv,
            L_solve=build_trisolve(factors.L_strict, factors.L_D,
                                   upper=False, dtype=dtype),
            U_solve=build_trisolve(factors.U_strict, factors.U_D,
                                   upper=True, dtype=dtype), **kw)
    raise ValueError(f"unsupported preconditioner: {pt}")


#: preconditioners whose setup/apply never needs host CSR factorization —
#: diagonal + Richardson forms, computable from on-device DIA splits alone.
DEVICE_NATIVE_PRECONDS = (PrecondType.NONE, PrecondType.JACOBI,
                          PrecondType.TWO_STAGE_GS,
                          PrecondType.SYMMETRIC_TWO_STAGE_GS,
                          PrecondType.CHEBYSHEV, PrecondType.MULTIGRID)


def _power_lmax(A_dev, A_D_inv: jax.Array, n: int, iters: int) -> jax.Array:
    """λmax estimate for B = D⁻¹A by device-side power iteration (+10%
    headroom) — the Chebyshev interval's upper end.  A_D_inv may be
    planar-encoded (halo 1.0); the iterate keeps vector halos exactly 0."""
    from .ops.spmv import spmv as _spmv
    from .stencil_op import DeviceStencil, to_planar_vec
    v = jnp.ones(n, A_D_inv.dtype)
    if (isinstance(A_dev, DeviceStencil) and A_dev.planar
            and A_D_inv.ndim == 2):
        v = to_planar_vec(A_dev, v)

    def body(_, v):
        w = A_D_inv * _spmv(A_dev, v)
        return w / jnp.sqrt(jnp.sum(w * w))

    v = jax.lax.fori_loop(0, max(1, iters), body,
                          v / jnp.sqrt(jnp.sum(v * v)))
    w = A_D_inv * _spmv(A_dev, v)
    return 1.1 * jnp.sum(v * w) / jnp.sum(v * v)


def _cheby_apply(M: Preconditioner, y: jax.Array) -> jax.Array:
    """z = p(D⁻¹A) D⁻¹ y: Chebyshev semi-iteration on A z = y from z₀ = 0
    with Jacobi scaling (the standard smoother recurrence; hypre-style).
    `cheby_degree` SpMVs + elementwise — no reductions."""
    lmax = M.cheby_lmax.astype(y.dtype)
    lmin = lmax / M.cheby_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    dinv = M.A_D_inv
    from .ops.spmv import spmv as _spmv
    rho = 1.0 / sigma
    d = (dinv * y) / theta
    z = d
    for _ in range(max(1, M.cheby_degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        resid = y - _spmv(M.A_full_dev, z)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * resid)
        z = z + d
        rho = rho_new
    return z


def setup_preconditioner_dia(A_dev, config: SolverConfig) -> Preconditioner:
    """Device-native preconditioner setup from a DeviceDIA matrix.

    The reference's factor_LU runs on host CRS
    (/root/reference/utilities/LU_factors.hpp:900-934); in DIA form the
    diagonal peel and L/U split are static row slices (dia.dia_split), so
    the diagonal-based and Richardson ("two-stage") preconditioners set up
    with zero host traffic.  The exact-triangular-solve types (gs/bgs/sgs/
    ilu0) need level scheduling over the CSR pattern — use the host path
    (setup_preconditioner) for those.
    """
    from .dia import dia_diag, dia_split
    from .stencil_op import DeviceStencil, stencil_diag_vec, stencil_split
    pt = config.preconditioner
    dtype = config.spec_dtype()
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    if pt == PrecondType.ILU0 and (
            resolve_gs_mode(config, device_native=True) == "colored"):
        # exact colored ILU(0) with ZERO host work: constant-stencil
        # factor values are translation-invariant beyond a finite
        # boundary radius, so a tiny prototype factorization gives the
        # full factor planes by device-side class gathers
        # (ops/block_trisolve.build_superblock_ilu0_pair_stencil)
        from .coloring import spec_for_device
        from .ops.block_trisolve import (BlockIneligibleError,
                                         ImproperColoringError,
                                         build_superblock_ilu0_pair_stencil)
        err = ("ILU(0) on the device-native path needs a constant-"
               "coefficient DeviceStencil with a fused-layout grid "
               "coloring and flat vectors (translation-table factors); "
               "use the host CSR path (preprocessing) otherwise")
        if not (isinstance(A_dev, DeviceStencil) and not A_dev.planar):
            raise ValueError(err)
        try:
            spec = spec_for_device(A_dev)
        except ValueError as e:
            raise ValueError(f"{err} ({e})") from e
        if spec.kind != "grid":
            raise ValueError(err)
        try:
            L_blk, U_blk = build_superblock_ilu0_pair_stencil(
                A_dev, spec, dtype=dtype,
                pivot_tolerance=config.ilu0_pivot_tolerance,
                pivot_replacement=config.ilu0_pivot_replacement)
        except (BlockIneligibleError, ImproperColoringError) as e:
            raise ValueError(f"{err} ({e})") from e
        return Preconditioner(L_block=L_blk, U_block=U_blk,
                              color_spec=spec, n_colors=spec.n_colors,
                              **kw)
    if pt not in DEVICE_NATIVE_PRECONDS and not (
            pt in COLORED_PRECONDS
            and resolve_gs_mode(config, device_native=True) == "colored"):
        raise ValueError(
            f"preconditioner {pt} needs exact triangular solves in the "
            "natural ordering (gs_mode='levels'); build through the host "
            "CSR path (preprocessing) instead")
    if pt == PrecondType.MULTIGRID:
        from .mg import build_mg_hierarchy
        levels = build_mg_hierarchy(A_dev, config)
        lev0 = levels[0]
        return Preconditioner(
            A_D=(1.0 / lev0.D_inv).astype(dtype), A_D_inv=lev0.D_inv,
            mg_data=levels,
            mg_smooth_degree=config.mg_smooth_degree,
            mg_coarse_degree=config.mg_coarse_degree,
            mg_ratio=config.mg_smooth_ratio,
            mg_coarse_ratio=config.mg_coarse_ratio,
            mg_transfer=config.mg_transfer, **kw)
    if pt == PrecondType.CHEBYSHEV:
        D = (stencil_diag_vec(A_dev) if isinstance(A_dev, DeviceStencil)
             else dia_diag(A_dev))
        if bool(jnp.any(D == 0)):
            raise ValueError("zero on the matrix diagonal")
        D = D.astype(dtype)
        D_inv = (1.0 / D).astype(dtype)
        lmax = _power_lmax(A_dev, D_inv, A_dev.n_rows,
                           config.cheby_power_iters)
        return Preconditioner(
            A_D=D, A_D_inv=D_inv, A_full_dev=A_dev, cheby_lmax=lmax,
            cheby_degree=config.cheby_degree,
            cheby_ratio=config.cheby_eig_ratio, **kw)
    if pt in COLORED_PRECONDS:
        # exact GS family as multicolor masked sweeps with the FULL
        # operator: only the diagonal is needed, and the structural
        # coloring (grid/mod) is trace-time index arithmetic
        from .coloring import spec_for_device
        try:
            spec = spec_for_device(A_dev)
        except ValueError as e:
            raise ValueError(
                f"{e}; no structural coloring exists for this matrix on the "
                "device-native path — use the host CSR path "
                "(preprocessing, gs_mode='levels') for an exact "
                "level-scheduled solve") from e
        D = (stencil_diag_vec(A_dev) if isinstance(A_dev, DeviceStencil)
             else dia_diag(A_dev))
        if bool(jnp.any(D == 0)):
            raise ValueError("zero on the matrix diagonal")
        D = D.astype(dtype)
        # matrix-free superblock upgrade: a constant-coefficient stencil's
        # strict parts ARE trace-time constants — the blocked pair builds
        # analytically (pure metadata, zero host work) and the trisolves
        # stream no factor data at all (ops/block_trisolve.py const mode).
        # Requires FLAT vectors (the rank-space permute) — gated in
        # preprocessing_device before planar conversion.
        if (isinstance(A_dev, DeviceStencil) and not A_dev.planar
                and spec.kind == "grid"):
            from .ops.block_trisolve import (
                BlockIneligibleError, build_superblock_gs_pair_stencil)
            try:
                sym = pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL
                L_blk, U_blk = build_superblock_gs_pair_stencil(
                    A_dev, spec, dtype=dtype, need_d=sym)
                if pt == PrecondType.GAUSS_SEIDEL:
                    U_blk = None
                elif pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
                    L_blk = None
                return Preconditioner(
                    A_D=D, A_D_inv=(1.0 / D).astype(dtype),
                    L_block=L_blk, U_block=U_blk, color_spec=spec,
                    n_colors=spec.n_colors, **kw)
            except BlockIneligibleError:
                pass   # masked sweeps below
        return Preconditioner(A_D=D, A_D_inv=(1.0 / D).astype(dtype),
                              A_full_dev=A_dev, color_spec=spec,
                              n_colors=spec.n_colors, **kw)
    split = stencil_split if isinstance(A_dev, DeviceStencil) else dia_split
    L_strict, U_strict, A_D, A_D_inv = split(A_dev)
    # Diagonal arrays participate in vector arithmetic — keep them at the
    # vector dtype even when matrix data is stored narrower (bf16 mode).
    if A_D.dtype != dtype:
        A_D = A_D.astype(dtype)
        A_D_inv = (1.0 / A_D).astype(dtype)
    if pt == PrecondType.JACOBI:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, **kw)
    if pt == PrecondType.TWO_STAGE_GS:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,
                              L_strict_dev=L_strict, **kw)
    return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,  # SYMMETRIC_TWO_STAGE_GS
                          L_strict_dev=L_strict, U_strict_dev=U_strict, **kw)


def _apply_once(M: Preconditioner, y: jax.Array) -> jax.Array:
    pt = M.ptype
    if pt == PrecondType.NONE:
        return y
    if pt == PrecondType.JACOBI:
        # reference: elemwise_div_vectors(output, input, A_D)  kernels.hpp:357
        return y / M.A_D
    if pt == PrecondType.CHEBYSHEV:
        return _cheby_apply(M, y)
    if pt == PrecondType.MULTIGRID:
        from .mg import mg_vcycle
        return mg_vcycle(M.mg_data, y, M.mg_smooth_degree,
                         M.mg_coarse_degree, M.mg_ratio, M.mg_coarse_ratio,
                         M.mg_transfer)
    colored = M.n_colors > 0
    blocked = M.L_block is not None or M.U_block is not None
    if blocked:
        from .ops.block_trisolve import (blocked_ilu0, blocked_sgs,
                                         blocked_trisolve)
        if pt == PrecondType.GAUSS_SEIDEL:
            return blocked_trisolve(M.L_block, y)
        if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
            return blocked_trisolve(M.U_block, y)
        if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
            return blocked_sgs(M.L_block, M.U_block, y)
        if pt == PrecondType.ILU0:
            return blocked_ilu0(M.L_block, M.U_block, y)
        raise ValueError(f"blocked data for unsupported type: {pt}")
    if pt == PrecondType.GAUSS_SEIDEL:
        if colored:
            return _colored_solve(M, y, reverse=False)
        return trisolve(M.L_solve, y)
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        if colored:
            return _colored_solve(M, y, reverse=True)
        return trisolve(M.U_solve, y)
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        if colored:
            tmp = _colored_solve(M, y, reverse=False)   # (L_c+D)⁻¹ y
            tmp = tmp * M.A_D                           # D (L_c+D)⁻¹ y
            return _colored_solve(M, tmp, reverse=True)  # (U_c+D)⁻¹ …
        tmp = trisolve(M.L_solve, y)          # (L+D)⁻¹ y
        tmp = tmp * M.A_D                     # D (L+D)⁻¹ y
        return trisolve(M.U_solve, tmp)       # (U+D)⁻¹ …
    if pt == PrecondType.TWO_STAGE_GS:
        return two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        out = two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
        out = out * M.A_D
        return two_stage_solve(M.U_strict_dev, M.A_D_inv, out, M.inner_iters)
    if pt == PrecondType.ILU0:
        if colored:
            # forward: unit-diag L solve over ascending colors (D⁻¹ = 1);
            # backward: U solve over descending colors with U_D⁻¹
            from .coloring import colored_sweep
            tmp = colored_sweep(M.L_strict_dev, 1.0, y, None, None,
                                M.color_arr, M.n_colors, reverse=False)
            return colored_sweep(M.U_strict_dev, M.A_D_inv, tmp, None, None,
                                 M.color_arr, M.n_colors, reverse=True)
        tmp = trisolve(M.L_solve, y)          # unit-diag L solve (L_D = 1)
        return trisolve(M.U_solve, tmp)
    raise ValueError(f"unsupported preconditioner: {pt}")


def _colored_solve(M: Preconditioner, y: jax.Array,
                   reverse: bool) -> jax.Array:
    """(L_c+D)⁻¹y / (U_c+D)⁻¹y as a multicolor sweep from zero — the exact
    triangular solve for the color-sorted ordering (coloring.py)."""
    from .coloring import colored_sweep
    return colored_sweep(M.A_full_dev, M.A_D_inv, y, None, M.color_spec,
                         M.color_arr, M.n_colors, reverse=reverse)


def apply_preconditioner(M: Preconditioner, y: jax.Array) -> jax.Array:
    """z ← M⁻¹ y, applied `outer_iters` times (kernels.hpp:355-404).
    TIME'd as "precond" in kernel-timing mode (reference cg.hpp:37-41)."""
    from .utils.ktimers import ktime
    return ktime("precond", _apply_outer, M, y)


def _apply_outer(M: Preconditioner, y: jax.Array) -> jax.Array:
    out = y
    for _ in range(max(1, M.outer_iters)):
        out = _apply_once(M, out)
    return out


def estimated_precond_passes(M: Preconditioner) -> float:
    """Estimated HBM cost of one apply in units of one full vector stream
    (for the roofline report; static estimate from the apply structure)."""
    k = M.inner_iters
    if M.ptype == PrecondType.MULTIGRID:
        from .mg import estimated_vcycle_passes
        return (estimated_vcycle_passes(M.mg_data, M.mg_smooth_degree,
                                        M.mg_coarse_degree)
                * max(1, M.outer_iters))
    if M.L_block is not None or M.U_block is not None:
        # blocked trisolves: each factor plane streams once + window reads
        # (~3 per (level, source) pair) + permute/vector passes
        from .ops.block_trisolve import SuperBlockTriSolve
        per = 0.0
        for B in (M.L_block, M.U_block):
            if B is None:
                continue
            if isinstance(B, SuperBlockTriSolve):
                # const mode regenerates planes from iota arithmetic — zero
                # factor traffic; only window reads + vector passes remain
                n_groups = (0 if B.is_const else
                            sum(len(c) + len(s) for _, c, s in B.levels))
                n_pairs = sum(len({s for s, _ in c})
                              for _, c, _s in B.levels)
                per += (n_groups + 3.0 * n_pairs) / B.S + 5.0
            else:
                n_pairs = sum(len({s for s, _, _ in g}) for _, g in B.levels)
                per += (len(B.vals) + 3.0 * n_pairs) / B.n_colors + 5.0
        if M.ptype == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
            per += 1.0
        return per * max(1, M.outer_iters)
    if M.n_colors > 0:
        # colored sweeps: ~(SpMV + masked update) ≈ 5 passes per color
        per_sweep = 5.0 * M.n_colors
        per = {PrecondType.GAUSS_SEIDEL: per_sweep,
               PrecondType.BACKWARDS_GAUSS_SEIDEL: per_sweep,
               PrecondType.SYMMETRIC_GAUSS_SEIDEL: 2 * per_sweep + 1,
               PrecondType.ILU0: 2 * per_sweep}[M.ptype]
        return per * max(1, M.outer_iters)
    per = {
        PrecondType.NONE: 0.0,
        PrecondType.JACOBI: 3.0,                   # read y, read D, write z
        PrecondType.GAUSS_SEIDEL: 8.0,             # level-scan gather+solve
        PrecondType.BACKWARDS_GAUSS_SEIDEL: 8.0,
        PrecondType.SYMMETRIC_GAUSS_SEIDEL: 17.0,
        PrecondType.TWO_STAGE_GS: 3.0 + 6.0 * k,   # k Richardson sweeps
        PrecondType.SYMMETRIC_TWO_STAGE_GS: 7.0 + 12.0 * k,
        PrecondType.ILU0: 16.0,
        # degree-1 SpMVs (matrix stream folded into the caller's nnz
        # accounting is NOT available here — approximate each inner
        # SpMV+residual+update as ~6 vector passes) + the first d/z pass
        PrecondType.CHEBYSHEV: 3.0 + 6.0 * max(0, M.cheby_degree - 1),
    }[M.ptype]
    return per * max(1, M.outer_iters)
