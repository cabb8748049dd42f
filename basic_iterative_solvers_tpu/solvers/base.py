"""Solver framework: setup, state, harness.

Re-design of the reference's OO core (abstract Solver, solver.hpp:9-193) and
harness (solve(), solver_harness.hpp:7-61) in functional JAX style:

* `SolverSetup`   — everything preprocessing produces (device matrix,
                    preconditioner, b, x0, stopping criterion inputs);
                    the analog of preprocessing() (preprocessing.hpp:26-100).
* method objects  — per-method pure `iterate(state) -> state` plus state
                    init / residual accessors (methods/*.hpp analogs, in
                    sibling modules).
* `solve()`       — the do{iterate; sample; exchange; check_restart}while
                    loop (solver_harness.hpp:15-51).  Two modes:
                    - "host":  host-driven loop, per-iteration wall times and
                      residual sampling exactly like the reference;
                    - "fused": whole solve in one lax.while_loop on device —
                      the performance mode (no host round-trips).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverConfig
from ..factor import factor_LU, extract_scale, scale_mat
from ..matrix import MatrixCSR
from ..precond import Preconditioner, setup_preconditioner
from ..types import PrecondType, SolverType
from ..device_matrix import from_csr
from ..ops.spmv import spmv
from ..utils.timers import Timers


@dataclasses.dataclass
class SolverSetup:
    """Outputs of preprocessing (reference preprocessing.hpp:26-100)."""

    config: SolverConfig
    A: Any                       # device matrix (DIA or ELL)
    M: Preconditioner
    b: jax.Array
    x0: jax.Array
    n: int
    A_host: Optional[MatrixCSR] = None  # host oracle; None on the
                                        # device-native (DIA) setup path
    factors: Any = None          # LUFactors when the method needs them (GS)
    L_solve: Any = None          # GS-family solver data
    U_solve: Any = None
    U_strict_dev: Any = None
    L_strict_dev: Any = None
    A_D: Optional[jax.Array] = None
    scale_vec: Optional[np.ndarray] = None   # num_scale diag (D^{-1/2})
    inv_perm: Optional[np.ndarray] = None    # perm_mode inverse mapping
    x_decode: Optional[Callable] = None      # vector-layout decode (planar)
    # Multicolor GS-family solver data (coloring.py): when n_colors > 0 the
    # GS/SGS methods run masked sweeps with the full operator instead of
    # level-scheduled trisolves.
    color_spec: Any = None                   # ColorSpec (grid/mod, static)
    color_arr: Optional[jax.Array] = None    # greedy color ids
    n_colors: int = 0
    # Const-mode blocked trisolves for the GS/SGS METHODS (residual-form
    # sweeps; built analytically from constant stencils — see
    # preprocessing_device / ops/block_trisolve.py)
    gs_L_block: Any = None
    gs_U_block: Any = None

    @property
    def dtype(self):
        return self.b.dtype


def preprocessing(A: MatrixCSR, config: SolverConfig,
                  b: Optional[np.ndarray] = None,
                  x0: Optional[np.ndarray] = None,
                  timers: Optional[Timers] = None,
                  A_dev=None) -> SolverSetup:
    """Matrix + RHS + preconditioner setup.

    Mirrors reference preprocessing (preprocessing.hpp:26-100): init b/x0
    (B_VAL/INIT_X_VAL), optional symmetric diagonal scaling
    (preprocessing.hpp:39-50), L/U factorization, preconditioner setup.

    `A_dev` injects an already-built device operator for the SAME matrix in
    the SAME row ordering (e.g. a matrix-free stencil built from the
    generator source) to serve as setup.A instead of from_csr(A): the host
    CSR still drives factorization/preconditioner setup, the solve-time
    SpMV runs matrix-free.  Requires perm_mode == "none" and no numerical
    scaling (the injected operator would not reflect them).
    """
    timers = timers or Timers()
    dtype = config.spec_dtype()
    n = A.n_rows
    if A.n_rows != A.n_cols:
        raise ValueError("Matrix must be square.")
    b_host = (np.full(n, config.b_val, dtype=np.float64)
              if b is None else np.asarray(b, dtype=np.float64))
    x0_host = (np.full(n, config.init_x_val, dtype=np.float64)
               if x0 is None else np.asarray(x0, dtype=np.float64))

    scale_vec = None
    if config.num_scale:
        with timers.time("preprocessing_scale"):
            A = A.copy()
            scale_vec = extract_scale(A)
            scale_mat(A, scale_vec)
            b_host = b_host * scale_vec
            x0_host = x0_host * scale_vec

    # Matrix reordering (SMAX permute_mat analog, preprocessing.hpp:52-65):
    # solve P A Pᵀ (Px) = Pb in the permuted ordering; x_star is mapped back
    # in _finalize_x.
    inv_perm = None
    if config.perm_mode != "none":
        from ..permute import compute_permutation, permute_csr
        with timers.time("preprocessing_permute"):
            perm, inv_perm = compute_permutation(A, config.perm_mode)
            A = permute_csr(A, perm, inv_perm)
            b_host = b_host[perm]
            x0_host = x0_host[perm]
    elif (config.auto_rcm and config.color_spec is None and A_dev is None
          and config.matrix_format in ("auto", "lane_ell")
          and A.n_rows == A.n_cols and A.nnz):
        # A column span past the lane-ELL window falls to the plain ELL
        # gather.  RCM bandwidth reduction restores lane-ELL eligibility
        # for most scattered patterns; if it can't, warn instead of
        # degrading quietly.
        from ..device_matrix import (GatherFallbackWarning,
                                     auto_format_choice)
        if auto_format_choice(A, config.dia_max_diags,
                              config.dia_min_fill) == "ell":
            import sys
            import warnings
            from ..device_matrix import LANE_ELL_MAX_SPAN
            from ..ops.lane_ell import lane_ell_span
            from ..permute import compute_permutation, permute_csr
            with timers.time("preprocessing_auto_rcm"):
                perm, inv = compute_permutation(A, "rcm")
                A_rcm = permute_csr(A, perm, inv)
            if lane_ell_span(A_rcm) <= LANE_ELL_MAX_SPAN:
                print("NOTE: column span exceeds the lane-ELL window; "
                      "auto-applied RCM reordering (disable with "
                      "auto_rcm=False / -perm none stays the solve "
                      "ordering).", file=sys.stderr)
                A, inv_perm = A_rcm, inv
                b_host = b_host[perm]
                x0_host = x0_host[perm]
            else:
                warnings.warn(
                    "matrix falls back to the plain ELL gather path "
                    "(lane-ELL needs a bounded column span): column span "
                    f"{lane_ell_span(A)} > {LANE_ELL_MAX_SPAN} even after "
                    "RCM. Consider a bandwidth-reducing ordering or the "
                    "DIA/stencil formats.", GatherFallbackWarning,
                    stacklevel=2)

    from ..precond import COLORED_PRECONDS, resolve_gs_mode
    gs_colored = resolve_gs_mode(config, device_native=False) == "colored"
    ilu0_colored = (config.preconditioner == PrecondType.ILU0
                    and gs_colored)
    # colored ILU(0) factors itself w.r.t. the colored ordering and the
    # colored GS family only needs the peeled diagonal — both inside
    # setup_preconditioner; the natural-order L/U split would be pure
    # waste (a ~1.4 GB host pass at HPCG-128) unless the METHOD needs it
    precond_self_sufficient = (
        ilu0_colored
        or (config.preconditioner in COLORED_PRECONDS and gs_colored)
        # Chebyshev needs only the diagonal + the device operator
        or config.preconditioner == PrecondType.CHEBYSHEV)
    needs_factors = ((config.preconditioner != PrecondType.NONE
                      and not precond_self_sufficient)
                     or config.method in (SolverType.JACOBI,
                                          SolverType.GAUSS_SEIDEL,
                                          SolverType.SYMMETRIC_GAUSS_SEIDEL))
    factors = None
    if needs_factors:
        with timers.time("preprocessing_factor"):
            # colored ILU0 factors inside setup_preconditioner (w.r.t. the
            # colored ordering); don't compute the natural-order one too
            factors = factor_LU(
                A, ilu0=(config.preconditioner == PrecondType.ILU0
                         and not ilu0_colored),
                pivot_tolerance=config.ilu0_pivot_tolerance,
                pivot_replacement=config.ilu0_pivot_replacement)
        if config.debug_checks and config.preconditioner != PrecondType.ILU0:
            # SanityChecker::check_copied_L_U_elems analog
            # (common.hpp:532-542); ILU(0) factors have different counts
            # (unit diagonal materialized in L) by construction
            from ..utils.sanity import check_lu_split_counts
            check_lu_split_counts(A, factors.L, factors.L_strict,
                                  factors.U, factors.U_strict)

    if A_dev is not None and (config.num_scale
                              or config.perm_mode != "none"):
        raise ValueError("A_dev injection requires perm_mode='none' and "
                         "num_scale=False (the operator would not reflect "
                         "the transformed matrix)")
    with timers.time("preprocessing_device"):
        if A_dev is None:
            A_dev = from_csr(A, config.mat_dtype(), config.matrix_format,
                             config.dia_max_diags, config.dia_min_fill)
        M = setup_preconditioner(A, config, factors, A_dev=A_dev)
        setup = SolverSetup(
            config=config, A=A_dev, M=M,
            b=jnp.asarray(b_host.astype(dtype)),
            x0=jnp.asarray(x0_host.astype(dtype)),
            n=n, A_host=A, factors=factors,
            scale_vec=scale_vec, inv_perm=inv_perm,
            A_D=(jnp.asarray(factors.A_D.astype(dtype))
                 if factors is not None else None))

    # GS-family solvers need their own triangular-solve data + strict parts
    # (reference GaussSeidelSolver::iterate, methods/gauss_seidel.hpp:26-52)
    # — unless gs_mode resolves to "colored", where the masked sweeps use
    # the full operator and only need a greedy coloring (coloring.py).
    if config.method in (SolverType.GAUSS_SEIDEL,
                         SolverType.SYMMETRIC_GAUSS_SEIDEL):
        from ..precond import resolve_gs_mode
        if resolve_gs_mode(config, device_native=False) == "colored":
            from ..coloring import greedy_coloring
            with timers.time("preprocessing_coloring"):
                colors = greedy_coloring(A)
                setup.color_arr = jnp.asarray(colors)
                setup.n_colors = int(colors.max()) + 1
            return setup
        from ..ops.trisolve import build_trisolve
        with timers.time("preprocessing_levels"):
            setup.L_solve = build_trisolve(factors.L_strict, factors.A_D,
                                           upper=False, dtype=dtype)
            setup.U_strict_dev = from_csr(factors.U_strict, dtype,
                                          config.matrix_format,
                                          config.dia_max_diags,
                                          config.dia_min_fill)
            if config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL:
                setup.U_solve = build_trisolve(factors.U_strict, factors.A_D,
                                               upper=True, dtype=dtype)
                setup.L_strict_dev = from_csr(factors.L_strict, dtype,
                                              config.matrix_format,
                                              config.dia_max_diags,
                                              config.dia_min_fill)
    return setup


def preprocessing_device(A_dev, config: SolverConfig,
                         b: Optional[Any] = None,
                         x0: Optional[Any] = None,
                         timers: Optional[Timers] = None) -> SolverSetup:
    """Device-native preprocessing: the matrix is already a DeviceDIA (built
    by dia.from_source_device or converted once), and every setup step —
    diagonal peel, L/U split, scaling, preconditioner build — is static
    diagonal-row slicing on the device (dia.dia_split/dia_scale).  No host
    CSR exists, so no O(nnz) host passes and no host oracle; the explicit
    final residual is computed on device instead.

    Supports every method/preconditioner that does not need exact
    level-scheduled triangular solves (those require the CSR pattern: use
    `preprocessing`).
    """
    import jax  # noqa: F811
    import jax.numpy as jnp  # noqa: F811 (local for clarity)
    from ..dia import dia_diag, dia_extract_scale, dia_scale
    from ..precond import DEVICE_NATIVE_PRECONDS, setup_preconditioner_dia
    from ..stencil_op import (DeviceStencil, stencil_diag_vec,
                              to_planar_matrix, to_planar_vec,
                              from_planar_vec)
    is_stencil = isinstance(A_dev, DeviceStencil)

    from ..precond import COLORED_PRECONDS, resolve_gs_mode

    timers = timers or Timers()
    dtype = config.spec_dtype()
    n = A_dev.n_rows
    if A_dev.n_rows != A_dev.n_cols:
        raise ValueError("Matrix must be square.")
    colored = resolve_gs_mode(config, device_native=True) == "colored"
    # exact ILU(0) runs device-native for constant stencils under a grid
    # coloring: translation-table factors, zero host work (precond.py /
    # ops/block_trisolve.build_superblock_ilu0_pair_stencil)
    ilu0_device = False
    if (config.preconditioner == PrecondType.ILU0 and colored and is_stencil
            and not A_dev.planar):
        from ..coloring import spec_for_device
        from ..ops.block_trisolve import stencil_ilu0_eligible
        try:
            ilu0_device = stencil_ilu0_eligible(A_dev,
                                                spec_for_device(A_dev))
        except ValueError:
            pass
    if (config.preconditioner not in DEVICE_NATIVE_PRECONDS
            and not (config.preconditioner in COLORED_PRECONDS and colored)
            and not ilu0_device):
        raise ValueError(
            f"preconditioner {config.preconditioner} requires the host CSR "
            "path (exact triangular solves): use preprocessing()")
    if config.method in (SolverType.GAUSS_SEIDEL,
                         SolverType.SYMMETRIC_GAUSS_SEIDEL) and not colored:
        raise ValueError(
            f"method {config.method} requires exact triangular solves "
            "(gs_mode='levels'): use preprocessing()")
    md = config.mat_dtype()
    if A_dev.dtype != md:
        import dataclasses as _dc
        if is_stencil:
            A_dev = _dc.replace(
                A_dev, coeffs=A_dev.coeffs.astype(md),
                diag=(A_dev.diag.astype(md)
                      if A_dev.diag is not None else None))
        else:
            A_dev = _dc.replace(A_dev, data=A_dev.data.astype(md))

    b_dev = (jnp.full(n, config.b_val, dtype=dtype) if b is None
             else jnp.asarray(b, dtype=dtype))
    x0_dev = (jnp.full(n, config.init_x_val, dtype=dtype) if x0 is None
              else jnp.asarray(x0, dtype=dtype))

    # Planar-resident vectors for matrix-free stencils (planar_vectors="on";
    # see stencil_op).
    x_decode = None
    planar = config.planar_vectors
    # Matrix-free superblock GS route (const-mode blocked trisolves,
    # ops/block_trisolve.py): for constant stencils the colored GS family
    # (as preconditioner or as the GS/SGS method) runs rank-space blocked
    # solves with ZERO factor traffic — but those need FLAT vectors (the
    # rank-space permute is a reshape of the flat layout), so they win
    # over planar residency.  planar_vectors="on" keeps user control
    # (forces planar → masked sweeps).
    blocked_gs_route = False
    if is_stencil and not A_dev.planar and planar != "on" and colored:
        from ..precond import COLORED_PRECONDS as _CP
        wants_blocked = (
            config.preconditioner in _CP
            or config.preconditioner == PrecondType.ILU0
            or config.method in (SolverType.GAUSS_SEIDEL,
                                 SolverType.SYMMETRIC_GAUSS_SEIDEL))
        if wants_blocked:
            from ..coloring import spec_for_device
            from ..ops.block_trisolve import (stencil_blocked_eligible,
                                              stencil_ilu0_eligible)
            # ILU(0) planes work in BOTH kernel layouts (split-parity
            # covers any nx, e.g. 384³); const-mode GS needs fused
            elig = (stencil_ilu0_eligible
                    if config.preconditioner == PrecondType.ILU0
                    else stencil_blocked_eligible)
            try:
                blocked_gs_route = elig(A_dev, spec_for_device(A_dev))
            except ValueError:
                pass
    if (is_stencil and not A_dev.planar and not blocked_gs_route
            and planar == "on"):
        A_dev = to_planar_matrix(A_dev)
        b_dev = to_planar_vec(A_dev, b_dev)
        x0_dev = to_planar_vec(A_dev, x0_dev)
        A_for_decode = A_dev
        x_decode = lambda x: np.asarray(  # noqa: E731
            from_planar_vec(A_for_decode, jnp.asarray(x)))

    scale_vec = None
    if config.num_scale:
        if is_stencil:
            raise ValueError(
                "num_scale breaks the constant-coefficient structure; use "
                "the DIA format (matrix_format='dia') for scaled solves")
        with timers.time("preprocessing_scale"):
            scale_vec = dia_extract_scale(A_dev)
            A_dev = dia_scale(A_dev, scale_vec)
            b_dev = b_dev * scale_vec
            x0_dev = x0_dev * scale_vec

    with timers.time("preprocessing_device"):
        M = setup_preconditioner_dia(A_dev, config)
        diag_of = stencil_diag_vec if is_stencil else dia_diag
        A_D = (M.A_D if M.A_D is not None
               else diag_of(A_dev).astype(dtype))
        setup = SolverSetup(config=config, A=A_dev, M=M, b=b_dev, x0=x0_dev,
                            n=n, A_host=None, scale_vec=scale_vec, A_D=A_D,
                            x_decode=x_decode)
        if config.method in (SolverType.GAUSS_SEIDEL,
                             SolverType.SYMMETRIC_GAUSS_SEIDEL):
            from ..coloring import spec_for_device
            try:
                setup.color_spec = spec_for_device(A_dev)
            except ValueError as e:
                raise ValueError(
                    f"{e}; no structural coloring exists for this matrix on "
                    "the device-native path — use the host CSR path "
                    "(preprocessing, gs_mode='levels') for an exact "
                    "level-scheduled solve") from e
            setup.n_colors = setup.color_spec.n_colors
            if blocked_gs_route:
                # residual-form sweeps through the const-mode blocked
                # trisolves: x ← x + M⁻¹(b − Ax) with M the exact GS/SGS
                # operator of the colored ordering — same math as the
                # masked sweeps, zero factor traffic
                from ..ops.block_trisolve import (
                    build_superblock_gs_pair_stencil)
                sym = config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL
                L_blk, U_blk = build_superblock_gs_pair_stencil(
                    A_dev, setup.color_spec, dtype=dtype, need_d=sym)
                setup.gs_L_block = L_blk
                setup.gs_U_block = U_blk if sym else None
        return setup


def _f64_operands(setup: SolverSetup):
    """(A_dec, A64, b64) for the device-side fp64 oracle: the original
    (possibly planar) operator for vector decode/encode, the float64
    flat-path operator, and the flat float64 right-hand side.  Cached on
    the setup — the upcasts are one-time device work."""
    cached = getattr(setup, "_f64_ops_cache", None)
    if cached is not None:
        return cached
    import dataclasses as _dc
    from ..stencil_op import DeviceStencil, from_planar_vec
    A = setup.A
    if isinstance(A, DeviceStencil):
        A64 = A
        if A.planar:
            # the f64 evaluation runs on the flat path
            A64 = _dc.replace(
                A64, planar=False,
                diag=None if A.diag is None else from_planar_vec(A, A.diag))
        A64 = _dc.replace(
            A64, coeffs=A64.coeffs.astype(jnp.float64),
            diag=None if A64.diag is None else A64.diag.astype(jnp.float64))
    else:
        A64 = _dc.replace(A, data=A.data.astype(jnp.float64))
    b = setup.b
    if isinstance(A, DeviceStencil) and b.ndim == 2:
        b = from_planar_vec(A, b)
    b64 = b.astype(jnp.float64)
    setup._f64_ops_cache = (A, A64, b64)
    return A, A64, b64


def _resid64_runner(setup: SolverSetup):
    """Build (once per setup) the jitted fp64 residual evaluator for the
    device path: returns `run(x) -> r64` with the f64 operator and b held
    as DEVICE constants passed as jit ARGUMENTS (closure constants of
    large arrays get re-staged per dispatch).  One dispatch per
    evaluation instead of one per op."""
    cached = getattr(setup, "_resid64_cache", None)
    if cached is not None:
        return cached
    from ..stencil_op import from_planar_vec
    A, A64, b64 = _f64_operands(setup)

    @jax.jit
    def _eval(A_dec, A_op, b_op, x):
        # straight to float64: casting x through the solve dtype would
        # round away exactly the fp64 correction accuracy refinement
        # accumulates
        if x.ndim == 2:            # planar-resident vectors are 2-D
            x = from_planar_vec(A_dec, x)
        return b_op - spmv(A_op, x.astype(jnp.float64))

    def run(x):
        return _eval(A, A64, b64, jnp.asarray(x))

    setup._resid64_cache = run
    return run


def _refine_device_runner(setup: SolverSetup):
    """(start, step) jits for the device-resident refinement outer loop.

    start(x0_encoded) -> (x64_flat, rn, b_inner_encoded)
    step(x64, x_inner_encoded_or_flat, r_scale) -> (x64', rn', b_inner')

    Each is ONE dispatch folding decode + fp64 correction + true residual
    + norm + next-RHS unit-scaling/encode, with no per-outer vector
    transfer to or from the host."""
    cached = getattr(setup, "_refine_dev_cache", None)
    if cached is not None:
        return cached
    from ..stencil_op import DeviceStencil, from_planar_vec, to_planar_vec
    A, A64, b64 = _f64_operands(setup)
    dtype = setup.config.spec_dtype()
    planar_vecs = (isinstance(setup.A, DeviceStencil) and setup.A.planar
                   and setup.b.ndim == 2)

    def _encode(A_dec, v):
        v = v.astype(dtype)
        if planar_vecs:
            v = to_planar_vec(A_dec, v)
        return v

    def _resid_norm_rhs(A_dec, A_op, b_op, x64):
        r = b_op - spmv(A_op, x64)
        rn = jnp.linalg.norm(r)
        # unit-scaled next RHS: every inner solve runs in the same
        # numerical regime regardless of accumulated decades (see
        # _solve_refined); rn == 0 → NaN b, but the caller's convergence
        # check reads rn first and never dispatches on that b
        return rn, _encode(A_dec, r / rn)

    @jax.jit
    def _start(A_dec, A_op, b_op, x0):
        if x0.ndim == 2:
            x0 = from_planar_vec(A_dec, x0)
        x64 = x0.astype(jnp.float64)
        rn, b_i = _resid_norm_rhs(A_dec, A_op, b_op, x64)
        return x64, rn, b_i

    @jax.jit
    def _step(A_dec, A_op, b_op, x64, x_inner, r_scale):
        xi = x_inner
        if xi.ndim == 2:
            xi = from_planar_vec(A_dec, xi)
        x_next = x64 + r_scale * xi.astype(jnp.float64)
        rn, b_i = _resid_norm_rhs(A_dec, A_op, b_op, x_next)
        return x_next, rn, b_i

    def start(x0):
        return _start(A, A64, b64, x0)

    def step(x64, x_inner, r_scale):
        return _step(A, A64, b64, x64, jnp.asarray(x_inner), r_scale)

    setup._refine_dev_cache = (start, step)
    return start, step


def residual_f64(setup: SolverSetup, x: np.ndarray) -> np.ndarray:
    """Flat float64 residual b − A·x in solve coordinates (x flat or
    planar-encoded).  The fp64 oracle behind the final report and the
    mixed-precision refinement driver: host CSR when retained, else the
    device operator upcast to f64."""
    if setup.A_host is not None:
        return (np.asarray(setup.b, dtype=np.float64)
                - setup.A_host.spmv(np.asarray(x, dtype=np.float64)))
    return np.asarray(_resid64_runner(setup)(x))


def explicit_residual_norm(setup: SolverSetup, x_star: np.ndarray) -> float:
    """||b − A·x*||₂ for the final report (save_x_star analog,
    reference solver.hpp:153-159).  Uses the fp64 host oracle when a
    host CSR is retained; on the device-native path it upcasts x*/b/A to
    float64 for this one evaluation so the reported residual matches the
    reference's fp64 accounting even in f32/bf16 perf modes."""
    return float(np.linalg.norm(residual_f64(setup, x_star)))


def finalize_x(setup: SolverSetup, x_star: np.ndarray) -> np.ndarray:
    """Map the solution back to user coordinates: decode the vector layout
    (planar-resident stencil), then invert the perm_mode permutation."""
    if setup.x_decode is not None:
        x_star = setup.x_decode(x_star)
    if setup.inv_perm is not None:
        return x_star[setup.inv_perm]
    return x_star


@dataclasses.dataclass
class SolveResult:
    """Postprocessing inputs (reference postprocessing.hpp:33-68 fields)."""

    x_star: np.ndarray
    iter_count: int
    converged: bool
    stopping_criteria: float
    residual_norms: np.ndarray        # sampled ||r|| history
    time_per_iteration: np.ndarray    # seconds per sampled iteration
    final_residual_norm: float        # explicit ||b - A x_star||
    gmres_restart_count: int = 0
    method: Optional[SolverType] = None
    preconditioner: Optional[PrecondType] = None
    restart_length: int = 0
    res_check_len: int = 1
    solve_seconds: float = 0.0
    #: fused-harness runs record the solve-average per iteration, not
    #: measured per-iteration walls (the loop is one device dispatch)
    uniform_iteration_times: bool = False
    #: mixed-precision refinement: number of outer fp64 correction steps
    #: actually taken (0 = plain solve)
    refine_outer_count: int = 0


def _stopping(config: SolverConfig, r0_norm: float) -> float:
    """stopping_criteria = tol * ||b - A x0||_2 (solver.hpp:173-175)."""
    return config.tolerance * r0_norm


def solve(setup: SolverSetup, method=None, timers: Optional[Timers] = None,
          progress: Optional[Callable[[int, float], None]] = None) -> SolveResult:
    """Run the solver harness."""
    if setup.config.refine_outer > 0:
        if _refine_fused_eligible(setup):
            return _solve_refined_fused(setup, timers or Timers())
        return _solve_refined(setup, timers or Timers())
    from .factory import make_method
    method = method or make_method(setup)
    if setup.config.harness == "fused" and method.supports_fused:
        return method.solve_fused()
    return _solve_host(setup, method, timers or Timers(), progress)


def _refine_fused_eligible(setup: SolverSetup) -> bool:
    """Whole-refinement single-dispatch path: device oracle, fused
    harness, classic-CG or GMRES(m) inner (the restart machinery nests as
    a cycle-structured while inside the outer loop; BiCGSTAB keeps the
    per-outer path — its NaN-breakdown retry ladder needs host control)."""
    cfg = setup.config
    method_ok = ((cfg.method == SolverType.CONJUGATE_GRADIENT
                  and cfg.cg_flavor == "classic")
                 or cfg.method == SolverType.GMRES)
    return (setup.A_host is None and cfg.harness == "fused" and method_ok
            and setup.inv_perm is None and setup.scale_vec is None)


def _build_refined_fused(setup: SolverSetup):
    """ONE jitted program for the whole mixed-precision refinement: an
    outer lax.while_loop over fp64 correction steps, each nesting the
    inner f32/bf16 CG as its own while_loop.  The per-outer Python loop
    costs a few host round-trips per outer; this path is exactly one
    dispatch for the entire solve.

    Semantics match _solve_refined's loop: unit-scaled inner RHS, keep
    the best iterate when a correction regresses (NaN compares false →
    same stop), stagnation break when an outer gains < 2×, convergence
    at tol·‖r₀‖ on the TRUE fp64 residual."""
    import dataclasses as _dc
    from .factory import make_method
    from ..stencil_op import DeviceStencil, from_planar_vec, to_planar_vec
    cfg = setup.config
    A_dec, A64, b64 = _f64_operands(setup)
    dtype = cfg.spec_dtype()
    planar_vecs = (isinstance(setup.A, DeviceStencil) and setup.A.planar
                   and setup.b.ndim == 2)
    K = cfg.refine_outer
    inner_tol = float(cfg.refine_inner_tol)
    inner_max = cfg.max_iters
    x0_inner = jnp.zeros_like(setup.x0)
    inner_cfg = _dc.replace(cfg, refine_outer=0,
                            tolerance=cfg.refine_inner_tol)

    def _encode(v):
        v = v.astype(dtype)
        if planar_vecs:
            v = to_planar_vec(setup.A, v)
        return v

    def _decode(v):
        if v.ndim == 2:
            v = from_planar_vec(setup.A, v)
        return v

    def _resid_rn(x64):
        r = b64 - spmv(A64, x64)
        return r, jnp.linalg.norm(r)

    def _inner_solve(b_unit):
        setup_t = _dc.replace(setup, config=inner_cfg, b=b_unit,
                              x0=x0_inner)
        method = make_method(setup_t)
        state0 = method.init_state()
        rn0 = method.initial_residual_norm(state0)
        stop = inner_tol * rn0
        restart_fn = getattr(method, "_restart_state", None)
        m = getattr(method, "m", None)

        if restart_fn is None:
            def cond(c):
                _s, it, rn = c
                return jnp.logical_and(it < inner_max, rn > stop)

            def body(c):
                s, it, rn = c
                s2 = method.iterate(s)
                return s2, it + jnp.int32(1), method.sample_norm(s2)

            state, it, _rn = jax.lax.while_loop(
                cond, body, (state0, jnp.int32(0), rn0))
            return method.final_x(state), it

        # restarted inner (GMRES(m)): the FusedRunner cycle structure —
        # an outer while over restart cycles nesting a ≤ m-iteration
        # inner while, restart (explicit x, Krylov reset) once per
        # completed unconverged cycle (solvers/fused.py run()).
        def outer_cond(c):
            _s, it, rn, restarts = c
            return ((rn > stop) & (it < inner_max - restarts)
                    & jnp.isfinite(rn))

        def outer_body(c):
            state, it, rn, restarts = c

            def inner_cond(ci):
                _s, it, rn, j = ci
                return ((j < m) & (rn > stop)
                        & (it < inner_max - restarts) & jnp.isfinite(rn))

            def inner_body(ci):
                s, it, rn, j = ci
                s2 = method.iterate(s)
                return (s2, it + jnp.int32(1), method.sample_norm(s2),
                        j + jnp.int32(1))

            state, it, rn, j = jax.lax.while_loop(
                inner_cond, inner_body, (state, it, rn, jnp.int32(0)))
            do = (j == m) & (rn > stop) & jnp.isfinite(rn)
            state = jax.lax.cond(do, restart_fn, lambda s: s, state)
            rn = jnp.where(do, state["residual_norm"], rn)
            return state, it, rn, restarts + do.astype(jnp.int32)

        state, it, _rn, _restarts = jax.lax.while_loop(
            outer_cond, outer_body,
            (state0, jnp.int32(0), rn0, jnp.int32(0)))
        return method.final_x(state), it

    @jax.jit
    def _run():
        x64_0 = _decode(setup.x0).astype(jnp.float64)
        _r0, rn0 = _resid_rn(x64_0)
        stopping = cfg.tolerance * rn0
        r0_unit = _encode(_r0 / rn0)
        hist0 = jnp.zeros(K + 1, dtype=jnp.float64).at[0].set(rn0)

        def cond(c):
            return jnp.logical_and(c["go"], c["k"] < K)

        def body(c):
            xi, it = _inner_solve(c["b_unit"])
            x_next = c["x"] + c["r_scale"] * _decode(xi).astype(jnp.float64)
            r2, rn2 = _resid_rn(x_next)
            # NaN rn2 compares False → treated as a regression: stop and
            # keep the best iterate (the loop path's retry ladder is a
            # BiCGSTAB-class need; CG+strong-M never trips it)
            improved = rn2 <= c["rn"]
            k2 = c["k"] + jnp.int32(1)
            hist = c["hist"].at[jnp.where(improved, c["n_hist"],
                                          jnp.int32(K))].set(rn2)
            go = jnp.logical_and(
                improved,
                jnp.logical_and(rn2 > stopping, rn2 <= 0.5 * c["rn"]))
            return {
                "x": jnp.where(improved, x_next, c["x"]),
                "rn": jnp.where(improved, rn2, c["rn"]),
                "b_unit": _encode(r2 / rn2),
                "r_scale": rn2,
                "k": k2,
                "n_hist": c["n_hist"] + improved.astype(jnp.int32),
                "it_tot": c["it_tot"] + it,
                "hist": hist,
                "go": go,
            }

        c0 = {"x": x64_0, "rn": rn0, "b_unit": r0_unit, "r_scale": rn0,
              "k": jnp.int32(0), "n_hist": jnp.int32(1),
              "it_tot": jnp.int32(0), "hist": hist0,
              "go": rn0 > stopping}
        c = jax.lax.while_loop(cond, body, c0)
        return (c["x"], c["rn"], c["k"], c["n_hist"], c["it_tot"],
                c["hist"], stopping)

    return _run


def _solve_refined_fused(setup: SolverSetup, timers: Timers) -> SolveResult:
    """Whole-refinement single-dispatch driver (see _build_refined_fused)."""
    import time as _time
    cfg = setup.config
    runner = getattr(setup, "_refine_fused_cache", None)
    if runner is None:
        runner = _build_refined_fused(setup)
        setup._refine_fused_cache = runner
        jax.block_until_ready(runner())     # compile outside the timing
    t0 = _time.perf_counter()
    x, rn, k, n_hist, it_tot, hist, stopping = jax.block_until_ready(
        runner())
    dt = _time.perf_counter() - t0
    n_hist = int(n_hist)
    outer_norms = np.asarray(hist)[:n_hist]
    final_norm = float(rn)
    return SolveResult(
        x_star=np.asarray(x), iter_count=int(it_tot),
        converged=final_norm <= float(stopping),
        stopping_criteria=float(stopping),
        residual_norms=outer_norms,
        time_per_iteration=np.full(n_hist, dt / max(1, n_hist)),
        final_residual_norm=final_norm,
        gmres_restart_count=0, method=cfg.method,
        preconditioner=cfg.preconditioner,
        restart_length=cfg.restart_length, res_check_len=cfg.res_check_len,
        solve_seconds=dt, uniform_iteration_times=True,
        refine_outer_count=int(k))


def _solve_refined(setup: SolverSetup, timers: Timers) -> SolveResult:
    """Mixed-precision iterative refinement (config.refine_outer > 0).

    Classic Wilkinson refinement around the configured solver: the inner
    solves run at the perf dtype (f32/bf16 matrix) to a modest relative
    reduction, while the outer loop computes the TRUE float64 residual and
    accumulates the correction in float64 — so the reference's fp64
    stopping criterion tol·||b − A·x₀|| (solver.hpp:173-175) is reachable
    at f32 streaming rates.  No reference analog (the reference is fp64
    throughout)."""
    import dataclasses as _dc
    import time as _time
    cfg = setup.config
    if setup.inv_perm is not None or setup.scale_vec is not None:
        raise ValueError(
            "iterative refinement requires perm_mode='none' and "
            "num_scale=False (corrections accumulate in solve coordinates)")
    from ..stencil_op import DeviceStencil, to_planar_vec
    planar_vecs = (isinstance(setup.A, DeviceStencil) and setup.A.planar
                   and setup.b.ndim == 2)

    import math as _math
    t0 = _time.perf_counter()
    dtype = cfg.spec_dtype()
    # The outer loop works through two fused primitives so that on the
    # device path NOTHING but scalars ever crosses the host boundary:
    #   start(x0)            -> (x64, ||r0||, b_inner_0)
    #   step(x64, xi, scale) -> (x64', ||r'||, b_inner')
    # where b_inner is the UNIT-SCALED next correction RHS r/‖r‖ (every
    # inner solve runs in the same numerical regime regardless of decades
    # gained — an unscaled ~1e-8 RHS drives f32 recurrences into denormal
    # squares and BiCGSTAB-class rho/omega divisions into NaN) and x64
    # accumulates corrections dx = ‖r‖·dx' in flat float64.
    if setup.A_host is None:
        start, step = _refine_device_runner(setup)
    else:
        # host-CSR oracle (numpy fp64 SpMV)
        def _encode_h(v64):
            b_i = jnp.asarray(v64.astype(np.dtype(dtype)))
            if planar_vecs:
                b_i = to_planar_vec(setup.A, b_i)
            return b_i

        def start(x0):
            x64 = np.asarray(
                setup.x_decode(x0) if setup.x_decode is not None else x0,
                dtype=np.float64)
            r = residual_f64(setup, x0)
            rn = float(np.linalg.norm(r))
            return x64, rn, (None if rn == 0.0 else _encode_h(r / rn))

        def step(x64, x_inner, r_scale):
            x_next = x64 + float(r_scale) * np.asarray(x_inner,
                                                       dtype=np.float64)
            r = residual_f64(setup, x_next)
            rn = float(np.linalg.norm(r))
            return x_next, rn, (None if rn == 0.0 else _encode_h(r / rn))

    x, rn0, b_next = start(setup.x0)
    r0_norm = float(rn0)
    stopping = _stopping(cfg, r0_norm)

    inner_cfg = _dc.replace(cfg, refine_outer=0,
                            tolerance=cfg.refine_inner_tol)
    total_iters = 0
    outer_norms = [r0_norm]
    restarts = 0
    iters_dev = []      # device-path (iters, restarts) scalars: sync once
    converged = r0_norm <= stopping
    outers = 0
    prev_rn = r0_norm
    r_scale = rn0       # stays a device scalar on the device path
    x0_inner = jnp.zeros_like(setup.x0)   # one object: stays a shared const
    # Re-solves of the SAME setup (benchmark repeats) reuse the compiled
    # inner method too — without this every solve() call re-traces once
    cached = getattr(setup, "_refine_cache", None)
    method_k = cached[1] if (cached is not None and cached[0] is cfg) else None
    for _ in range(cfg.refine_outer):
        if converged or b_next is None:
            break
        # Only b changes between outers.  Re-point the already-compiled
        # fused runner at the new RHS (FusedRunner.rebind_b) instead of
        # rebuilding the method: a rebuild re-traces and re-lowers the
        # whole while-loop every outer.
        runner = getattr(method_k, "_fused_runner", None)
        if runner is not None and runner.rebind_b(b_next):
            method_k.setup = runner.setup
            # device fast path: solve + correction step all enqueue
            # without a sync; float(rn) below drains the whole chain
            x_inner, it_dev, rs_dev = runner.run_device()
            iters_dev.append((it_dev, rs_dev))
        else:
            setup_k = _dc.replace(setup, config=inner_cfg, b=b_next,
                                  x0=x0_inner)
            from .factory import make_method
            method_k = make_method(setup_k)
            last = solve(method_k.setup, method=method_k)
            total_iters += last.iter_count
            restarts += last.gmres_restart_count
            x_inner = last.x_star
        outers += 1
        x_try, rn_dev, b_try = step(x, x_inner, r_scale)
        rn = float(rn_dev)
        while not _math.isfinite(rn):
            # the inner recurrence broke down with NaN when driven past
            # its attainable floor (f32 BiCGSTAB's rho/omega divisions do
            # this below ~1e-6 relative) — retry THIS outer with the
            # inner tolerance loosened 100x; refinement squares the outer
            # contraction anyway, so a 1e-2 inner still converges, just
            # with more outers
            tol_now = float(inner_cfg.tolerance)
            if tol_now >= 1e-2:
                rn = None               # give up: keep the last good x
                break
            inner_cfg = _dc.replace(inner_cfg,
                                    tolerance=min(1e-2, tol_now * 100.0))
            setup_k = _dc.replace(setup, config=inner_cfg, b=b_next,
                                  x0=x0_inner)
            from .factory import make_method
            method_k = make_method(setup_k)
            last = solve(method_k.setup, method=method_k)
            total_iters += last.iter_count
            restarts += last.gmres_restart_count
            x_try, rn_dev, b_try = step(x, last.x_star, r_scale)
            rn = float(rn_dev)
        if rn is None:
            break
        if rn > prev_rn:
            # the correction made the TRUE residual worse: we are at the
            # fp64 attainable floor eps·‖A‖·‖x‖ (measured: outers wiggle
            # ±5% there forever) — keep the previous, better x and stop
            break
        x, b_next, r_scale = x_try, b_try, rn_dev
        outer_norms.append(rn)
        converged = rn <= stopping
        if not converged and rn > 0.5 * prev_rn:
            # contraction is dead (healthy outers gain 5-6 decades each);
            # further outers would burn device time at the floor
            break
        prev_rn = rn
    for it_dev, rs_dev in iters_dev:
        total_iters += int(it_dev)
        restarts += int(rs_dev)
    if method_k is not None:
        setup._refine_cache = (cfg, method_k)
    final_norm = outer_norms[-1]
    dt = _time.perf_counter() - t0
    n_hist = len(outer_norms)
    return SolveResult(
        x_star=np.asarray(x), iter_count=total_iters, converged=converged,
        stopping_criteria=stopping,
        residual_norms=np.asarray(outer_norms),
        time_per_iteration=np.full(n_hist, dt / max(1, n_hist)),
        final_residual_norm=final_norm,
        gmres_restart_count=restarts, method=cfg.method,
        preconditioner=cfg.preconditioner,
        restart_length=cfg.restart_length, res_check_len=cfg.res_check_len,
        solve_seconds=dt, uniform_iteration_times=True,
        refine_outer_count=outers)


def _solve_host(setup: SolverSetup, method, timers: Timers,
                progress=None) -> SolveResult:
    """Host-driven loop replicating solver_harness.hpp:15-51 semantics,
    including per-iteration wall-clock capture and milestone reporting."""
    config = setup.config
    state = method.init_state()
    r0_norm = float(method.initial_residual_norm(state))
    stopping = _stopping(config, r0_norm)

    max_hist = config.max_iters * 2 + 2
    norms = np.zeros(max_hist)
    times = np.zeros(max_hist)
    norms[0] = r0_norm
    hist_count = 1

    if config.kernel_timers:
        # per-kernel TIME attribution: run eagerly, one synchronized
        # dispatch per instrumented kernel (utils/ktimers.py)
        from ..utils import ktimers
        ktimers.activate(timers)
        iterate = method.iterate
        sample_norm = method.sample_norm
    else:
        iterate = jax.jit(method.iterate)
        sample_norm = jax.jit(method.sample_norm)

    iter_count = 0
    restart_count = 0
    residual_norm = r0_norm
    res_milestones = {1e-3: False, 1e-6: False}
    t_solve0 = time.perf_counter()

    debug_check = (getattr(method, "debug_check", None)
                   if config.debug_checks else None)

    try:
        while True:
            t0 = time.perf_counter()
            state = iterate(state)
            iter_count += 1
            if debug_check is not None:
                debug_check(state, iter_count)
            if iter_count % config.res_check_len == 0:
                rn = sample_norm(state)
                residual_norm = float(jax.block_until_ready(rn))
                norms[hist_count] = residual_norm
                times[hist_count] = time.perf_counter() - t0
                hist_count += 1
            for thresh in res_milestones:
                if (residual_norm / r0_norm < thresh
                        and not res_milestones[thresh]):
                    res_milestones[thresh] = True
                    if progress:
                        progress(iter_count, residual_norm)
            # GMRES restart (check_restart, gmres.hpp:388-415); others no-op.
            state, restarted, restart_norm = method.check_restart(
                state, iter_count, residual_norm, stopping)
            if restarted:
                restart_count += 1
                residual_norm = restart_norm
                norms[hist_count] = restart_norm
                times[hist_count] = time.perf_counter() - t0
                hist_count += 1
            # check_stopping_criteria (solver.hpp:177-191)
            diverged = not np.isfinite(residual_norm)
            over_max = iter_count >= (config.max_iters - restart_count)
            if abs(residual_norm) < stopping or over_max or diverged:
                break
    finally:
        # an exception mid-solve (divergence assert, debug_check) must not
        # leave the global kernel-timer registry active for later solves
        if config.kernel_timers:
            from ..utils import ktimers
            ktimers.activate(None)
    solve_seconds = time.perf_counter() - t_solve0

    converged = residual_norm < stopping
    x_star = np.asarray(jax.block_until_ready(method.final_x(state)))
    # save_x_star: record the explicit final residual (solver.hpp:153-159);
    # computed in the solve ordering, then mapped back to the user's.
    final_norm = explicit_residual_norm(setup, x_star)
    x_star = finalize_x(setup, x_star)
    norms[hist_count] = final_norm
    hist_count += 1

    return SolveResult(
        x_star=x_star, iter_count=iter_count, converged=converged,
        stopping_criteria=stopping,
        residual_norms=norms[:hist_count],
        time_per_iteration=times[:hist_count],
        final_residual_norm=final_norm,
        gmres_restart_count=restart_count,
        method=config.method, preconditioner=config.preconditioner,
        restart_length=config.restart_length,
        res_check_len=config.res_check_len,
        solve_seconds=solve_seconds)
