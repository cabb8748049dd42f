"""Runtime configuration.

The reference splits configuration across CMake compile-time definitions
(reference CMakeLists.txt:20-29,231-243) and a runtime CLI
(reference utilities/utilities.hpp:12-108).  JAX has no compile-time
wall, so everything collapses into one runtime dataclass; defaults replicate
the reference's CMake cache defaults exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .types import PrecondType, SolverType


@dataclasses.dataclass
class SolverConfig:
    """All solver knobs.

    Defaults mirror reference CMakeLists.txt:20-29 and
    reference common.hpp:105-111.
    """

    method: SolverType = SolverType.CONJUGATE_GRADIENT
    preconditioner: PrecondType = PrecondType.NONE

    # Reference compile-time constants (CMakeLists.txt:20-29)
    max_iters: int = 1000
    tolerance: float = 1e-14
    restart_length: int = 10          # GMRES(m); runtime '-rl' in the reference
    res_check_len: int = 1            # sample residual every k iterations
    precond_outer_iters: int = 1
    precond_inner_iters: int = 0      # Richardson sweeps in two-stage GS
    init_x_val: float = 0.1           # INIT_X_VAL
    b_val: float = 1.0                # B_VAL
    ilu0_pivot_tolerance: float = 1e-8
    ilu0_pivot_replacement: float = 1e-4

    # Runtime options (reference '-scale')
    num_scale: bool = False
    # Matrix reordering before the solve (SMAX permute_mat analog,
    # smax_helpers.hpp:44-80): "none", "bfs", "rcm", "color", "color_bal".
    # Shrinks the level count of exact triangular solves; x_star is mapped
    # back to the original ordering on output.
    perm_mode: str = "none"
    # How exact Gauss-Seidel sweeps / triangular preconditioner solves run:
    #   "levels"  — level-scheduled scan in the natural ordering (exact
    #               reference-order arithmetic; host CSR setup required);
    #   "colored" — multicolor masked sweeps (coloring.py): exact GS for the
    #               color-sorted ordering, #colors parallel SpMV+update
    #               steps, no permutation materialized.  The data-parallel
    #               form of the SMAX coloring modes; changes the sweep order
    #               (different but equally valid iteration).
    #   "auto"    — "levels" on the host-CSR setup path (reference parity),
    #               "colored" on the device-native path (where it unlocks
    #               GS/SGS at scale).
    gs_mode: str = "auto"
    # Structural coloring of the matrix (a coloring.ColorSpec), when known
    # from the matrix source (the CLI/bench derive it for generator specs;
    # generators.color_spec_for_source).  A separable grid/mod spec lets the
    # colored exact triangular solves run in BLOCKED form
    # (ops/block_trisolve.py): the color-sorted permutation is a pure
    # reshape/transpose and the factors stream once per solve instead of
    # once per color.  Ignored when perm_mode != "none" (reordering
    # invalidates the structural coloring).
    color_spec: Optional[object] = None

    # Additions with no reference analog
    dtype: np.dtype = np.float64      # fp64 = reference parity; fp32 = perf mode
    # Matrix-data storage dtype (None = same as dtype).  "bfloat16" halves
    # the SpMV HBM stream — the dominant per-iteration cost — while all
    # vector arithmetic and reductions stay in `dtype`.  Mixed-precision
    # perf mode; affects convergence like any inexact operator.
    matrix_dtype: Optional[str] = None
    # Device sparse format: "auto" picks DIA for matrices with few nonzero
    # diagonals (stencils/banded), then windowed lane-ELL (ops/lane_ell.py)
    # for general bounded-column-span sparsity, then XLA-gather ELL.
    # Explicit: "dia" | "lane_ell" | "ell" | "stencil" (generators only).
    matrix_format: str = "auto"
    # Max distinct diagonals admitted to the DIA fast path.
    dia_max_diags: int = 96
    # Minimum fill ratio nnz / (n_diags * n_rows) for DIA (bounds the
    # structural-zero overhead to ≤ 4x of nnz).
    dia_min_fill: float = 0.25
    # Auto-apply RCM when a general-sparsity matrix would otherwise fall
    # off the windowed lane-ELL format onto the plain ELL gather path:
    # bandwidth reduction restores lane-ELL eligibility for most
    # scattered patterns.  Only fires with perm_mode == "none", no
    # structural color spec, and matrix_format "auto"/"lane_ell"; the
    # solution is mapped back like any perm_mode reordering.
    auto_rcm: bool = True
    # Matrix-free stencil operators: keep solver vectors in the planar
    # halo layout ("on"; halo adds ~(1+2/ny)(1+2/nz) memory).  "auto" and
    # "off" keep flat vectors.
    planar_vectors: str = "auto"    # "auto" | "on" | "off"
    # Harness mode: "host" = host-driven loop with per-iteration timing and
    # residual sampling (reference solver_harness.hpp semantics); "fused" =
    # whole solve in one lax.while_loop on device (performance mode).
    harness: str = "host"
    # CG recurrence variant.  "classic" = the reference's PCG (cg.hpp:6-54),
    # whose (t,p) reduction sits between the SpMV and the vector updates —
    # a serialized mid-iteration sync nothing can overlap.  "pipelined" =
    # Ghysels-Vanroose pipelined PCG: auxiliary recurrences (w = A·u, plus
    # s/q/z companions) move the α/β reductions ((r,u), (w,u)) to the top
    # of the iteration on already-available vectors, so on a device mesh
    # their fused psum overlaps the iteration's SpMV/M⁻¹ instead of
    # serializing against it (the end-of-iteration stopping-test norm
    # remains, as in classic).  Costs ~2 extra vector streams per
    # iteration, so "classic" stays the single-chip default; "pipelined"
    # is the latency-bound multi-chip mode.  Same convergence up to
    # rounding (the recurrences are algebraically identical).
    cg_flavor: str = "classic"      # "classic" | "pipelined"
    # Pipelined-CG residual replacement period: every k-th iteration the
    # recurrence vectors (r, u, w and the p-companions s, q, z) are
    # recomputed from x and p directly (r = b − A·x, etc.).  The pipelined
    # recurrences drift — without replacement the attainable accuracy
    # stalls ~2-3 decades above classic CG's (a known property; Cools &
    # Vanroose), which matters at the reference's tol = 1e-14.  The
    # replacement must fire BEFORE the drift stalls the recurrence (a
    # stalled search direction p is not repaired by replacement).  The
    # primary trigger is therefore the Sleijpen/van der Vorst flying
    # restart: replace whenever the recurrence norm has dropped below
    # cg_rr_theta × (max norm since the last replacement) — the drift
    # bound scales with that max, so this fires exactly when the true and
    # recurrence residuals are about to separate (measured: a fixed
    # period 25 fires AFTER f32 drift has already poisoned p — the solve
    # then oscillates forever — while the decrease trigger replaces a
    # handful of times per solve and recovers classic behavior in both
    # f32 and f64).  cg_rr_period remains as a backstop cap for long
    # stagnation plateaus.  Amortized cost: 3 extra SpMV + 2 M⁻¹ per
    # replacement.  period 0 disables replacement entirely.
    cg_rr_period: int = 25
    cg_rr_theta: float = 0.03
    # Mixed-precision iterative refinement (--refine K; no reference
    # analog).  K > 0 wraps the configured solver in up to K outer
    # correction steps: each outer computes the TRUE float64 residual
    # r = b − A·x (device upcast, one fp64 SpMV), solves A·dx = r with the
    # configured (f32/bf16 perf-mode) solver to `refine_inner_tol` relative
    # reduction, and accumulates x += dx in float64.  Convergence is then
    # judged against the reference's fp64 criterion tol·||r0|| — i.e.
    # f64-grade final accuracy at f32 streaming rates.  Requires
    # perm_mode="none" and num_scale=False.
    refine_outer: int = 0
    refine_inner_tol: float = 1e-6
    # Breakdown-stall guard for fixed-iteration benchmark runs
    # (tolerance=0): a strong preconditioner (mg) can converge past the
    # f32 attainable floor long before max_iters, after which the CG
    # recurrence scalars divide 0/0 and the timed tail iterations are
    # NaN-poisoned (meaningless work).  With the guard, non-finite
    # alpha/beta stall to 0 — every iteration performs the identical
    # FLOPs/traffic, the state stays finite, and the explicitly computed
    # final residual stays honest.  Never enabled for convergence runs.
    breakdown_stall: bool = False
    # Chebyshev preconditioner (-p cheby; no reference analog): z = p(B)D⁻¹y
    # with B = D⁻¹A and p the degree-`cheby_degree` Chebyshev polynomial on
    # [λmax/cheby_eig_ratio, λmax] — the optimal-weight form of the
    # two-stage Richardson family, and COMMUNICATION-FREE: each apply is
    # `cheby_degree` SpMVs + elementwise, no reductions, so on a mesh M⁻¹
    # adds zero all-reduces (unlike GS/ILU0 trisolves).  λmax of B is
    # estimated at setup with `cheby_power_iters` device-side power
    # iterations (+10% headroom).  Assumes SPD A (CG-compatible: p > 0 on
    # the spectrum ⇒ M SPD).
    cheby_degree: int = 4
    cheby_eig_ratio: float = 30.0
    cheby_power_iters: int = 20
    # Geometric multigrid preconditioner (-p mg; no reference analog, mg.py):
    # one V(nu, nu) cycle over the rediscretized/Galerkin stencil hierarchy
    # with Chebyshev smoothing — CG iteration counts become grid-size-
    # independent, the decisive regime for the capacity benchmarks.
    # Requires the matrix-free stencil format (constant coefficients).
    mg_levels: int = 0                # 0 = auto (coarsen while min dim >= 8)
    mg_transfer: str = "linear"       # "linear" (full weighting) | "injection"
    mg_coarse_op: str = "auto"        # "auto" | "galerkin" | "rediscretize"
    mg_smooth_degree: int = 2         # Chebyshev degree of pre/post smoothing
    mg_coarse_degree: int = 16        # Chebyshev degree of the coarsest solve
    # Smoothing interval [lmax/mg_smooth_ratio, lmax]: the smoother only
    # damps the upper spectrum (hypre-style); the coarsest solve covers the
    # full spectrum with the wide mg_coarse_ratio interval.
    mg_smooth_ratio: float = 4.0
    mg_coarse_ratio: float = 200.0
    # GMRES orthogonalization: "mgs" = modified Gram-Schmidt, the reference's
    # scheme (gmres.hpp:6-53) — a j-deep chain of dependent dot+axpy passes;
    # "cgs2" = classical Gram-Schmidt with full re-orthogonalization — two
    # fixed-shape (m+1)×N matvec pairs (zero basis rows contribute nothing,
    # so no masking), with equivalent numerical stability; "lowsync" = CGS2
    # with the re-orthogonalization folded into an (m+1)² Gram-matrix
    # correction (h2 = (I−G)h1, G = V·Vᵀ maintained incrementally) —
    # streams the basis TWICE per iteration instead of four times.
    orthog_mode: str = "mgs"
    # GMRES basis storage dtype (None = solve dtype).  Storing V narrower
    # halves its memory stream while all small quantities (H, G, Givens)
    # stay in the solve dtype and the projections accumulate in the solve
    # dtype.  "bfloat16" with a float32 solve is the perf mode
    # (orthogonality floor ~bf16 eps — an inexact-Arnoldi trade);
    # "float32" with a float64 solve halves parity-mode traffic.
    gmres_basis_dtype: Optional[str] = None
    # Per-kernel TIME attribution (the reference's TIME(timers->spmv, ...)
    # layer, methods/cg.hpp:16-52): host harness only — iterate runs eagerly
    # (one dispatch per kernel, synchronized) so spmv/precond/dot/sum/
    # sptrsv and the GMRES orthog/least_sq/update_g sections each get wall
    # time; prints the reference's hierarchical table.  Changes performance;
    # analysis mode.
    kernel_timers: bool = False
    # Per-iteration invariant validation in the host harness (the reference's
    # Debug-build SanityChecker, common.hpp:428-530): GMRES V-orthonormality
    # and R=Q·H triangularity.  Host harness only.
    debug_checks: bool = False

    def spec_dtype(self):
        return np.dtype(self.dtype)

    def mat_dtype(self):
        """Storage dtype for device matrix data (defaults to spec_dtype)."""
        if self.matrix_dtype is None:
            return self.spec_dtype()
        if str(self.matrix_dtype) in ("bfloat16", "bf16"):
            import ml_dtypes
            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.matrix_dtype)


@dataclasses.dataclass
class Args:
    """Parsed CLI, mirroring reference Args (/root/reference/common.hpp:105-111).

    `cli.parse_cli` is the operational parser (it feeds SolverConfig
    directly); this dataclass is the stable programmatic equivalent for
    embedding callers.
    """

    matrix_source: str = ""
    method: SolverType = SolverType.CONJUGATE_GRADIENT
    preconditioner: PrecondType = PrecondType.NONE
    restart_length: int = 10
    num_scale: bool = False
    perm_mode: str = "none"
    gs_mode: str = "auto"
    # Extras with no reference analog
    dtype: str = "auto"               # auto → f32 on an accelerator, f64 on CPU
    matrix_dtype: Optional[str] = None
    harness: str = "auto"             # auto → fused on an accelerator, host on CPU
    matrix_format: str = "auto"
    orthog_mode: str = "mgs"
    gmres_basis_dtype: Optional[str] = None
    cg_flavor: str = "classic"
    cg_rr_period: int = 25
    cg_rr_theta: float = 0.03

    def to_config(self, dtype: Optional[np.dtype] = None) -> SolverConfig:
        import jax

        not_cpu = jax.default_backend() != "cpu"
        if dtype is None:
            if self.dtype == "auto":
                dtype = np.float32 if not_cpu else np.float64
            else:
                dtype = np.dtype(self.dtype)
        harness = self.harness
        if harness == "auto":
            harness = "fused" if not_cpu else "host"
        return SolverConfig(
            method=self.method,
            preconditioner=self.preconditioner,
            restart_length=self.restart_length,
            num_scale=self.num_scale,
            perm_mode=self.perm_mode,
            gs_mode=self.gs_mode,
            dtype=dtype,
            matrix_dtype=self.matrix_dtype,
            harness=harness,
            matrix_format=self.matrix_format,
            orthog_mode=self.orthog_mode,
            gmres_basis_dtype=self.gmres_basis_dtype,
            cg_flavor=self.cg_flavor,
            cg_rr_period=self.cg_rr_period,
            cg_rr_theta=self.cg_rr_theta,
        )
