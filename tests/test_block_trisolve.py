"""Blocked multicolor trisolve (ops/block_trisolve.py).

Oracle: dense color-order triangular solves — the blocked form must equal
the sequential solve in the color-sorted ordering exactly (same math as the
masked colored sweeps, reference sptrsv/bsptrsv semantics in the colored
ordering, /root/reference/kernels.hpp:54-117).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.coloring import (ColorSpec, colors_to_perm,
                                                  mod_color_spec)
from basic_iterative_solvers_tpu.ops.block_trisolve import (
    BlockIneligibleError, blocked_ilu0, blocked_sgs, blocked_trisolve,
    build_blocked_trisolve, permute_blocks, spec_colors_np, unpermute_blocks)
from basic_iterative_solvers_tpu.precond import (apply_preconditioner,
                                                 setup_preconditioner)


def _dense(A):
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    Ad = np.zeros((A.n_rows, A.n_cols))
    Ad[rows, A.col] = A.val
    return Ad


def _diag(A):
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    D = np.zeros(A.n_rows)
    sel = A.col == rows
    D[rows[sel]] = A.val[sel]
    return D


CASES = [
    ("hpcg:6x4x8", ColorSpec("grid", 8, (6, 4, 8, 2, 2, 2))),
    ("fdm:6", ColorSpec("grid", 4, (6, 6, 1, 2, 2, 1))),
    ("band:61,2", mod_color_spec([1, 2], 61)),   # ragged mod blocks
]


@pytest.mark.parametrize("src,spec", CASES, ids=[c[0] for c in CASES])
def test_blocked_solves_match_dense_oracle(src, spec, rng):
    A = bis.generators.from_source(src)
    n = A.n_rows
    colors = spec_colors_np(spec, n)
    D = _diag(A)
    perm, _ = colors_to_perm(colors)
    Ap = _dense(A)[np.ix_(perm, perm)]
    Dp = np.diag(np.diag(Ap))
    y = rng.standard_normal(n)

    L = build_blocked_trisolve(A, D, colors, spec, upper=False,
                               dtype=np.float64, need_d=True)
    U = build_blocked_trisolve(A, D, colors, spec, upper=True,
                               dtype=np.float64)

    # round trip of the block permutation
    rt = np.asarray(unpermute_blocks(L, permute_blocks(L, jnp.asarray(y))))
    np.testing.assert_array_equal(rt, y)

    x_ref_p = np.linalg.solve(np.tril(Ap, -1) + Dp, y[perm])
    x_ref = np.empty(n)
    x_ref[perm] = x_ref_p
    x = np.asarray(blocked_trisolve(L, jnp.asarray(y)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)

    u_ref_p = np.linalg.solve(np.triu(Ap, 1) + Dp, y[perm])
    u_ref = np.empty(n)
    u_ref[perm] = u_ref_p
    u = np.asarray(blocked_trisolve(U, jnp.asarray(y)))
    np.testing.assert_allclose(u, u_ref, rtol=1e-12, atol=1e-12)

    sgs_ref_p = np.linalg.solve(np.triu(Ap, 1) + Dp, Dp @ x_ref_p)
    sgs_ref = np.empty(n)
    sgs_ref[perm] = sgs_ref_p
    z = np.asarray(blocked_sgs(L, U, jnp.asarray(y)))
    np.testing.assert_allclose(z, sgs_ref, rtol=1e-12, atol=1e-12)


SUPER_CASES = [
    "hpcg:4x6x8",     # nx=4 divides 128; ny=6, nz=8 with strides 2
    "hpcg:8x8x8",
    "fdm:8",
    "hpcg:6x4x8",     # nx=6 does NOT divide 128 → split-parity mode
]


@pytest.mark.parametrize("src", SUPER_CASES)
def test_superblock_matches_dense_oracle(src, rng):
    from basic_iterative_solvers_tpu.ops.block_trisolve import (
        SuperBlockTriSolve, _permute_super, _unpermute_super,
        build_superblock_trisolve)
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    n = A.n_rows
    colors = spec_colors_np(spec, n)
    D = _diag(A)
    perm, _ = colors_to_perm(colors)
    Ap = _dense(A)[np.ix_(perm, perm)]
    Dp = np.diag(np.diag(Ap))
    y = rng.standard_normal(n)

    L = build_superblock_trisolve(A, D, colors, spec, upper=False,
                                  dtype=np.float64, need_d=True)
    U = build_superblock_trisolve(A, D, colors, spec, upper=True,
                                  dtype=np.float64)
    assert isinstance(L, SuperBlockTriSolve)

    rt = np.asarray(_unpermute_super(L, _permute_super(L, jnp.asarray(y))))
    np.testing.assert_array_equal(rt, y)

    x_ref_p = np.linalg.solve(np.tril(Ap, -1) + Dp, y[perm])
    x_ref = np.empty(n)
    x_ref[perm] = x_ref_p
    x = np.asarray(blocked_trisolve(L, jnp.asarray(y)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)

    sgs_ref_p = np.linalg.solve(np.triu(Ap, 1) + Dp, Dp @ x_ref_p)
    sgs_ref = np.empty(n)
    sgs_ref[perm] = sgs_ref_p
    z = np.asarray(blocked_sgs(L, U, jnp.asarray(y)))
    np.testing.assert_allclose(z, sgs_ref, rtol=1e-12, atol=1e-12)


def test_superblock_split_mode_flag(monkeypatch):
    """nx not dividing the lane width selects the ALIGNED-fused layout
    (TB·LANES ≡ 0 mod nx, one kernel per level); the split-parity kernels
    remain behind the BIS_SB_ALIGNED=0 kill-switch."""
    from basic_iterative_solvers_tpu.ops import block_trisolve as bt
    from basic_iterative_solvers_tpu.ops.block_trisolve import (
        SuperBlockTriSolve, build_best_trisolve)
    src = "hpcg:6x4x8"      # nx=6 does not divide 128
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    colors = spec_colors_np(spec, A.n_rows)
    B = build_best_trisolve(A, _diag(A), colors, spec, upper=False,
                            dtype=np.float64)
    assert isinstance(B, SuperBlockTriSolve) and B.fused
    assert (B.TB * 128) % 6 == 0      # tile boundaries pinned to x = 0
    monkeypatch.setattr(bt, "NO_ALIGNED", True)
    B = build_best_trisolve(A, _diag(A), colors, spec, upper=False,
                            dtype=np.float64)
    assert isinstance(B, SuperBlockTriSolve) and not B.fused
    B2 = build_best_trisolve(bis.generators.from_source("hpcg:8x8x8"),
                             _diag(bis.generators.from_source("hpcg:8x8x8")),
                             spec_colors_np(
                                 bis.generators.color_spec_for_source(
                                     "hpcg:8x8x8"), 512),
                             bis.generators.color_spec_for_source("hpcg:8x8x8"),
                             upper=False, dtype=np.float64)
    assert B2.fused


def test_blocked_matches_masked_sweeps(rng):
    """Blocked apply == masked-sweep apply with the SAME colors (the two
    implementations of the identical colored solve)."""
    src = "hpcg:6x4x8"
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    colors = spec_colors_np(spec, A.n_rows)
    y = jnp.asarray(rng.standard_normal(A.n_rows))
    for pt in (bis.PrecondType.GAUSS_SEIDEL,
               bis.PrecondType.BACKWARDS_GAUSS_SEIDEL,
               bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL):
        MB = setup_preconditioner(A, bis.SolverConfig(
            preconditioner=pt, gs_mode="colored", dtype=np.float64,
            color_spec=spec))
        assert MB.L_block is not None or MB.U_block is not None
        MS = setup_preconditioner(A, bis.SolverConfig(
            preconditioner=pt, gs_mode="colored", dtype=np.float64))
        MS = dataclasses.replace(MS, color_arr=jnp.asarray(colors),
                                 n_colors=spec.n_colors)
        np.testing.assert_allclose(
            np.asarray(apply_preconditioner(MB, y)),
            np.asarray(apply_preconditioner(MS, y)), rtol=1e-12, atol=1e-12)


def test_superblock_periodic_boundary(rng):
    """Periodic wrap entries produce whole-block-span deltas — the window
    sizing must absorb them; apply equals the masked sweeps exactly."""
    src = ("scamac:Anderson,Lx=8,Ly=8,Lz=8,t=1.0,ranpot=8.0,seed=3,"
           "boundary=periodic")
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    colors = spec_colors_np(spec, A.n_rows)
    y = jnp.asarray(rng.standard_normal(A.n_rows))
    MB = setup_preconditioner(A, bis.SolverConfig(
        preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        gs_mode="colored", dtype=np.float64, color_spec=spec))
    assert MB.L_block is not None
    MS = setup_preconditioner(A, bis.SolverConfig(
        preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        gs_mode="colored", dtype=np.float64))
    MS = dataclasses.replace(MS, color_arr=jnp.asarray(colors),
                             n_colors=spec.n_colors)
    np.testing.assert_allclose(
        np.asarray(apply_preconditioner(MB, y)),
        np.asarray(apply_preconditioner(MS, y)), rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_ilu0_blocked_end_to_end():
    """CG + colored ILU(0): blocked and masked-sweep paths give the same
    preconditioner action, so the same convergence trajectory."""
    src = "hpcg:8x8x8"
    results = []
    for spec in (bis.generators.color_spec_for_source(src), None):
        cfg = bis.SolverConfig(
            method=bis.SolverType.CONJUGATE_GRADIENT,
            preconditioner=bis.PrecondType.ILU0, gs_mode="colored",
            tolerance=1e-10, dtype=np.float64, color_spec=spec)
        setup = bis.preprocessing(bis.generators.from_source(src), cfg)
        assert (setup.M.L_block is not None) == (spec is not None)
        results.append(bis.solve(setup))
    blocked, sweeps = results
    assert blocked.converged and sweeps.converged
    # same coloring (the structural spec matches greedy on this grid) →
    # same factors → near-identical histories
    assert blocked.iter_count == sweeps.iter_count
    np.testing.assert_allclose(blocked.residual_norms[:blocked.iter_count],
                               sweeps.residual_norms[:sweeps.iter_count],
                               rtol=1e-6)


def test_color_spec_for_source():
    g = bis.generators.color_spec_for_source
    assert g("hpcg:8x8x8").params == (8, 8, 8, 2, 2, 2)
    assert g("hpcg:8x8x8").n_colors == 8
    assert g("fdm:16").params == (16, 16, 1, 2, 2, 1)
    assert g("band:100,2").kind == "mod"
    assert g("band:100,2").n_colors == 3
    assert g("sband:100,4,20") is None          # scattered: greedy territory
    assert g("some_file.mtx") is None
    # anderson: 7-point stencil, even dims → 2x2x2
    s = g("scamac:Anderson,Lx=6,Ly=4,Lz=4")
    assert s.kind == "grid" and s.n_colors == 8
    # odd dims with no small divisor → None (would explode the color count)
    assert g("hpcg:29x29x29") is None


def test_improper_spec_falls_back():
    """A spec that does not properly color the matrix must not be used —
    setup falls back to greedy colors + masked sweeps."""
    A = bis.generators.from_source("band:60,2")
    bad = ColorSpec("mod", 2, (2,))   # offset 2 couples same-colored rows
    M = setup_preconditioner(A, bis.SolverConfig(
        preconditioner=bis.PrecondType.GAUSS_SEIDEL, gs_mode="colored",
        dtype=np.float64, color_spec=bad))
    assert M.L_block is None and M.n_colors >= 3


def test_improper_spec_ilu0_refactors():
    """ILU(0) with an improper spec must RECOLOR AND REFACTOR (the factor
    values computed under invalid colors are wrong), then still converge
    through the masked-sweep fallback."""
    bad = ColorSpec("mod", 2, (2,))
    cfg = bis.SolverConfig(
        method=bis.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bis.PrecondType.ILU0, gs_mode="colored",
        tolerance=1e-10, dtype=np.float64, color_spec=bad)
    setup = bis.preprocessing(bis.generators.from_source("band:60,2"), cfg)
    assert setup.M.L_block is None and setup.M.n_colors >= 3
    res = bis.solve(setup)
    assert res.converged


def test_ineligible_spec_kinds():
    A = bis.generators.from_source("fdm:6")
    colors = spec_colors_np(ColorSpec("parity", 2, (6, 6, 1)), A.n_rows)
    with pytest.raises(BlockIneligibleError):
        build_blocked_trisolve(A, _diag(A), colors,
                               ColorSpec("parity", 2, (6, 6, 1)), upper=False)


# ---------------------------------------------------------------------------
# Constant-coefficient (matrix-free) superblock mode: constant stencil
# sources drop their factor planes entirely — the kernels regenerate them
# as coeff × leg-mask.  Reference factors live in memory
# (reference utilities/LU_factors.hpp); here a constant plane is pure iota
# arithmetic.
# ---------------------------------------------------------------------------

def _gs_pair(src, dtype, need_d=True, force_planes=False):
    from basic_iterative_solvers_tpu.ops import block_trisolve as bt
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    D = _diag(A)
    old = bt.NO_CONST
    bt.NO_CONST = force_planes
    try:
        return bt.build_superblock_gs_pair_from_csr(
            A, D, spec, dtype=dtype, need_d=need_d), A
    finally:
        bt.NO_CONST = old


@pytest.mark.parametrize("src", ["hpcg:8x8x8", "hpcg:16x12x8", "fdm:16"])
def test_const_mode_detected_and_exact(src, rng):
    """Const build must be detected for constant stencils and reproduce
    the plane build bit-for-bit (planes regenerated in-register)."""
    (Lc, Uc), A = _gs_pair(src, np.float32)
    (Lp, Up), _ = _gs_pair(src, np.float32, force_planes=True)
    assert Lc.is_const and Uc.is_const
    assert not Lp.is_const
    assert all(v is None for v in Lc.vals_cross + Lc.vals_self)
    y = jnp.asarray(rng.standard_normal(A.n_rows).astype(np.float32))
    zc = np.asarray(blocked_sgs(Lc, Uc, y))
    zp = np.asarray(blocked_sgs(Lp, Up, y))
    np.testing.assert_array_equal(zc, zp)
    # XLA (f64) path agrees with the f32 kernels to f32 accuracy
    (Lc64, Uc64), _ = _gs_pair(src, np.float64)
    z64 = np.asarray(blocked_sgs(Lc64, Uc64, y.astype(jnp.float64)))
    np.testing.assert_allclose(zc, z64, rtol=2e-5, atol=2e-5)


def test_const_mode_rejects_varying_values():
    """ILU(0) factors vary per entry — they must keep their planes."""
    from basic_iterative_solvers_tpu.config import SolverConfig
    from basic_iterative_solvers_tpu.types import PrecondType, SolverType
    src = "hpcg:8x8x8"
    cfg = SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                       preconditioner=PrecondType.ILU0, gs_mode="colored",
                       color_spec=bis.generators.color_spec_for_source(src))
    M = setup_preconditioner(bis.generators.from_source(src), cfg)
    assert M.L_block is not None and not M.L_block.is_const
    assert not M.U_block.is_const


def test_analytic_stencil_pair_matches_csr_build(rng):
    """build_superblock_gs_pair_stencil (pure metadata, no host CSR) must
    equal the CSR-built const pair structurally and bitwise in action."""
    from basic_iterative_solvers_tpu import stencil_op
    from basic_iterative_solvers_tpu.ops import block_trisolve as bt
    src = "hpcg:16x12x8"
    A = bis.generators.from_source(src)
    spec = bis.generators.color_spec_for_source(src)
    op = stencil_op.from_source_operator(src, dtype=np.float32)
    assert bt.stencil_blocked_eligible(op, spec)
    La, Ua = bt.build_superblock_gs_pair_stencil(op, spec, need_d=True)
    Lc, Uc = bt.build_superblock_gs_pair_from_csr(A, _diag(A), spec,
                                                  need_d=True)
    assert La.is_const and Lc.is_const
    assert La.levels == Lc.levels and Ua.levels == Uc.levels
    assert La.const_cross == Lc.const_cross
    assert La.const_self == Lc.const_self
    assert Ua.const_cross == Uc.const_cross
    y = jnp.asarray(rng.standard_normal(A.n_rows).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(blocked_sgs(La, Ua, y)),
                                  np.asarray(blocked_sgs(Lc, Uc, y)))


@pytest.mark.slow
def test_device_path_routes_gs_family_through_blocked(rng):
    """preprocessing_device must take the analytic blocked route for
    constant stencils (method AND preconditioner), with iteration counts
    matching the masked-sweep route."""
    from basic_iterative_solvers_tpu import stencil_op
    src = "hpcg:8x8x8"

    def run(planar):
        cfg = bis.SolverConfig(
            method=bis.SolverType.SYMMETRIC_GAUSS_SEIDEL,
            dtype=np.float64, harness="fused", tolerance=1e-9,
            planar_vectors=planar)
        s = bis.preprocessing_device(
            stencil_op.from_source_operator(src, dtype=np.float64), cfg)
        return bis.solve(s), s

    r_blk, s_blk = run("off")
    r_swp, s_swp = run("on")
    assert s_blk.gs_L_block is not None and s_blk.gs_L_block.is_const
    assert s_swp.gs_L_block is None          # planar=on keeps sweeps
    assert r_blk.converged
    assert r_blk.iter_count == r_swp.iter_count
    h1 = np.asarray(r_blk.residual_norms)
    h2 = np.asarray(r_swp.residual_norms)
    m = min(h1.size, h2.size)
    assert np.max(np.abs(h1[:m] - h2[:m])) / h1[0] < 1e-12

    # precond route: CG + SGS builds M.L_block analytically
    cfg_p = bis.SolverConfig(
        method=bis.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        dtype=np.float32, harness="fused", tolerance=1e-5,
        planar_vectors="off")
    s_p = bis.preprocessing_device(
        stencil_op.from_source_operator(src, dtype=np.float32), cfg_p)
    assert s_p.M.L_block is not None and s_p.M.L_block.is_const
    assert bis.solve(s_p).converged


# ---------------------------------------------------------------------------
# Translation-table exact ILU(0) (build_superblock_ilu0_pair_stencil)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["hpcg:32x24x20", "hpcg:16x12x8", "fdm:16",
                                 "hpcg:12x8x6"])
def test_ilu0_translation_matches_csr_factorization(src, rng):
    """Prototype-table ILU(0) == the full CSR factorization: the colored
    factor values are translation-invariant beyond the R = h·n_colors
    boundary radius (dependency cones walk strictly-increasing colors), so
    the class-gathered planes must APPLY identically.  hpcg:32x24x20
    exercises mapped prototype axes (32, 24 > 2R+2s), 16x12x8 and fdm:16
    the identity/2-D cases, 12x8x6 the SPLIT-parity kernel layout
    (128 % nx != 0 — the any-nx route that unlocks ILU(0) at 384³)."""
    from basic_iterative_solvers_tpu import _native, stencil_op
    from basic_iterative_solvers_tpu.generators import color_spec_for_source
    from basic_iterative_solvers_tpu.ops import block_trisolve as bt
    spec = color_spec_for_source(src)
    A = bis.generators.from_source(src)
    op = stencil_op.from_source_operator(src, dtype=np.float32)
    assert bt.stencil_ilu0_eligible(op, spec)
    colors = spec_colors_np(spec, A.n_rows)
    perm, inv = colors_to_perm(colors)
    fp = _native.permute_factor_csr(A, perm, inv, 1e-8, 1e-4)
    if fp is None:
        pytest.skip("native library unavailable")
    Ap, lu_p = fp
    L1, U1, _ = bt.build_superblock_ilu0_pair(Ap, lu_p, perm, spec,
                                              dtype=np.float32)
    L2, U2 = bt.build_superblock_ilu0_pair_stencil(op, spec,
                                                   dtype=np.float32)
    assert L1.levels == L2.levels and U1.levels == U2.levels
    y = jnp.asarray(rng.standard_normal(A.n_rows).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(blocked_ilu0(L1, U1, y)),
                                  np.asarray(blocked_ilu0(L2, U2, y)))


@pytest.mark.slow
def test_ilu0_device_path_matches_host(rng):
    """preprocessing_device + ILU0 (zero host CSR) converges identically
    to the host-CSR colored-ILU(0) pipeline (f64 histories to ~1e-15)."""
    from basic_iterative_solvers_tpu import stencil_op
    from basic_iterative_solvers_tpu.generators import color_spec_for_source
    src = "hpcg:16x12x8"
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           preconditioner=bis.PrecondType.ILU0,
                           gs_mode="colored", dtype=np.float64,
                           harness="fused", tolerance=1e-10,
                           color_spec=color_spec_for_source(src))
    op = stencil_op.from_source_operator(src, dtype=np.float64)
    r_dev = bis.solve(bis.preprocessing_device(op, cfg))
    A = bis.generators.from_source(src)
    r_host = bis.solve(bis.preprocessing(A, cfg))
    assert r_dev.converged and r_host.converged
    assert r_dev.iter_count == r_host.iter_count
    h1 = np.asarray(r_dev.residual_norms)
    h2 = np.asarray(r_host.residual_norms)
    k = min(h1.size, h2.size)
    assert np.max(np.abs(h1[:k] - h2[:k])) / h1[0] < 1e-13


def test_solve_system_routes_ilu0_to_device():
    """solve_system('hpcg:…', preconditioner='ilu0') takes the device
    path (stencil operator, no host CSR) and converges."""
    r = bis.solve_system("hpcg:16x16x16", method="cg",
                         preconditioner="ilu0", dtype=np.float64,
                         harness="fused", tolerance=1e-8)
    assert r.converged
