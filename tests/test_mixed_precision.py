"""Mixed-precision (bf16 matrix data) mode.

Matrix data stored bfloat16 while all vector arithmetic stays float32 —
the SpMV HBM-stream halving perf mode.  Correctness bar: the solve still
converges, to a tolerance consistent with a bf16-perturbed operator.
"""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia
from basic_iterative_solvers_tpu.types import PrecondType, SolverType


def test_mat_dtype_resolution():
    import ml_dtypes
    cfg = bis.SolverConfig(dtype=np.float32)
    assert cfg.mat_dtype() == np.float32
    cfg = bis.SolverConfig(dtype=np.float32, matrix_dtype="bfloat16")
    assert cfg.mat_dtype() == np.dtype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("method,precond", [
    (SolverType.CONJUGATE_GRADIENT, PrecondType.JACOBI),
    (SolverType.BICGSTAB, PrecondType.SYMMETRIC_TWO_STAGE_GS),
])
def test_bf16_matrix_device_path(method, precond):
    A = dia.stencil_27pt_device(6, 6, 6, dtype=np.float32)
    cfg = bis.SolverConfig(method=method, preconditioner=precond,
                           dtype=np.float32, matrix_dtype="bfloat16",
                           precond_inner_iters=1,
                           tolerance=1e-4, harness="fused")
    setup = bis.preprocessing_device(A, cfg)
    import ml_dtypes
    assert setup.A.data.dtype == np.dtype(ml_dtypes.bfloat16)
    assert setup.b.dtype == np.float32            # vectors stay f32
    assert setup.M.A_D is None or setup.M.A_D.dtype == np.float32
    res = bis.solve(setup)
    assert res.converged
    # answer quality consistent with a bf16 operator (roughly 3 digits)
    x_ref = bis.solve(bis.preprocessing_device(
        A, bis.SolverConfig(method=method, preconditioner=precond,
                            dtype=np.float32, precond_inner_iters=1,
                            tolerance=1e-4, harness="fused"))).x_star
    np.testing.assert_allclose(res.x_star, x_ref, rtol=2e-2, atol=2e-2)


def test_bf16_matrix_host_path():
    A = bis.generators.fdm_2d(12)
    cfg = bis.SolverConfig(method=SolverType.BICGSTAB,
                           preconditioner=PrecondType.TWO_STAGE_GS,
                           precond_inner_iters=1,
                           dtype=np.float32, matrix_dtype="bfloat16",
                           tolerance=1e-4, harness="fused")
    setup = bis.preprocessing(A, cfg)
    import ml_dtypes
    assert setup.A.data.dtype == np.dtype(ml_dtypes.bfloat16)
    assert setup.M.L_strict_dev.data.dtype == np.dtype(ml_dtypes.bfloat16)
    res = bis.solve(setup)
    assert res.converged


def test_refinement_over_mesh_gspmd():
    """fp64 iterative refinement composes with a GSPMD mesh: the inner f32
    solver runs sharded, the fp64 residual oracle and b-rebinding operate
    on the sharded arrays unchanged."""
    from basic_iterative_solvers_tpu.parallel import make_mesh, shard_setup
    A8 = bis.dia.stencil_27pt_device(8, 16, 8, dtype=np.float32)
    cfg = bis.SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           preconditioner=PrecondType.JACOBI,
                           dtype=np.float32, harness="fused",
                           tolerance=1e-12, refine_outer=5)
    setup = shard_setup(bis.preprocessing_device(A8, cfg), make_mesh(8))
    res = bis.solve(setup)
    assert res.converged and res.refine_outer_count >= 2
    assert res.final_residual_norm <= res.stopping_criteria


def test_refinement_all_krylov_methods_f32():
    """Regression: unit-scaled inner correction systems.  Unscaled
    late-outer RHS (~1e-8) drove f32 BiCGSTAB's rho/omega divisions into
    NaN breakdown, stalling refinement after one outer.  All three Krylov
    methods must now reach the fp64 criterion from f32 inners."""
    for meth in ("cg", "bicgstab", "gmres"):
        res = bis.solve_system("hpcg:16x16x16", method=meth,
                               preconditioner="j", refine_outer=8,
                               tolerance=1e-12, dtype=np.float32,
                               harness="fused", max_iters=300)
        assert res.converged, (meth, float(res.final_residual_norm))
        assert res.final_residual_norm <= res.stopping_criteria


def test_refinement_single_dispatch_gmres():
    """GMRES(m) inners run through the SINGLE-DISPATCH fused refinement
    (the restart machinery nests as a cycle-structured while inside the
    outer correction loop — solvers/base.py _build_refined_fused)."""
    from basic_iterative_solvers_tpu.solvers.base import (
        _refine_fused_eligible)
    A = bis.dia.stencil_27pt_device(16, 16, 16, dtype=np.float32)
    cfg = bis.SolverConfig(method=bis.SolverType.GMRES,
                           preconditioner=bis.PrecondType.JACOBI,
                           restart_length=20, dtype=np.float32,
                           harness="fused", tolerance=1e-11,
                           refine_outer=8)
    setup = bis.preprocessing_device(A, cfg)
    assert _refine_fused_eligible(setup)
    res = bis.solve(setup)
    assert res.converged and res.refine_outer_count >= 2
    # the inner solves really restarted (m=20 < iters needed per outer
    # at f32) and the refined answer is fp64-grade
    assert res.final_residual_norm <= 1e-11 * res.residual_norms[0]


def test_refinement_single_dispatch_bicgstab_stays_on_ladder():
    """BiCGSTAB refinement keeps the per-outer retry-ladder path (its
    NaN-breakdown recovery needs host control flow)."""
    from basic_iterative_solvers_tpu.solvers.base import (
        _refine_fused_eligible)
    A = bis.dia.stencil_27pt_device(8, 8, 8, dtype=np.float32)
    cfg = bis.SolverConfig(method=bis.SolverType.BICGSTAB,
                           preconditioner=bis.PrecondType.JACOBI,
                           dtype=np.float32, harness="fused",
                           tolerance=1e-11, refine_outer=8)
    setup = bis.preprocessing_device(A, cfg)
    assert not _refine_fused_eligible(setup)
    res = bis.solve(setup)
    assert res.converged
