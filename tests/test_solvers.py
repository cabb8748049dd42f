"""End-to-end solver integration tests (reference tier:
/root/reference/tests/test_solvers.cpp — full preprocessing → solve on the
3x3 tridiagonal [2,-1;-1,2,-1;-1,2] with known x* = [1,2,3], asserting
convergence_flag and x* — extended to GMRES, ILU(0) and both harnesses,
which the reference leaves untested)."""
import numpy as np
import pytest

from basic_iterative_solvers_tpu import (
    PrecondType, SolverConfig, SolverType, preprocessing,
    preprocessing_device, solve)
from basic_iterative_solvers_tpu.generators import anderson, banded, fdm_2d
from tests.conftest import make_tridiag

X_STAR = np.array([1.0, 2.0, 3.0])


def run_solver_test(method, precond=PrecondType.NONE, harness="host",
                    tol_x=1e-7, matrix=None, x_star=None, **cfg_kw):
    """Analog of reference run_solver_test (test_solvers.cpp:49-91):
    b := A·x_star so the solution is known, then assert convergence."""
    A = matrix if matrix is not None else make_tridiag(3)
    x_star = X_STAR if x_star is None else x_star
    b = A.spmv(x_star)
    config = SolverConfig(method=method, preconditioner=precond,
                          dtype=np.float64, harness=harness,
                          tolerance=1e-14, **cfg_kw)
    setup = preprocessing(A, config, b=b)
    result = solve(setup)
    assert result.converged, (
        f"{method}/{precond} did not converge: iters={result.iter_count}, "
        f"final={result.final_residual_norm:.3e}, "
        f"criteria={result.stopping_criteria:.3e}")
    np.testing.assert_allclose(result.x_star, x_star, atol=tol_x)
    return result


# --- the reference's DEFINE_SOLVER_TEST matrix (test_solvers.cpp:145-175) ---

@pytest.mark.parametrize("harness", ["host", "fused"])
def test_cg(harness):
    run_solver_test(SolverType.CONJUGATE_GRADIENT, harness=harness)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_cg_jacobi(harness):
    run_solver_test(SolverType.CONJUGATE_GRADIENT, PrecondType.JACOBI,
                    harness=harness)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_bicgstab(harness):
    run_solver_test(SolverType.BICGSTAB, harness=harness)


def test_bicgstab_jacobi():
    run_solver_test(SolverType.BICGSTAB, PrecondType.JACOBI)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_jacobi(harness):
    run_solver_test(SolverType.JACOBI, harness=harness)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_gauss_seidel(harness):
    run_solver_test(SolverType.GAUSS_SEIDEL, harness=harness)


def test_symmetric_gauss_seidel():
    run_solver_test(SolverType.SYMMETRIC_GAUSS_SEIDEL)


def test_bicgstab_diag_dominant():
    """reference test_solvers.cpp:93-141: diagonally-dominant 3x3."""
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    A = MatrixCSR.from_dense(np.array([[4.0, -1, 0], [-1, 4, -1], [0, -1, 4]]))
    run_solver_test(SolverType.BICGSTAB, PrecondType.JACOBI, matrix=A)


# --- beyond the reference's coverage ---

@pytest.mark.parametrize("harness", ["host", "fused"])
def test_gmres(harness):
    run_solver_test(SolverType.GMRES, harness=harness)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_gmres_restarts(harness):
    """Force restarts: m=3 on a 36-dim problem needs several cycles."""
    A = fdm_2d(6)
    x_star = np.linspace(1.0, 2.0, 36)
    r = run_solver_test(SolverType.GMRES, matrix=A, x_star=x_star,
                        restart_length=3, harness=harness, tol_x=1e-6)
    assert r.gmres_restart_count > 0


# CG needs an SPD preconditioner; on a symmetric matrix that's Jacobi, SGS,
# symmetric two-stage and ILU(0) (L·D·Lᵀ form).  The nonsymmetric ones
# (GS, BGS, plain two-stage) go through BiCGSTAB below.
@pytest.mark.parametrize("precond", [
    PrecondType.JACOBI, PrecondType.SYMMETRIC_GAUSS_SEIDEL,
    PrecondType.SYMMETRIC_TWO_STAGE_GS, PrecondType.ILU0])
def test_cg_all_spd_preconditioners(precond):
    A = fdm_2d(5)
    x_star = np.linspace(-1.0, 1.0, 25)
    run_solver_test(SolverType.CONJUGATE_GRADIENT, precond, matrix=A,
                    x_star=x_star, tol_x=1e-6, precond_inner_iters=1)


@pytest.mark.parametrize("precond", [
    PrecondType.GAUSS_SEIDEL, PrecondType.BACKWARDS_GAUSS_SEIDEL,
    PrecondType.TWO_STAGE_GS])
def test_bicgstab_nonsymmetric_preconditioners(precond):
    A = fdm_2d(5)
    x_star = np.linspace(-1.0, 1.0, 25)
    run_solver_test(SolverType.BICGSTAB, precond, matrix=A,
                    x_star=x_star, tol_x=1e-6, precond_inner_iters=1)


@pytest.mark.parametrize("precond", [
    PrecondType.SYMMETRIC_GAUSS_SEIDEL, PrecondType.ILU0])
def test_gmres_preconditioned(precond):
    A = banded(30, bandwidth=2, seed=3)
    x_star = np.linspace(1.0, 3.0, 30)
    run_solver_test(SolverType.GMRES, precond, matrix=A, x_star=x_star,
                    restart_length=10, tol_x=1e-6)


@pytest.mark.parametrize("precond", [PrecondType.ILU0,
                                     PrecondType.SYMMETRIC_GAUSS_SEIDEL])
def test_bicgstab_preconditioned(precond):
    A = fdm_2d(5)
    x_star = np.linspace(0.5, 1.5, 25)
    run_solver_test(SolverType.BICGSTAB, precond, matrix=A, x_star=x_star,
                    tol_x=1e-6)


def test_anderson_cg():
    A = anderson(4, 4, 4, t=1.0, ranpot=12.0, seed=2)
    # make it positive definite: Anderson + shift
    dense = A.to_dense() + 8.0 * np.eye(64)
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    A = MatrixCSR.from_dense(dense)
    x_star = np.ones(64)
    run_solver_test(SolverType.CONJUGATE_GRADIENT, PrecondType.JACOBI,
                    matrix=A, x_star=x_star, tol_x=1e-6)


def test_num_scale():
    """-scale 1 path: symmetric diagonal equilibration
    (preprocessing.hpp:39-50). The scaled system solves x' = D^{1/2}x."""
    A = banded(20, bandwidth=2, seed=8)
    x_star = np.linspace(1.0, 2.0, 20)
    b = A.spmv(x_star)
    config = SolverConfig(method=SolverType.BICGSTAB, dtype=np.float64,
                          num_scale=True)
    setup = preprocessing(A, config, b=b)
    result = solve(setup)
    assert result.converged
    # un-scale: x = D^{-1/2} x'  (x' solves the scaled system)
    x = setup.scale_vec * result.x_star
    np.testing.assert_allclose(x, x_star, atol=1e-6)


def test_host_fused_equivalence():
    """Host and fused harnesses run the same arithmetic."""
    A = fdm_2d(5)
    x_star = np.linspace(0.0, 1.0, 25)
    b = A.spmv(x_star)
    results = {}
    for harness in ("host", "fused"):
        config = SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                              preconditioner=PrecondType.JACOBI,
                              dtype=np.float64, harness=harness)
        setup = preprocessing(A, config, b=b)
        results[harness] = solve(setup)
    assert results["host"].iter_count == results["fused"].iter_count
    np.testing.assert_allclose(results["host"].x_star,
                               results["fused"].x_star, rtol=1e-12, atol=1e-13)
    nh, nf = (results["host"].residual_norms, results["fused"].residual_norms)
    np.testing.assert_allclose(nh, nf, rtol=1e-10)


def test_divergence_detected():
    """check_stopping_criteria divergence branch (solver.hpp:181): Jacobi on
    a non-diagonally-dominant system blows up but terminates."""
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    A = MatrixCSR.from_dense(np.array([[1.0, 3.0], [3.0, 1.0]]))
    config = SolverConfig(method=SolverType.JACOBI, dtype=np.float64,
                          max_iters=500)
    setup = preprocessing(A, config)
    result = solve(setup)
    assert not result.converged


def test_max_iters_respected():
    A = fdm_2d(8)
    config = SolverConfig(method=SolverType.JACOBI, dtype=np.float64,
                          max_iters=5)
    setup = preprocessing(A, config)
    result = solve(setup)
    assert result.iter_count == 5
    assert not result.converged


def test_gmres_cgs2_matches_mgs():
    """CGS2 orthogonalization must converge like MGS (same Krylov space)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.types import PrecondType, SolverType
    A = bis.generators.fdm_2d(12)
    kw = dict(method=SolverType.GMRES, preconditioner=PrecondType.JACOBI,
              restart_length=30, dtype=np.float64, tolerance=1e-10,
              harness="fused")
    r_mgs = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        orthog_mode="mgs", **kw)))
    r_cgs = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        orthog_mode="cgs2", **kw)))
    assert r_cgs.converged
    assert abs(r_cgs.iter_count - r_mgs.iter_count) <= 2
    np.testing.assert_allclose(r_cgs.x_star, r_mgs.x_star, rtol=1e-7,
                               atol=1e-9)


def test_gmres_cgs2_debug_checks_pass():
    """CGS2 keeps the basis orthonormal (validated by the SanityChecker)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.types import SolverType
    A = bis.generators.banded(80, bandwidth=3, seed=11)
    cfg = bis.SolverConfig(method=SolverType.GMRES, restart_length=25,
                           orthog_mode="cgs2", dtype=np.float64,
                           tolerance=1e-9, harness="host", debug_checks=True)
    res = bis.solve(bis.preprocessing(A, cfg))
    assert res.converged


def test_divergence_detection():
    """NaN/oscillating runs must stop with converged=False
    (check_stopping_criteria divergence branch, solver.hpp:181)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    from basic_iterative_solvers_tpu.types import SolverType
    # Jacobi diverges when the iteration matrix has spectral radius > 1
    dense = np.array([[1.0, 4.0], [4.0, 1.0]])
    A = MatrixCSR.from_dense(dense)
    cfg = bis.SolverConfig(method=SolverType.JACOBI, dtype=np.float64,
                           max_iters=2000, harness="fused")
    res = bis.solve(bis.preprocessing(A, cfg))
    assert not res.converged


def test_max_iters_cap():
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.types import SolverType
    A = bis.generators.fdm_2d(16)
    cfg = bis.SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, max_iters=5, harness="fused")
    res = bis.solve(bis.preprocessing(A, cfg))
    assert res.iter_count == 5 and not res.converged


def test_one_by_one_matrix():
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    from basic_iterative_solvers_tpu.types import SolverType
    A = MatrixCSR.from_dense(np.array([[4.0]]))
    cfg = bis.SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, tolerance=1e-14, harness="fused")
    res = bis.solve(bis.preprocessing(A, cfg, b=np.array([8.0])))
    assert res.converged
    np.testing.assert_allclose(res.x_star, [2.0], rtol=1e-12)


def test_gmres_happy_breakdown_finite():
    """Exact Krylov breakdown (A = 2I) must yield a finite x_star, not NaN
    from the w/0 basis row (code-review finding)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    from basic_iterative_solvers_tpu.types import SolverType
    A = MatrixCSR.from_dense(2.0 * np.eye(8))
    b = np.zeros(8); b[0] = 1.0
    for harness in ("host", "fused"):
        cfg = bis.SolverConfig(method=SolverType.GMRES, dtype=np.float64,
                               tolerance=1e-12, harness=harness)
        res = bis.solve(bis.preprocessing(A, cfg, b=b,
                                          x0=np.zeros(8)))
        assert res.converged
        assert np.all(np.isfinite(res.x_star)), harness
        np.testing.assert_allclose(res.x_star, b / 2.0, atol=1e-12)


def test_spmv_empty_offsets_pallas_guard():
    """Strict split of a diagonal-only matrix has no stored diagonals; spmv
    must return zeros eagerly and under jit (code-review finding)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from basic_iterative_solvers_tpu import dia
    from basic_iterative_solvers_tpu.ops.spmv import spmv
    A = dia.banded_device(50, bandwidth=0, dtype=np.float64)
    L, U, D, Dinv = dia.dia_split(A)
    x = jnp.arange(50, dtype=jnp.float64)
    for M in (L, U):
        for f in (spmv, jax.jit(spmv)):
            np.testing.assert_array_equal(np.asarray(f(M, x)),
                                          np.zeros(50))


def test_fused_matches_host_with_sparse_sampling():
    """res_check_len > 1: fused and host harnesses must stop at the same
    iteration (both gate on the last SAMPLED norm; code-review finding)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.types import SolverType
    A = bis.generators.fdm_2d(16)
    kw = dict(method=SolverType.CONJUGATE_GRADIENT, dtype=np.float64,
              tolerance=1e-10, res_check_len=7)
    res_h = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        harness="host", **kw)))
    res_f = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        harness="fused", **kw)))
    assert res_f.iter_count == res_h.iter_count
    assert res_f.converged == res_h.converged
    np.testing.assert_allclose(res_f.residual_norms[:-1],
                               res_h.residual_norms[:-1], rtol=1e-10)


def test_gmres_debug_checks_float32():
    """--debug-checks under float32 must not fire spuriously: the
    orthonormality tolerance scales with the state dtype (ADVICE r1)."""
    import basic_iterative_solvers_tpu as bis
    res = bis.solve_system("fdm:8", method="gm", dtype=np.float32,
                           restart_length=20, max_iters=60,
                           tolerance=1e-5, harness="host", debug_checks=True)
    assert res.converged


def test_solve_system_stencil_format():
    """solve_system(matrix_format='stencil') routes through the matrix-free
    operator like the CLI --format stencil (ADVICE r1: it used to fall to
    the host path and crash in from_csr)."""
    import basic_iterative_solvers_tpu as bis
    res = bis.solve_system("fdm:8", method="cg", matrix_format="stencil",
                           dtype=np.float64, harness="host",
                           tolerance=1e-10)
    assert res.converged
    ref = bis.solve_system("fdm:8", method="cg", dtype=np.float64,
                           harness="host", tolerance=1e-10)
    np.testing.assert_allclose(res.x_star, ref.x_star, atol=1e-8)


def test_final_residual_is_float64_on_device_path():
    """Device-native explicit final residual is evaluated in f64 even when
    the solve runs in f32 (reference solver.hpp:153-159 reports fp64)."""
    import basic_iterative_solvers_tpu as bis
    res = bis.solve_system("hpcg:8x8x8", method="cg", dtype=np.float32,
                           harness="host", tolerance=1e-6)
    assert res.converged
    # the f64 evaluation differs from the f32 one below f32 resolution;
    # just pin that it is finite, small, and was computed without a host CSR
    assert res.final_residual_norm < 1e-4


def test_gmres_lowsync_matches_mgs():
    """Low-synchronization CGS2 (Gram-corrected reorthogonalization) must
    converge like MGS, including across restarts."""
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.types import PrecondType, SolverType
    A = bis.generators.fdm_2d(12)
    kw = dict(method=SolverType.GMRES, preconditioner=PrecondType.JACOBI,
              restart_length=12, dtype=np.float64, tolerance=1e-10,
              harness="fused")
    r_mgs = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        orthog_mode="mgs", **kw)))
    r_ls = bis.solve(bis.preprocessing(A, bis.SolverConfig(
        orthog_mode="lowsync", **kw)))
    assert r_ls.converged
    assert r_ls.gmres_restart_count >= 1   # exercises the G reset
    assert abs(r_ls.iter_count - r_mgs.iter_count) <= 2
    np.testing.assert_allclose(r_ls.x_star, r_mgs.x_star, rtol=1e-7,
                               atol=1e-9)


def test_gmres_lowsync_orthonormality():
    """The Gram-corrected basis stays orthonormal to CGS2 grade (the
    SanityChecker V-orthonormality assert runs every iteration)."""
    import basic_iterative_solvers_tpu as bis
    res = bis.solve_system("fdm:10", method="gm", dtype=np.float64,
                           restart_length=40, orthog_mode="lowsync",
                           tolerance=1e-11, harness="host",
                           debug_checks=True)
    assert res.converged


@pytest.mark.slow
def test_gmres_bf16_basis_convergence_equivalent():
    """bfloat16 basis storage (gmres_basis_dtype) must not change the
    iteration count materially on a benchmark-class matrix."""
    import basic_iterative_solvers_tpu as bis
    kw = dict(method="gm", restart_length=30, orthog_mode="lowsync",
              dtype=np.float32, harness="fused", tolerance=1e-4,
              max_iters=300)
    r32 = bis.solve_system("hpcg:12x12x12", gmres_basis_dtype=None, **kw)
    rbf = bis.solve_system("hpcg:12x12x12", gmres_basis_dtype="bfloat16",
                           **kw)
    assert r32.converged and rbf.converged
    assert abs(rbf.iter_count - r32.iter_count) <= 3
    # the recovered solutions agree to basis precision
    np.testing.assert_allclose(rbf.x_star, r32.x_star, rtol=0, atol=2e-2)


def test_gmres_fused_fallback_warns():
    """orthog_mode='fused' (the removed kernel mode) is refused with the
    modes that remain named — never a silent substitute."""
    import basic_iterative_solvers_tpu as bis
    with pytest.raises(ValueError, match="mgs | cgs2 | lowsync"):
        bis.solve_system("fdm:16", method="gm", orthog_mode="fused",
                         dtype=np.float32, restart_length=16,
                         tolerance=1e-4, harness="fused")


@pytest.mark.slow
def test_pipelined_cg_matches_classic():
    """Ghysels–Vanroose pipelined PCG (cg_flavor="pipelined") is
    algebraically the same iteration as classic PCG: identical iteration
    counts and matching solutions across preconditioners and harnesses."""
    import basic_iterative_solvers_tpu as bis
    for prec in (None, "j", "sgs"):
        for harness in ("fused", "host"):
            kw = dict(method="cg", preconditioner=prec, dtype=np.float64,
                      tolerance=1e-11, harness=harness)
            rc = bis.solve_system("hpcg:8x8x8", cg_flavor="classic", **kw)
            rp = bis.solve_system("hpcg:8x8x8", cg_flavor="pipelined", **kw)
            assert rc.converged and rp.converged
            assert abs(rp.iter_count - rc.iter_count) <= 1, (prec, harness)
            np.testing.assert_allclose(rp.x_star, rc.x_star, rtol=1e-8,
                                       atol=1e-10)


def test_pipelined_cg_unknown_flavor_errors():
    import basic_iterative_solvers_tpu as bis
    with pytest.raises(ValueError, match="cg_flavor"):
        bis.solve_system("fdm:16", method="cg", cg_flavor="nope")


def test_pipelined_cg_residual_replacement_at_tight_tol():
    """At the reference's default tol = 1e-14·||r0|| the RAW pipelined
    recurrences stall above the criterion (drift); the default periodic
    residual replacement restores classic-grade attainable accuracy."""
    import basic_iterative_solvers_tpu as bis
    kw = dict(method="cg", preconditioner="j", dtype=np.float64,
              harness="fused")          # default tol = 1e-14
    rc = bis.solve_system("hpcg:16x16x16", **kw)
    rp = bis.solve_system("hpcg:16x16x16", cg_flavor="pipelined", **kw)
    assert rc.converged and rp.converged
    assert rp.iter_count <= rc.iter_count + 8
    r0 = bis.solve_system("hpcg:16x16x16", cg_flavor="pipelined",
                          cg_rr_period=0, max_iters=120, **kw)
    assert not r0.converged            # the drift stall, unreplaced


def test_iterative_refinement_f32_reaches_f64_criterion():
    """Mixed-precision refinement: f32 inner solves + fp64 outer
    corrections reach the fp64 stopping criterion tol·||r0|| that a plain
    f32 solve cannot honestly attain."""
    import basic_iterative_solvers_tpu as bis
    kw = dict(method="cg", preconditioner="j", dtype=np.float32,
              harness="fused", tolerance=1e-12)
    plain = bis.solve_system("hpcg:16x16x16", **kw)
    assert plain.final_residual_norm > plain.stopping_criteria  # f32 lies
    ref = bis.solve_system("hpcg:16x16x16", refine_outer=6, **kw)
    assert ref.converged
    assert ref.final_residual_norm <= ref.stopping_criteria
    assert 0 < ref.refine_outer_count <= 6
    # matches the all-f64 direct solve
    r64 = bis.solve_system("hpcg:16x16x16", method="cg", preconditioner="j",
                           dtype=np.float64, harness="fused",
                           tolerance=1e-12)
    np.testing.assert_allclose(ref.x_star, r64.x_star, rtol=0, atol=1e-9)


@pytest.mark.slow
def test_iterative_refinement_device_paths():
    """Refinement over the device-native DIA and planar matrix-free
    stencil paths (the fp64 residual upcasts the device operator)."""
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import dia, stencil_op
    for A_dev, planar in ((dia.stencil_27pt_device(10, 10, 10,
                                                   dtype=np.float32), "off"),
                          (stencil_op.from_source_operator(
                              "hpcg:10x10x10", dtype=np.float32), "on")):
        cfg = SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           preconditioner=PrecondType.CHEBYSHEV,
                           dtype=np.float32, tolerance=1e-12,
                           harness="fused", planar_vectors=planar,
                           refine_outer=6)
        res = solve(preprocessing_device(A_dev, cfg))
        assert res.converged and res.refine_outer_count >= 1
        assert res.final_residual_norm <= res.stopping_criteria


def test_iterative_refinement_rejects_transforms():
    import basic_iterative_solvers_tpu as bis
    with pytest.raises(ValueError, match="refinement requires"):
        bis.solve_system("hpcg:8x8x8", method="cg", preconditioner="j",
                         dtype=np.float32, refine_outer=2, perm_mode="rcm")


def test_iterative_refinement_reuses_compiled_runner(monkeypatch):
    """Each fp64 outer correction re-dispatches the SAME fused executable
    with the new RHS swapped in (FusedRunner.rebind_b) — the runner is
    traced/lowered exactly once, so refinement never re-traces or
    recompiles per outer."""
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.solvers import fused as _f
    builds = []
    orig = _f.FusedRunner.__init__

    def counting(self, *a, **kw):
        builds.append(1)
        orig(self, *a, **kw)

    monkeypatch.setattr(_f.FusedRunner, "__init__", counting)
    # classic-CG refinement goes through the SINGLE-DISPATCH fused path
    # (_solve_refined_fused): the whole outer loop is one jitted program,
    # no FusedRunner at all
    res = bis.solve_system("hpcg:12x12x12", method="cg", preconditioner="j",
                           dtype=np.float32, harness="fused",
                           tolerance=1e-12, refine_outer=6)
    assert res.converged and res.refine_outer_count >= 2
    assert len(builds) == 0, f"fused refinement built {len(builds)} runners"
    # the per-outer loop path (BiCGSTAB needs the breakdown retry ladder)
    # re-dispatches ONE compiled executable with the RHS swapped in
    # (FusedRunner.rebind_b) — traced/lowered exactly once
    res = bis.solve_system("hpcg:12x12x12", method="bi", preconditioner="j",
                           dtype=np.float32, harness="fused",
                           tolerance=1e-10, refine_outer=6)
    assert res.converged and res.refine_outer_count >= 2
    assert len(builds) == 1, f"runner rebuilt {len(builds)} times"


@pytest.mark.slow
def test_pipelined_cg_strong_preconditioners_f32():
    """Regression: f32 pipelined CG with STRONG preconditioners (mg,
    cheby, sgs) used to stall forever — the fixed-period replacement fired
    after the drift had poisoned p.  The flying-restart trigger
    (cg_rr_theta decrease criterion) replaces before the true and
    recurrence residuals separate; iteration counts must match f64."""
    import basic_iterative_solvers_tpu as bis
    for prec, max_it in (("mg", 10), ("cheby", 14), ("sgs", 18)):
        r32 = bis.solve_system("hpcg:16x16x16", method="cg",
                               cg_flavor="pipelined", preconditioner=prec,
                               dtype=np.float32, harness="fused",
                               tolerance=1e-6, max_iters=100)
        assert r32.converged and r32.iter_count <= max_it, (
            prec, r32.iter_count, float(r32.final_residual_norm))


@pytest.mark.slow
def test_breakdown_stall_keeps_tol0_runs_finite():
    """tolerance=0 fixed-iteration benchmark runs with a strong M converge
    past the attainable floor; breakdown_stall must keep the recurrence
    finite (stationary) instead of NaN-poisoning the timed tail
    (SolverConfig.breakdown_stall, bench pcg_mg row)."""
    import numpy as np
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import stencil_op

    op = stencil_op.from_source_operator("hpcg:8x8x8", dtype=np.float32)
    kw = dict(method=bis.SolverType.CONJUGATE_GRADIENT,
              preconditioner=bis.PrecondType.MULTIGRID,
              dtype=np.float32, harness="fused",
              tolerance=0.0, max_iters=120)
    s_guard = bis.preprocessing_device(
        op, bis.SolverConfig(breakdown_stall=True, **kw))
    r_guard = bis.solve(s_guard)
    # the guarded run executes the full budget with a finite final
    # residual at (or near) the f32 attainable floor
    assert r_guard.iter_count == 120
    assert np.isfinite(r_guard.final_residual_norm)
    assert np.isfinite(np.asarray(r_guard.residual_norms)).all()
    r0 = float(np.asarray(r_guard.residual_norms)[0])
    assert r_guard.final_residual_norm < 1e-4 * r0

    # BiCGSTAB + SGS is the other breakdown-prone pair (ρ/ω quotients go
    # ~0/~0 past the floor — an unguarded f32 solve can end in
    # ||r||=nan)
    kw_bi = dict(method=bis.SolverType.BICGSTAB,
                 preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
                 dtype=np.float32, harness="fused",
                 tolerance=0.0, max_iters=120)
    s_bi = bis.preprocessing_device(
        op, bis.SolverConfig(breakdown_stall=True, **kw_bi))
    r_bi = bis.solve(s_bi)
    assert r_bi.iter_count == 120
    assert np.isfinite(r_bi.final_residual_norm)
    assert np.isfinite(np.asarray(r_bi.residual_norms)).all()
    r0_bi = float(np.asarray(r_bi.residual_norms)[0])
    assert r_bi.final_residual_norm < 1e-4 * r0_bi
