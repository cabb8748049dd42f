"""Preconditioner-apply tests (reference apply_preconditioner tests,
/root/reference/tests/test_kernels.cpp:156-225, extended to all 7 types)."""
import jax.numpy as jnp
import numpy as np
import pytest

from basic_iterative_solvers_tpu.config import SolverConfig
from basic_iterative_solvers_tpu.generators import banded, fdm_2d
from basic_iterative_solvers_tpu.precond import (
    apply_preconditioner, setup_preconditioner)
from basic_iterative_solvers_tpu.types import PrecondType
from tests.test_factor import dense_ilu0


def _dense_expected(pt, A_dense, y, inner=0):
    D = np.diag(np.diag(A_dense))
    Dv = np.diag(A_dense)
    Ls = np.tril(A_dense, -1)
    Us = np.triu(A_dense, 1)
    if pt == PrecondType.NONE:
        return y
    if pt == PrecondType.JACOBI:
        return y / Dv
    if pt == PrecondType.GAUSS_SEIDEL:
        return np.linalg.solve(Ls + D, y)
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return np.linalg.solve(Us + D, y)
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        return np.linalg.solve(Us + D, Dv * np.linalg.solve(Ls + D, y))
    if pt == PrecondType.TWO_STAGE_GS:
        Dinv = np.diag(1.0 / Dv)
        out = np.zeros_like(y)
        term = Dinv @ y
        out += term
        for _ in range(inner):
            term = -Dinv @ (Ls @ term)
            out += term
        return out
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        Dinv = np.diag(1.0 / Dv)

        def richardson(T, v):
            out = np.zeros_like(v)
            term = Dinv @ v
            out += term
            for _ in range(inner):
                term = -Dinv @ (T @ term)
                out += term
            return out

        return richardson(Us, Dv * richardson(Ls, y))
    if pt == PrecondType.ILU0:
        L, U = dense_ilu0(A_dense)
        return np.linalg.solve(U, np.linalg.solve(L, y))
    raise ValueError(pt)


# MULTIGRID has no host-CSR path (stencil hierarchies only — its dense
# SPD/oracle coverage lives in tests/test_mg.py, and the refusal itself in
# test_mg_host_csr_path_refused)
@pytest.mark.parametrize("pt", [p for p in PrecondType
                                if p != PrecondType.MULTIGRID])
@pytest.mark.parametrize("inner", [0, 2])
def test_apply_matches_dense(pt, inner, rng):
    A = banded(18, bandwidth=2, seed=11)
    y = rng.uniform(-1, 1, 18)
    config = SolverConfig(preconditioner=pt, dtype=np.float64,
                          precond_inner_iters=inner)
    M = setup_preconditioner(A, config)
    z = np.asarray(apply_preconditioner(M, jnp.asarray(y)))
    if pt == PrecondType.CHEBYSHEV:   # oracle needs the setup's λmax
        expected = _cheby_oracle(A.to_dense(), y, float(M.cheby_lmax),
                                 config.cheby_degree, config.cheby_eig_ratio)
    else:
        expected = _dense_expected(pt, A.to_dense(), y, inner)
    np.testing.assert_allclose(z, expected, rtol=1e-11, atol=1e-12)


def test_outer_iters_composition(rng):
    """PRECOND_OUTER_ITERS applies M⁻¹ repeatedly (kernels.hpp:355-404)."""
    A = fdm_2d(4)
    y = rng.uniform(-1, 1, 16)
    config = SolverConfig(preconditioner=PrecondType.JACOBI,
                          dtype=np.float64, precond_outer_iters=3)
    M = setup_preconditioner(A, config)
    z = np.asarray(apply_preconditioner(M, jnp.asarray(y)))
    Dv = np.diag(A.to_dense())
    np.testing.assert_allclose(z, y / Dv ** 3, rtol=1e-12)


def test_jacobi_apply_reference_values():
    """reference test_kernels.cpp:156-225 style: exact expected outputs."""
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    A = MatrixCSR.from_dense(np.array([[2.0, 0, 0], [0, 4.0, 0], [0, 0, 8.0]]))
    config = SolverConfig(preconditioner=PrecondType.JACOBI, dtype=np.float64)
    M = setup_preconditioner(A, config)
    z = np.asarray(apply_preconditioner(M, jnp.asarray([2.0, 2.0, 2.0])))
    np.testing.assert_allclose(z, [1.0, 0.5, 0.25])


# -- Chebyshev polynomial preconditioner (no reference analog) ---------------

def _cheby_oracle(A_dense, y, lmax, degree, ratio):
    """The apply recurrence in NumPy, same λmax (pins _cheby_apply)."""
    dinv = 1.0 / np.diag(A_dense)
    lmin = lmax / ratio
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = (dinv * y) / theta
    z = d.copy()
    for _ in range(max(1, degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        resid = y - A_dense @ z
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * resid)
        z = z + d
        rho = rho_new
    return z


def test_cheby_apply_matches_oracle(rng):
    from basic_iterative_solvers_tpu.generators import stencil_27pt
    A = stencil_27pt(5, 4, 3)
    cfg = SolverConfig(preconditioner=PrecondType.CHEBYSHEV,
                       dtype=np.float64, cheby_degree=5)
    M = setup_preconditioner(A, cfg)
    y = rng.standard_normal(A.n_rows)
    z = np.asarray(apply_preconditioner(M, jnp.asarray(y)))
    z_ref = _cheby_oracle(A.to_dense(), y, float(M.cheby_lmax), 5,
                          cfg.cheby_eig_ratio)
    np.testing.assert_allclose(z, z_ref, rtol=1e-12, atol=1e-14)
    # λmax estimate brackets the true spectrum of D⁻¹A (1.1x headroom)
    B = A.to_dense() / np.diag(A.to_dense())[:, None]
    w = np.linalg.eigvals(B).real
    assert w.max() <= float(M.cheby_lmax) <= 1.3 * w.max()


def test_cheby_symmetric_spd(rng):
    """M⁻¹ must be symmetric positive definite for CG."""
    from basic_iterative_solvers_tpu.generators import stencil_27pt
    A = stencil_27pt(4, 4, 4)
    cfg = SolverConfig(preconditioner=PrecondType.CHEBYSHEV,
                       dtype=np.float64)
    M = setup_preconditioner(A, cfg)
    x = rng.standard_normal(A.n_rows)
    y = rng.standard_normal(A.n_rows)
    zx = np.asarray(apply_preconditioner(M, jnp.asarray(x)))
    zy = np.asarray(apply_preconditioner(M, jnp.asarray(y)))
    np.testing.assert_allclose(np.dot(zx, y), np.dot(x, zy), rtol=1e-12)
    assert np.dot(zx, x) > 0 and np.dot(zy, y) > 0


@pytest.mark.slow
def test_cheby_accelerates_cg():
    """Chebyshev(4) must beat Jacobi, and degree 8 must beat degree 4, on
    the HPCG operator — on host-CSR, device-DIA and matrix-free paths."""
    import basic_iterative_solvers_tpu as bis
    kw = dict(method="cg", dtype=np.float64, tolerance=1e-11,
              harness="fused")
    it_j = bis.solve_system("hpcg:16x16x16", preconditioner="j", **kw)
    it_c4 = bis.solve_system("hpcg:16x16x16", preconditioner="cheby", **kw)
    it_c8 = bis.solve_system("hpcg:16x16x16", preconditioner="cheby",
                             cheby_degree=8, **kw)
    assert it_j.converged and it_c4.converged and it_c8.converged
    assert it_c4.iter_count < it_j.iter_count
    assert it_c8.iter_count < it_c4.iter_count


@pytest.mark.slow
def test_cheby_device_native_paths():
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import dia, stencil_op
    from basic_iterative_solvers_tpu.solvers import (preprocessing_device,
                                                     solve)
    cfg = SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                       preconditioner=PrecondType.CHEBYSHEV,
                       dtype=np.float64, tolerance=1e-11, harness="fused")
    r_dia = solve(preprocessing_device(
        dia.stencil_27pt_device(10, 10, 10, dtype=np.float64), cfg))
    r_st = solve(preprocessing_device(
        stencil_op.from_source_operator("hpcg:10x10x10", dtype=np.float64),
        cfg))
    assert r_dia.converged and r_st.converged
    assert r_dia.iter_count == r_st.iter_count
    np.testing.assert_allclose(r_dia.x_star, r_st.x_star, rtol=1e-9)
