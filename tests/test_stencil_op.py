"""Matrix-free constant-stencil operator (stencil_op.py) vs the explicit
formats, plus end-to-end solves and GSPMD sharding."""
import jax
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia, generators, stencil_op
from basic_iterative_solvers_tpu.ops.spmv import spmv
from basic_iterative_solvers_tpu.types import PrecondType, SolverType


@pytest.mark.parametrize("build_op,build_csr", [
    (lambda: stencil_op.stencil_27pt_operator(5, 4, 3, dtype=np.float64),
     lambda: generators.stencil_27pt(5, 4, 3)),
    (lambda: stencil_op.fdm_2d_operator(9, dtype=np.float64),
     lambda: generators.fdm_2d(9)),
    (lambda: stencil_op.anderson_operator(4, 5, 3, t=1.2, ranpot=4.0, seed=6,
                                          dtype=np.float64),
     lambda: generators.anderson(4, 5, 3, t=1.2, ranpot=4.0, seed=6)),
])
def test_stencil_spmv_matches_csr(build_op, build_csr):
    A_op = build_op()
    A_csr = build_csr()
    x = np.random.default_rng(0).standard_normal(A_csr.n_rows)
    y_ref = A_csr.spmv(x)
    y = np.asarray(spmv(A_op, jax.numpy.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_stencil_split_matches_dia_split():
    A_op = stencil_op.anderson_operator(4, 4, 4, ranpot=6.0, seed=2,
                                        dtype=np.float64)
    A_dia = dia.anderson_device(4, 4, 4, ranpot=6.0, seed=2,
                                dtype=np.float64)
    Ls, Us, D, Dinv = stencil_op.stencil_split(A_op)
    Ld, Ud, Dd, Dinvd = dia.dia_split(A_dia)
    np.testing.assert_allclose(np.asarray(D), np.asarray(Dd), rtol=1e-15)
    x = np.random.default_rng(1).standard_normal(A_op.n_rows)
    xj = jax.numpy.asarray(x)
    np.testing.assert_allclose(np.asarray(spmv(Ls, xj)),
                               np.asarray(spmv(Ld, xj)), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(spmv(Us, xj)),
                               np.asarray(spmv(Ud, xj)), rtol=1e-13)


def test_stencil_to_dia_roundtrip():
    A_op = stencil_op.anderson_operator(5, 3, 2, ranpot=3.0, seed=9,
                                        dtype=np.float64)
    A_dia = stencil_op.stencil_to_dia(A_op)
    ref = dia.anderson_device(5, 3, 2, ranpot=3.0, seed=9, dtype=np.float64)
    assert A_dia.offsets == ref.offsets
    np.testing.assert_allclose(np.asarray(A_dia.data), np.asarray(ref.data))


def test_from_source_operator():
    op = stencil_op.from_source_operator("hpcg:4x4x4", dtype=np.float64)
    assert op.n_rows == 64 and op.diag is None
    op = stencil_op.from_source_operator(
        "scamac:Anderson,Lx=3,Ly=3,Lz=3,ranpot=2.0,seed=1", dtype=np.float64)
    assert op.diag is not None
    with pytest.raises(ValueError):
        stencil_op.from_source_operator("band:10,2")


@pytest.mark.parametrize("method,precond", [
    (SolverType.CONJUGATE_GRADIENT, PrecondType.JACOBI),
    (SolverType.BICGSTAB, PrecondType.SYMMETRIC_TWO_STAGE_GS),
    (SolverType.GMRES, PrecondType.TWO_STAGE_GS),
])
def test_stencil_end_to_end_matches_dia(method, precond):
    cfg = bis.SolverConfig(method=method, preconditioner=precond,
                           precond_inner_iters=1, dtype=np.float64,
                           tolerance=1e-11, harness="fused")
    A_op = stencil_op.stencil_27pt_operator(5, 5, 5, dtype=np.float64)
    A_dia = dia.stencil_27pt_device(5, 5, 5, dtype=np.float64)
    res_op = bis.solve(bis.preprocessing_device(A_op, cfg))
    res_dia = bis.solve(bis.preprocessing_device(A_dia, cfg))
    assert res_op.converged
    assert res_op.iter_count == res_dia.iter_count
    np.testing.assert_allclose(res_op.x_star, res_dia.x_star, rtol=1e-9,
                               atol=1e-11)


@pytest.mark.slow
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_stencil_gspmd():
    from basic_iterative_solvers_tpu.parallel import make_mesh, shard_setup
    cfg = bis.SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           preconditioner=PrecondType.JACOBI,
                           dtype=np.float64, tolerance=1e-11, harness="fused")
    A_op = stencil_op.stencil_27pt_operator(8, 8, 8, dtype=np.float64)
    setup1 = bis.preprocessing_device(A_op, cfg)
    res1 = bis.solve(setup1)
    setup8 = shard_setup(bis.preprocessing_device(A_op, cfg), make_mesh(8))
    res8 = bis.solve(setup8)
    assert res8.converged and res8.iter_count == res1.iter_count
    np.testing.assert_allclose(res8.x_star, res1.x_star, rtol=1e-9,
                               atol=1e-11)


def test_stencil_rejects_num_scale():
    A_op = stencil_op.fdm_2d_operator(6, dtype=np.float64)
    with pytest.raises(ValueError):
        bis.preprocessing_device(A_op, bis.SolverConfig(
            dtype=np.float64, num_scale=True))


@pytest.mark.parametrize("method,precond", [
    (SolverType.CONJUGATE_GRADIENT, PrecondType.JACOBI),
    (SolverType.BICGSTAB, PrecondType.SYMMETRIC_TWO_STAGE_GS),
    (SolverType.GMRES, PrecondType.NONE),
    (SolverType.JACOBI, PrecondType.NONE),
])
@pytest.mark.slow
def test_planar_resident_matches_flat(method, precond):
    """planar_vectors='on' must give the same solve as the flat layout,
    with x_star decoded back to user coordinates."""
    A_op = stencil_op.stencil_27pt_operator(5, 6, 4, dtype=np.float64)
    base_kw = dict(method=method, preconditioner=precond,
                   precond_inner_iters=1, dtype=np.float64,
                   tolerance=1e-11, harness="fused")
    res_flat = bis.solve(bis.preprocessing_device(
        A_op, bis.SolverConfig(planar_vectors="off", **base_kw)))
    res_pl = bis.solve(bis.preprocessing_device(
        A_op, bis.SolverConfig(planar_vectors="on", **base_kw)))
    assert res_pl.converged == res_flat.converged
    assert res_pl.iter_count == res_flat.iter_count
    assert res_pl.x_star.shape == (A_op.n_rows,)
    np.testing.assert_allclose(res_pl.x_star, res_flat.x_star, rtol=1e-9,
                               atol=1e-11)


def test_planar_resident_anderson_diag():
    A_op = stencil_op.anderson_operator(5, 4, 3, ranpot=6.0, seed=3,
                                        dtype=np.float64)
    cfg = bis.SolverConfig(method=SolverType.BICGSTAB,
                           preconditioner=PrecondType.JACOBI,
                           dtype=np.float64, tolerance=1e-11,
                           harness="fused", planar_vectors="on")
    res = bis.solve(bis.preprocessing_device(A_op, cfg))
    assert res.converged
    A_csr = generators.anderson(5, 4, 3, ranpot=6.0, seed=3)
    np.testing.assert_allclose(A_csr.spmv(res.x_star),
                               np.full(A_op.n_rows, 1.0), rtol=1e-8)


def test_planar_vec_roundtrip_and_halo():
    A_op = stencil_op.fdm_2d_operator(7, dtype=np.float64)
    Ap = stencil_op.to_planar_matrix(A_op)
    x = np.random.default_rng(0).standard_normal(A_op.n_rows)
    import jax.numpy as jnp
    xp = stencil_op.to_planar_vec(Ap, jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(stencil_op.from_planar_vec(Ap, xp)), x)
    # spmv keeps halo exactly zero
    y = stencil_op.stencil_spmv(Ap, xp)
    mask = np.asarray(stencil_op.to_planar_vec(
        Ap, jnp.ones(A_op.n_rows))) == 0
    assert np.all(np.asarray(y)[mask] == 0.0)
