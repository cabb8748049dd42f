"""Device kernel tests (reference tier: kernel unit tests,
/root/reference/tests/test_kernels.cpp)."""
import jax.numpy as jnp
import numpy as np
import pytest

from basic_iterative_solvers_tpu.device_matrix import (
    DeviceDIA, DeviceELL, analyze_diagonals, csr_to_dia, csr_to_ell, from_csr)
from basic_iterative_solvers_tpu.generators import anderson, banded, fdm_2d, stencil_27pt
from basic_iterative_solvers_tpu.matrix import MatrixCSR
from basic_iterative_solvers_tpu.ops import (
    compute_residual, dot, euclidean_vec_norm, spmv)
from basic_iterative_solvers_tpu.ops.blas1 import (
    elemwise_div_vectors, elemwise_mult_vectors, infty_vec_norm, scale,
    subtract_vectors, sum_vectors)


@pytest.mark.parametrize("fmt", ["dia", "ell"])
@pytest.mark.parametrize("make", [
    lambda: fdm_2d(5),
    lambda: banded(33, bandwidth=3, seed=0),
    lambda: stencil_27pt(4, 3, 2),
    lambda: anderson(4, 3, 2, t=1.1, ranpot=3.0, seed=9),
])
def test_spmv_matches_host(fmt, make, rng):
    A = make()
    Ad = from_csr(A, np.float64, matrix_format=fmt)
    x = rng.uniform(-1, 1, A.n_cols)
    y = np.asarray(spmv(Ad, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.spmv(x), rtol=1e-13, atol=1e-13)


def test_spmv_diagonal_3x3():
    # reference test_kernels.cpp: 3x3 diagonal matrix
    A = MatrixCSR.from_dense(np.diag([1.0, 2.0, 3.0]))
    x = jnp.asarray([1.0, 1.0, 1.0])
    for fmt in ("dia", "ell"):
        Ad = from_csr(A, np.float64, matrix_format=fmt)
        np.testing.assert_allclose(np.asarray(spmv(Ad, x)), [1.0, 2.0, 3.0])


def test_spmv_dense_3x3(rng):
    dense = rng.uniform(-2, 2, (3, 3))
    A = MatrixCSR.from_dense(dense)
    x = rng.uniform(-1, 1, 3)
    for fmt in ("dia", "ell"):
        Ad = from_csr(A, np.float64, matrix_format=fmt)
        np.testing.assert_allclose(np.asarray(spmv(Ad, jnp.asarray(x))),
                                   dense @ x, rtol=1e-14)


def test_format_autoselection():
    # stencil → DIA
    assert isinstance(from_csr(stencil_27pt(4), np.float32), DeviceDIA)
    assert isinstance(from_csr(fdm_2d(8), np.float32), DeviceDIA)
    # random scatter with bounded column span → windowed lane-ELL (the
    # general-sparsity format, ops/lane_ell.py)
    from basic_iterative_solvers_tpu.ops.lane_ell import DeviceLaneELL
    rng = np.random.default_rng(0)
    n = 64
    dense = (rng.uniform(0, 1, (n, n)) > 0.93) * rng.uniform(-1, 1, (n, n))
    dense += np.eye(n)  # ensure diagonal
    A = MatrixCSR.from_dense(dense)
    offs, fill = analyze_diagonals(A)
    assert isinstance(from_csr(A, np.float32), DeviceLaneELL)
    # forcing plain gather ELL still works
    assert isinstance(from_csr(A, np.float32, "ell"), DeviceELL)


def test_dia_offsets():
    A = fdm_2d(4)
    Ad = csr_to_dia(A)
    assert Ad.offsets == (-4, -1, 0, 1, 4)


def test_ell_padding():
    A = fdm_2d(3)
    Ad = csr_to_ell(A, np.float64)
    assert Ad.cols.shape[0] == 9
    # row sums of |vals| preserved
    dense = A.to_dense()
    np.testing.assert_allclose(np.asarray(jnp.sum(jnp.abs(Ad.data), axis=1)),
                               np.abs(dense).sum(axis=1))


def test_compute_residual(rng):
    A = banded(17, bandwidth=2, seed=3)
    Ad = from_csr(A, np.float64)
    x = rng.uniform(-1, 1, 17)
    b = rng.uniform(-1, 1, 17)
    r = np.asarray(compute_residual(Ad, jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(r, b - A.spmv(x), rtol=1e-13, atol=1e-14)


def test_blas1(rng):
    v1 = jnp.asarray(rng.uniform(-1, 1, 50))
    v2 = jnp.asarray(rng.uniform(0.5, 1.5, 50))
    np.testing.assert_allclose(np.asarray(subtract_vectors(v1, v2, 2.0)),
                               np.asarray(v1) - 2.0 * np.asarray(v2))
    np.testing.assert_allclose(np.asarray(sum_vectors(v1, v2, 0.5)),
                               np.asarray(v1) + 0.5 * np.asarray(v2))
    np.testing.assert_allclose(np.asarray(elemwise_mult_vectors(v1, v2, -1.0)),
                               np.asarray(v1) * -1.0 * np.asarray(v2))
    np.testing.assert_allclose(np.asarray(elemwise_div_vectors(v1, v2)),
                               np.asarray(v1) / np.asarray(v2))
    np.testing.assert_allclose(float(dot(v1, v2)),
                               np.dot(np.asarray(v1), np.asarray(v2)))
    np.testing.assert_allclose(float(euclidean_vec_norm(v1)),
                               np.linalg.norm(np.asarray(v1)))
    np.testing.assert_allclose(float(infty_vec_norm(v1)),
                               np.abs(np.asarray(v1)).max())
    np.testing.assert_allclose(np.asarray(scale(v1, 3.0)), 3.0 * np.asarray(v1))


def test_euclidean_norm_edge_cases():
    # reference test_utilities.cpp:34-62: zero and empty vectors
    assert float(euclidean_vec_norm(jnp.zeros(5))) == 0.0
    assert float(euclidean_vec_norm(jnp.zeros(0))) == 0.0


def test_infty_mat_norm_all_formats():
    import jax.numpy as jnp
    import numpy as np
    from basic_iterative_solvers_tpu import dia, generators, stencil_op
    from basic_iterative_solvers_tpu.device_matrix import csr_to_dia, csr_to_ell
    from basic_iterative_solvers_tpu.ops.blas1 import infty_mat_norm
    A = generators.anderson(4, 3, 3, ranpot=5.0, seed=8)
    dense = A.to_dense()
    expect = np.abs(dense).sum(axis=1).max()
    for M in (csr_to_dia(A, np.float64), csr_to_ell(A, np.float64),
              stencil_op.anderson_operator(4, 3, 3, ranpot=5.0, seed=8,
                                           dtype=np.float64),
              stencil_op.to_planar_matrix(
                  stencil_op.anderson_operator(4, 3, 3, ranpot=5.0, seed=8,
                                               dtype=np.float64))):
        np.testing.assert_allclose(float(infty_mat_norm(M)), expect,
                                   rtol=1e-13)
