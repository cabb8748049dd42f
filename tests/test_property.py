"""Randomized property tests: every device format must agree with the host
CSR oracle on arbitrary shapes, leg sets, and data (seeded, deterministic)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from basic_iterative_solvers_tpu import dia, generators, stencil_op
from basic_iterative_solvers_tpu.device_matrix import csr_to_dia, csr_to_ell
from basic_iterative_solvers_tpu.matrix import MatrixCOO, convert_coo_to_csr
from basic_iterative_solvers_tpu.ops.spmv import spmv, spmv_dot


@pytest.mark.parametrize("seed", range(12))
def test_random_stencils_match_oracle(seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = rng.integers(2, 9, size=3)
    # random subset of the 27-point neighborhood with random coefficients
    legs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    keep = rng.random(27) < 0.6
    keep[13] = True   # always keep the center
    legs_coeffs = [(l, float(rng.standard_normal()))
                   for l, k in zip(legs, keep) if k]
    A = stencil_op.make_stencil(legs_coeffs, int(nx), int(ny), int(nz),
                                dtype=np.float64)
    n = A.n_rows
    # oracle: dense assembly from the leg definition
    dense = np.zeros((n, n))
    for (dx, dy, dz), c in legs_coeffs:
        if (nx - abs(dx)) <= 0 or (ny - abs(dy)) <= 0 or (nz - abs(dz)) <= 0:
            continue
        for i in range(n):
            x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
            X, Y, Z = x + dx, y + dy, z + dz
            if 0 <= X < nx and 0 <= Y < ny and 0 <= Z < nz:
                dense[i, X + nx * (Y + ny * Z)] += c
    v = rng.standard_normal(n)
    expect = dense @ v
    got = np.asarray(spmv(A, jnp.asarray(v)))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)
    # planar layout agrees and keeps halos zero
    Ap = stencil_op.to_planar_matrix(A)
    vp = stencil_op.to_planar_vec(Ap, jnp.asarray(v))
    yp = spmv(Ap, vp)
    np.testing.assert_allclose(
        np.asarray(stencil_op.from_planar_vec(Ap, yp)), expect,
        rtol=1e-12, atol=1e-12)
    # fused dot fallback agrees
    y2, d = spmv_dot(Ap, vp)
    np.testing.assert_allclose(float(d), float(jnp.sum(yp * vp)),
                               rtol=1e-12)
    # to-DIA lowering agrees
    Ad = stencil_op.stencil_to_dia(A)
    np.testing.assert_allclose(np.asarray(spmv(Ad, jnp.asarray(v))), expect,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", range(8))
def test_random_sparse_formats_match_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 120))
    density = float(rng.uniform(0.05, 0.4))
    dense = np.where(rng.random((n, n)) < density,
                     rng.standard_normal((n, n)), 0.0)
    dense[np.arange(n), np.arange(n)] = rng.uniform(1, 2, size=n)  # diag
    I, J = np.nonzero(dense)
    A = convert_coo_to_csr(MatrixCOO.from_arrays(I, J, dense[I, J],
                                                 n_rows=n, n_cols=n))
    v = rng.standard_normal(n)
    expect = dense @ v
    np.testing.assert_allclose(A.spmv(v), expect, rtol=1e-12, atol=1e-12)
    from basic_iterative_solvers_tpu.ops.lane_ell import csr_to_lane_ell
    for M in (csr_to_dia(A, np.float64), csr_to_ell(A, np.float64),
              csr_to_lane_ell(A, np.float64)):
        np.testing.assert_allclose(np.asarray(spmv(M, jnp.asarray(v))),
                                   expect, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_random_banded_split_roundtrip(seed):
    """L_strict + diag + U_strict must reassemble the operator exactly."""
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(10, 200))
    bw = int(rng.integers(0, 4))
    A = dia.banded_device(n, bandwidth=bw, seed=seed, dtype=np.float64)
    L, U, D, Dinv = dia.dia_split(A)
    v = rng.standard_normal(n)
    vj = jnp.asarray(v)
    lhs = np.asarray(spmv(A, vj))
    rhs = (np.asarray(spmv(L, vj)) + np.asarray(D) * v
           + np.asarray(spmv(U, vj)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(D) * np.asarray(Dinv),
                               np.ones(n), rtol=1e-14)
