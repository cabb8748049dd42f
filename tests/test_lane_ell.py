"""Windowed lane-ELL format tests (ops/lane_ell.py) — the general-sparsity
SpMV path (native_spmv on arbitrary CSR, reference kernels.hpp:22-42).
These pin the layout invariants, the SpMV arithmetic against the CSR
oracle, auto-selection, and a full CG solve on a genuinely non-stencil
matrix."""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.device_matrix import (DeviceDIA, DeviceELL,
                                                       from_csr)
from basic_iterative_solvers_tpu.generators import (banded, scattered_band,
                                                    stencil_27pt)
from basic_iterative_solvers_tpu.ops.lane_ell import (
    DeviceLaneELL, csr_to_lane_ell, lane_ell_span, lane_ell_spmv)


def test_span_and_layout_invariants():
    A = scattered_band(2000, 6, 300, seed=3)
    M = csr_to_lane_ell(A, np.float64)
    assert M.S == lane_ell_span(A) <= M.TB
    assert M.R % M.TB == 0
    assert M.vals.shape == (M.K, M.R, 128) == M.idx.shape
    # every stored packed index decodes to an in-range source slot
    idx = np.asarray(M.idx)
    rowoff = idx // 128 - M.S
    assert rowoff.min() >= -M.S and rowoff.max() <= M.S
    # per-slot ranges hold for ALL entries of the slot (incl. padding)
    for k, (lo, hi) in enumerate(M.slot_ranges):
        assert rowoff[k].min() >= lo and rowoff[k].max() <= hi


@pytest.mark.parametrize("gen,args", [
    (scattered_band, (1500, 7, 260, 1)),
    (banded, (900, 5, 2)),
    (stencil_27pt, (9, 8, 7)),
])
def test_spmv_matches_csr_oracle(gen, args):
    A = gen(*args)
    M = csr_to_lane_ell(A, np.float64)
    x = np.random.default_rng(0).uniform(-1, 1, A.n_rows)
    import jax.numpy as jnp
    y = np.asarray(lane_ell_spmv(M, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.spmv(x), rtol=1e-12, atol=1e-12)


def test_from_csr_auto_selects_lane_ell():
    # scattered band: ~2·spread distinct diagonals at low fill → DIA is
    # rejected, bounded span → lane-ELL
    A = scattered_band(1200, 6, 280, seed=0)
    M = from_csr(A, np.float64)
    assert isinstance(M, DeviceLaneELL)
    # stencils stay DIA
    assert isinstance(from_csr(stencil_27pt(6, 6, 6), np.float64), DeviceDIA)
    # forcing the plain gather format still works
    assert isinstance(from_csr(A, np.float64, "ell"), DeviceELL)


def test_infty_mat_norm_lane_ell():
    from basic_iterative_solvers_tpu.ops.blas1 import infty_mat_norm
    A = scattered_band(800, 5, 200, seed=5)
    M = csr_to_lane_ell(A, np.float64)
    dense = A.to_dense()
    want = np.abs(dense).sum(axis=1).max()
    np.testing.assert_allclose(float(infty_mat_norm(M)), want, rtol=1e-12)


def test_cg_on_scattered_band_end_to_end():
    """Full pipeline on a general (non-stencil, non-banded) matrix through
    the auto-selected lane-ELL format."""
    res = bis.solve_system("sband:1500,6,260,1", method="cg",
                           dtype=np.float64, harness="host",
                           tolerance=1e-10)
    assert res.converged
    A = bis.generators.from_source("sband:1500,6,260,1")
    assert np.linalg.norm(A.spmv(res.x_star)
                          - np.full(A.n_rows, 1.0)) < 1e-7


@pytest.mark.slow
def test_bicgstab_sgs_on_scattered_band():
    """Colored exact SGS preconditioning works on the lane-ELL format too
    (the masked sweep only needs SpMV + the diagonal)."""
    res = bis.solve_system("sband:900,5,180,2", method="bi",
                           preconditioner="sgs", gs_mode="colored",
                           dtype=np.float64, harness="host",
                           tolerance=1e-10)
    assert res.converged
