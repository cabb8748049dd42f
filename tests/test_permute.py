"""Matrix reordering (perm_mode — the SMAX permute_mat analog)."""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import generators, permute
from basic_iterative_solvers_tpu.factor import (level_sets_lower, split_LU)
from basic_iterative_solvers_tpu.types import PrecondType, SolverType


def test_permutation_is_valid():
    A = generators.anderson(4, 4, 4, ranpot=3.0, seed=1)
    for mode in ("none", "bfs", "rcm"):
        perm, inv = permute.compute_permutation(A, mode)
        np.testing.assert_array_equal(np.sort(perm), np.arange(A.n_rows))
        np.testing.assert_array_equal(perm[inv], np.arange(A.n_rows))
    with pytest.raises(ValueError):
        permute.compute_permutation(A, "zigzag")


def test_permute_csr_is_similarity_transform():
    A = generators.anderson(4, 3, 2, ranpot=5.0, seed=2)
    perm, inv = permute.compute_permutation(A, "rcm")
    Ap = permute.permute_csr(A, perm, inv)
    dense = A.to_dense()
    np.testing.assert_allclose(Ap.to_dense(), dense[np.ix_(perm, perm)])
    # rows stay column-sorted
    for i in range(Ap.n_rows):
        cols = Ap.col[Ap.row_ptr[i]:Ap.row_ptr[i + 1]]
        assert np.all(np.diff(cols) > 0)


def test_native_and_numpy_permute_agree(monkeypatch):
    from basic_iterative_solvers_tpu import _native
    if not _native.available():
        pytest.skip("native unavailable")
    A = generators.anderson(5, 4, 3, ranpot=2.0, seed=3)
    perm, inv = permute.compute_permutation(A, "bfs")
    Ap_native = permute.permute_csr(A, perm, inv)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    perm2, inv2 = permute.compute_permutation(A, "bfs")
    np.testing.assert_array_equal(perm, perm2)
    Ap_np = permute.permute_csr(A, perm2, inv2)
    np.testing.assert_array_equal(Ap_native.row_ptr, Ap_np.row_ptr)
    np.testing.assert_array_equal(Ap_native.col, Ap_np.col)
    np.testing.assert_allclose(Ap_native.val, Ap_np.val, rtol=0)


def test_rcm_reduces_bandwidth():
    """RCM must restore a narrow band on a randomly shuffled lattice (its
    guarantee; bandwidth is what bounds the DIA width and the wavefront
    structure of the triangular solves)."""
    rng = np.random.default_rng(0)
    A = generators.anderson(6, 6, 6, ranpot=3.0, seed=4)
    # random symmetric shuffle to destroy the natural banded ordering
    p = rng.permutation(A.n_rows).astype(np.int32)
    ip = np.empty_like(p)
    ip[p] = np.arange(A.n_rows, dtype=np.int32)
    A_shuf = permute.permute_csr(A, p, ip)

    def bandwidth(M):
        rows = np.repeat(np.arange(M.n_rows), M.row_nnz())
        return int(np.abs(M.col - rows).max())

    bw_before = bandwidth(A_shuf)          # ≈ n after shuffling
    perm, inv = permute.compute_permutation(A_shuf, "rcm")
    A_rcm = permute.permute_csr(A_shuf, perm, inv)
    assert bandwidth(A_rcm) < bw_before // 2
    # and the level structure stays shallow enough for the scan solve
    levels = level_sets_lower(split_LU(A_rcm)[1]).max() + 1
    assert levels <= A.n_rows // 4


@pytest.mark.parametrize("mode", ["bfs", "rcm"])
def test_solve_with_permutation_matches(mode):
    """Permuted solve must return x_star in the ORIGINAL ordering."""
    A = generators.anderson(5, 5, 5, ranpot=8.0, seed=5)
    x_true = np.linspace(1.0, 2.0, A.n_rows)
    b = A.spmv(x_true)
    cfg = bis.SolverConfig(method=SolverType.BICGSTAB,
                           preconditioner=PrecondType.GAUSS_SEIDEL,
                           dtype=np.float64, tolerance=1e-12, harness="fused")
    cfg_p = bis.SolverConfig(method=SolverType.BICGSTAB,
                             preconditioner=PrecondType.GAUSS_SEIDEL,
                             dtype=np.float64, tolerance=1e-12,
                             harness="fused", perm_mode=mode)
    res = bis.solve(bis.preprocessing(A, cfg, b=b))
    res_p = bis.solve(bis.preprocessing(A, cfg_p, b=b))
    assert res_p.converged
    np.testing.assert_allclose(res_p.x_star, x_true, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(res_p.x_star, res.x_star, rtol=1e-7,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# Auto-RCM: the gather-cliff guard (VERDICT r2 item 7).
# ---------------------------------------------------------------------------

def test_auto_rcm_restores_lane_ell(monkeypatch, rng):
    """A matrix that is banded only under a reordering would silently fall
    onto the ~200x XLA-gather path; preprocessing auto-applies RCM and
    keeps the lane-ELL kernel, mapping the solution back."""
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import device_matrix
    from basic_iterative_solvers_tpu.matrix import (MatrixCOO,
                                                    convert_coo_to_csr)
    from basic_iterative_solvers_tpu.ops.lane_ell import DeviceLaneELL
    n = 1500
    p = rng.permutation(n)
    # scrambled tridiag(-1, 2.5, -1): wide span as given, span ~1 after RCM
    I, J, V = [], [], []
    for off, v in ((0, 2.5), (1, -1.0), (-1, -1.0)):
        rows = np.arange(max(0, -off), n - max(0, off))
        I.append(p[rows]); J.append(p[rows + off])
        V.append(np.full(rows.size, v))
    A = convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=n, n_cols=n))
    monkeypatch.setattr(device_matrix, "LANE_ELL_MAX_SPAN", 2)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, tolerance=1e-11,
                           harness="fused")
    setup = bis.preprocessing(A, cfg)
    # RCM restored a kernel format (the recovered band is so tight it may
    # even qualify for DIA) — the point is it is NOT the gather path
    from basic_iterative_solvers_tpu.device_matrix import DeviceELL
    assert not isinstance(setup.A, DeviceELL)
    assert setup.inv_perm is not None          # solution mapped back
    res = bis.solve(setup)
    assert res.converged
    # the returned x solves the ORIGINAL-ordering system
    r = np.full(n, cfg.b_val) - A.spmv(res.x_star)
    assert np.linalg.norm(r) < 1e-9


def test_auto_rcm_gather_fallback_warns(monkeypatch):
    """When even RCM cannot fit the lane-ELL window, the format change
    must be LOUD, not silent."""
    import warnings
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import device_matrix, generators
    from basic_iterative_solvers_tpu.device_matrix import (
        DeviceELL, GatherFallbackWarning)
    A = generators.scattered_band(300, 6, 50)   # DIA-ineligible pattern
    monkeypatch.setattr(device_matrix, "LANE_ELL_MAX_SPAN", 0)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, harness="fused")
    with pytest.warns(GatherFallbackWarning, match="plain ELL gather path"):
        setup = bis.preprocessing(A, cfg)
    assert isinstance(setup.A, DeviceELL)


def test_auto_rcm_off_leaves_ordering(monkeypatch):
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu import device_matrix, generators
    from basic_iterative_solvers_tpu.device_matrix import DeviceELL
    A = generators.scattered_band(300, 6, 50)
    monkeypatch.setattr(device_matrix, "LANE_ELL_MAX_SPAN", 0)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, harness="fused",
                           auto_rcm=False)
    setup = bis.preprocessing(A, cfg)
    assert isinstance(setup.A, DeviceELL)
    assert setup.inv_perm is None
