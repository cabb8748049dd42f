"""Native C++ host layer (csrc/bis_host.cpp) vs NumPy fallback parity.

Each binding must produce byte-identical results to the NumPy oracle in
factor.py / matrix.py / io/mmio.py.  Skipped when the library can't build.
"""
import io

import numpy as np
import pytest

from basic_iterative_solvers_tpu import _native, generators
from basic_iterative_solvers_tpu.matrix import MatrixCOO, MatrixCSR

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native library unavailable")


@pytest.fixture
def A():
    return generators.anderson(5, 4, 3, ranpot=6.0, seed=9)


def test_parse_triplets():
    text = "% a comment\n1 2 3.5\n\n2 1 -1e-3\n% mid comment\n3 3 7\n"
    I, J, V = _native.parse_triplets(text, 3, with_value=True)
    np.testing.assert_array_equal(I, [0, 1, 2])
    np.testing.assert_array_equal(J, [1, 0, 2])
    np.testing.assert_allclose(V, [3.5, -1e-3, 7.0])
    I, J, V = _native.parse_triplets("2 3\n4 5\n", 2, with_value=False,
                                     pattern_value=0.01)
    np.testing.assert_array_equal(I, [1, 3])
    np.testing.assert_allclose(V, [0.01, 0.01])
    with pytest.raises(ValueError):
        _native.parse_triplets("1 x 3\n", 1, with_value=True)


def test_coo_to_csr_matches_numpy(A, monkeypatch):
    rng = np.random.default_rng(3)
    n = 40
    nnz = 300
    # random COO with guaranteed-unique (i, j)
    flat = rng.choice(n * n, size=nnz, replace=False)
    I, J = (flat // n).astype(np.int32), (flat % n).astype(np.int32)
    V = rng.standard_normal(nnz)
    coo = MatrixCOO.from_arrays(I, J, V, n_rows=n, n_cols=n)
    row_ptr, col, val = _native.coo_to_csr(nnz, n, n, I, J, V)
    # numpy oracle
    perm = np.lexsort((J, I))
    counts = np.bincount(I, minlength=n)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=rp[1:])
    np.testing.assert_array_equal(row_ptr, rp)
    np.testing.assert_array_equal(col, J[perm])
    np.testing.assert_allclose(val, V[perm])
    # duplicates rejected
    I2 = np.array([1, 1], dtype=np.int32)
    J2 = np.array([2, 2], dtype=np.int32)
    with pytest.raises(ValueError):
        _native.coo_to_csr(2, n, n, I2, J2, np.ones(2))


def test_split_lu_matches_numpy(A, monkeypatch):
    native = _native.split_lu(A)
    monkeypatch.setenv("BIS_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    from basic_iterative_solvers_tpu.factor import split_LU
    ref = split_LU(A)
    for Mn, Mr in zip(native, ref):
        np.testing.assert_array_equal(Mn.row_ptr, Mr.row_ptr)
        np.testing.assert_array_equal(Mn.col, Mr.col)
        np.testing.assert_allclose(Mn.val, Mr.val, rtol=0)


def test_peel_diag_and_errors(A):
    D = _native.peel_diag(A, 1e-16, True, False)
    np.testing.assert_allclose(D, A.diagonal())
    from basic_iterative_solvers_tpu.factor import (MissingDiagonalError,
                                                    ZeroDiagonalError)
    no_diag = MatrixCSR.from_dense(np.array([[0.0, 1.0], [1.0, 1.0]]))
    with pytest.raises(MissingDiagonalError):
        _native.peel_diag(no_diag, 1e-16, True, False)
    tiny = MatrixCSR.from_dense(np.array([[1e-20, 1.0], [1.0, 1.0]]))
    with pytest.raises(ZeroDiagonalError):
        _native.peel_diag(tiny, 1e-16, True, True)


def test_ilu0_matches_numpy(A, monkeypatch):
    native_val = _native.ilu0(A, 1e-8, 1e-4)
    # run the pure-python fallback loop on a copy
    monkeypatch.setenv("BIS_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    from basic_iterative_solvers_tpu.factor import factor_ilu0, _assemble_ilu0
    ref = factor_ilu0(A, 1e-8, 1e-4)
    got = _assemble_ilu0(A, native_val)
    for Mn, Mr in zip(got[:2] + got[3:5], ref[:2] + ref[3:5]):
        np.testing.assert_array_equal(Mn.col, Mr.col)
        np.testing.assert_allclose(Mn.val, Mr.val, rtol=0, atol=0)


def test_level_sets_match_numpy(A, monkeypatch):
    from basic_iterative_solvers_tpu.factor import split_LU
    _, Ls, _, Us = split_LU(A)
    nat_lo = _native.level_sets(Ls)
    nat_hi = _native.level_sets_upper(Us)
    monkeypatch.setenv("BIS_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    from basic_iterative_solvers_tpu.factor import (level_sets_lower,
                                                    level_sets_upper)
    np.testing.assert_array_equal(nat_lo, level_sets_lower(Ls))
    np.testing.assert_array_equal(nat_hi, level_sets_upper(Us))


def test_spmv_matches_numpy(A):
    x = np.random.default_rng(4).standard_normal(A.n_rows)
    np.testing.assert_allclose(_native.spmv_csr(A, x), A.to_dense() @ x,
                               rtol=1e-13)


def test_read_mtx_native_path(tmp_path):
    """read_mtx goes through bis_parse_triplets + bis_coo_to_csr when the
    library is loaded; result must match the known matrix."""
    from basic_iterative_solvers_tpu.io import read_mtx
    path = tmp_path / "t.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "% comment\n3 3 4\n1 1 2.0\n2 2 2.0\n3 3 2.0\n2 1 -1.0\n")
    A = read_mtx(str(path))
    expect = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, 0.0], [0.0, 0.0, 2.0]])
    np.testing.assert_allclose(A.to_dense(), expect)


# ---------------------------------------------------------------------------
# Superblock builder fast paths (bis_hpcg_csr / bis_expand_perm_triplets /
# bis_sb_analyze[_csr] / bis_sb_scatter[_csr]) vs the NumPy oracles.
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(not _native.available(),
                                  reason="native library unavailable")


def _assert_sb_equal(Ba, Bb):
    assert type(Ba) is type(Bb)
    assert Ba.levels == Bb.levels
    assert (Ba.R_b, Ba.TB, Ba.S, Ba.m, Ba.sx, Ba.fused) == \
        (Bb.R_b, Bb.TB, Bb.S, Bb.m, Bb.sx, Bb.fused)
    for fa, fb in ((Ba.vals_cross, Bb.vals_cross),
                   (Ba.vals_self, Bb.vals_self)):
        for a, b in zip(fa, fb):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(Ba.dinv, Bb.dinv):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if Ba.d is not None or Bb.d is not None:
        for a, b in zip(Ba.d, Bb.d):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@needs_native
def test_hpcg_csr_native_matches_numpy(monkeypatch):
    A1 = generators.stencil_27pt(6, 5, 4)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    A2 = generators.stencil_27pt(6, 5, 4)
    np.testing.assert_array_equal(A1.row_ptr, A2.row_ptr)
    np.testing.assert_array_equal(A1.col, A2.col)
    np.testing.assert_array_equal(A1.val, A2.val)


@needs_native
def test_expand_perm_triplets_matches_numpy(monkeypatch):
    from basic_iterative_solvers_tpu.factor import (
        factor_ilu0_colored_triplets)
    from basic_iterative_solvers_tpu.ops.block_trisolve import spec_colors_np
    src = "hpcg:6x4x8"
    A = generators.from_source(src)
    spec = generators.color_spec_for_source(src)
    colors = spec_colors_np(spec, A.n_rows)
    r1, c1, v1, d1 = factor_ilu0_colored_triplets(A, colors)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    r2, c2, v2, d2 = factor_ilu0_colored_triplets(A, colors)
    np.testing.assert_array_equal(np.asarray(r1, np.int64), r2)
    np.testing.assert_array_equal(np.asarray(c1, np.int64), c2)
    np.testing.assert_allclose(v1, v2, rtol=1e-14)
    np.testing.assert_allclose(d1, d2, rtol=1e-14)


@needs_native
@pytest.mark.parametrize("src", ["hpcg:8x6x8", "hpcg:6x4x8"],
                         ids=["fused", "split"])
def test_superblock_builder_native_matches_numpy(src):
    import basic_iterative_solvers_tpu.ops.block_trisolve as BT
    from basic_iterative_solvers_tpu.factor import (
        factor_ilu0_colored_triplets)
    A = generators.from_source(src)
    spec = generators.color_spec_for_source(src)
    colors = BT.spec_colors_np(spec, A.n_rows)
    rows_o, cols_o, lu, U_D = factor_ilu0_colored_triplets(A, colors)
    trip = (rows_o, cols_o, lu, A.n_rows)
    Ln, Un = BT.build_best_trisolve_pair(trip, None, U_D, colors, spec,
                                         dtype=np.float64)
    BT.FORCE_NUMPY = True
    try:
        Lp, Up = BT.build_best_trisolve_pair(trip, None, U_D, colors, spec,
                                             dtype=np.float64)
    finally:
        BT.FORCE_NUMPY = False
    _assert_sb_equal(Ln, Lp)
    _assert_sb_equal(Un, Up)


@needs_native
def test_superblock_sgs_pair_native_matches_numpy():
    import basic_iterative_solvers_tpu.ops.block_trisolve as BT
    src = "hpcg:8x6x8"
    A = generators.from_source(src)
    spec = generators.color_spec_for_source(src)
    colors = BT.spec_colors_np(spec, A.n_rows)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    D = np.zeros(A.n_rows)
    D[rows[A.col == rows]] = A.val[A.col == rows]
    Ln, Un = BT.build_best_trisolve_pair(A, D, D, colors, spec,
                                         dtype=np.float32, need_d=True)
    BT.FORCE_NUMPY = True
    try:
        Lp, Up = BT.build_best_trisolve_pair(A, D, D, colors, spec,
                                             dtype=np.float32, need_d=True)
    finally:
        BT.FORCE_NUMPY = False
    _assert_sb_equal(Ln, Lp)
    _assert_sb_equal(Un, Up)


@needs_native
def test_ilu0_csr_direct_pair_matches_triplet_path():
    """The two-pass CSR-direct ILU(0) pair (bis_sb_*_csr) equals the
    triplet-pipeline pair bit for bit."""
    import basic_iterative_solvers_tpu as bis
    import basic_iterative_solvers_tpu.ops.block_trisolve as BT
    from basic_iterative_solvers_tpu.factor import (
        factor_ilu0_colored_triplets)
    from basic_iterative_solvers_tpu.precond import setup_preconditioner
    src = "hpcg:8x6x8"
    A = generators.from_source(src)
    spec = generators.color_spec_for_source(src)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           preconditioner=bis.PrecondType.ILU0,
                           gs_mode="colored", dtype=np.float64,
                           color_spec=spec)
    M = setup_preconditioner(A, cfg)
    assert M.L_block is not None
    colors = BT.spec_colors_np(spec, A.n_rows)
    rows_o, cols_o, lu, U_D = factor_ilu0_colored_triplets(A, colors)
    L2, U2 = BT.build_best_trisolve_pair((rows_o, cols_o, lu, A.n_rows),
                                         None, U_D, colors, spec,
                                         dtype=np.float64)
    _assert_sb_equal(M.L_block, L2)
    _assert_sb_equal(M.U_block, U2)


@needs_native
def test_gs_csr_direct_pair_matches_generic():
    """The two-pass CSR-direct GS pair equals the generic builder pair."""
    import basic_iterative_solvers_tpu.ops.block_trisolve as BT
    src = "hpcg:8x6x8"
    A = generators.from_source(src)
    spec = generators.color_spec_for_source(src)
    colors = BT.spec_colors_np(spec, A.n_rows)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    D = np.zeros(A.n_rows)
    D[rows[A.col == rows]] = A.val[A.col == rows]
    Ln, Un = BT.build_superblock_gs_pair_from_csr(A, D, spec,
                                                  dtype=np.float64,
                                                  need_d=True)
    Lg, Ug = BT.build_best_trisolve_pair(A, D, D, colors, spec,
                                         dtype=np.float64, need_d=True)
    _assert_sb_equal(Ln, Lg)
    _assert_sb_equal(Un, Ug)


@needs_native
def test_permute_factor_csr_matches_two_pass():
    """The fused bis_permute_factor_csr (one sweep) is bit-identical to
    bis_permute_csr followed by bis_ilu0 — pattern and factored values."""
    from basic_iterative_solvers_tpu.coloring import (colors_to_perm,
                                                      greedy_coloring)
    from basic_iterative_solvers_tpu.factor import _ilu0_values
    A = generators.anderson(6, 5, 4, ranpot=6.0, seed=11)
    colors = greedy_coloring(A)
    perm, inv = colors_to_perm(colors)
    Ap_ref = _native.permute_csr(A, perm, inv)
    lu_ref = _ilu0_values(Ap_ref, 1e-8, 1e-4)
    Ap, lu = _native.permute_factor_csr(A, perm, inv, 1e-8, 1e-4)
    np.testing.assert_array_equal(Ap.row_ptr, Ap_ref.row_ptr)
    np.testing.assert_array_equal(Ap.col, Ap_ref.col)
    np.testing.assert_array_equal(lu, lu_ref)          # exact: same op order
    assert Ap.val is lu                                # no extra value copy


@needs_native
def test_permute_factor_csr_missing_diagonal():
    from basic_iterative_solvers_tpu.factor import MissingDiagonalError
    # 2x2 with no (1,1) entry; identity permutation
    A = MatrixCSR(2, 2, 3, np.array([0, 2, 3], dtype=np.int64),
                  np.array([0, 1, 0], dtype=np.int32),
                  np.array([2.0, 1.0, 1.0]))
    ident = np.arange(2, dtype=np.int32)
    with pytest.raises(MissingDiagonalError, match="row 1"):
        _native.permute_factor_csr(A, ident, ident, 1e-8, 1e-4)


@needs_native
def test_csr_pattern_stats_matches_numpy():
    """One-pass C stats equal the NumPy analyze_diagonals / lane_ell_span."""
    for src in ("sband:3000,6,200", "hpcg:8x6x8", "band:500,3"):
        A = generators.from_source(src)
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz())
        offs_ref = np.unique(A.col.astype(np.int64) - rows)
        span_ref = int(np.abs(A.col.astype(np.int64) // 128
                              - rows // 128).max())
        offs, span, sorted_ok = _native.csr_pattern_stats(A, cap=10000)
        np.testing.assert_array_equal(offs, offs_ref)
        assert span == span_ref and sorted_ok
    # cap overflow signals with offsets=None but still reports span
    A = generators.from_source("sband:3000,6,200")
    offs, span, _ = _native.csr_pattern_stats(A, cap=3)
    assert offs is None and span > 0


@needs_native
def test_lane_ell_native_build_matches_numpy():
    """The two-sweep C lane-ELL pack is bit-identical to the NumPy
    lexsort/scatter builder (values, packed indices, slot ranges)."""
    from basic_iterative_solvers_tpu.ops.lane_ell import csr_to_lane_ell
    for src in ("sband:3000,6,200", "hpcg:8x6x8", "fdm:12"):
        A = generators.from_source(src)
        for dt in (np.float32, np.float64):
            M1 = csr_to_lane_ell(A, dt)
            lib_save, _native._LIB = _native._LIB, None
            try:
                M2 = csr_to_lane_ell(A, dt)
            finally:
                _native._LIB = lib_save
            assert M1.slot_ranges == M2.slot_ranges
            assert (M1.K, M1.S, M1.R, M1.TB) == (M2.K, M2.S, M2.R, M2.TB)
            np.testing.assert_array_equal(np.asarray(M1.vals),
                                          np.asarray(M2.vals))
            np.testing.assert_array_equal(np.asarray(M1.idx),
                                          np.asarray(M2.idx))


@needs_native
def test_csr_to_dia_native_matches_numpy():
    """The one-sweep C DIA pack equals the NumPy searchsorted/scatter."""
    from basic_iterative_solvers_tpu.device_matrix import csr_to_dia
    for src in ("band:500,3", "hpcg:8x6x8", "fdm:12"):
        A = generators.from_source(src)
        for dt in (np.float32, np.float64):
            M1 = csr_to_dia(A, dt)
            lib_save, _native._LIB = _native._LIB, None
            try:
                M2 = csr_to_dia(A, dt)
            finally:
                _native._LIB = lib_save
            assert M1.offsets == M2.offsets
            assert M1.row_tile == M2.row_tile
            np.testing.assert_array_equal(np.asarray(M1.data),
                                          np.asarray(M2.data))


@needs_native
def test_coo_dedup_csr_matches_numpy_pipeline():
    """Stable LSD dedup-sum is bit-identical to the stable-argsort +
    add.at pipeline (scattered_band exercises both)."""
    for n, k, sp, seed in ((3000, 6, 200, 2), (64, 3, 10, 1)):
        A1 = generators.scattered_band(n, k, sp, seed=seed)
        lib_save, _native._LIB = _native._LIB, None
        try:
            A2 = generators.scattered_band(n, k, sp, seed=seed)
        finally:
            _native._LIB = lib_save
        np.testing.assert_array_equal(A1.row_ptr, A2.row_ptr)
        np.testing.assert_array_equal(A1.col, A2.col)
        np.testing.assert_array_equal(A1.val, A2.val)
    # direct: duplicates summed in input order, no-dup inputs unchanged
    I = np.array([1, 0, 1, 1], dtype=np.int32)
    J = np.array([0, 1, 0, 1], dtype=np.int32)
    V = np.array([1.0, 2.0, 3.5, -1.0])
    row_ptr, col, val = _native.coo_dedup_csr(4, 2, 2, I, J, V)
    np.testing.assert_array_equal(row_ptr, [0, 1, 3])
    np.testing.assert_array_equal(col, [1, 0, 1])
    np.testing.assert_allclose(val, [2.0, 4.5, -1.0])


@needs_native
def test_csr_to_ell_native_matches_numpy():
    from basic_iterative_solvers_tpu.device_matrix import csr_to_ell
    for src in ("sband:2000,5,150", "hpcg:8x6x8"):
        A = generators.from_source(src)
        for dt in (np.float32, np.float64):
            M1 = csr_to_ell(A, dt)
            lib_save, _native._LIB = _native._LIB, None
            try:
                M2 = csr_to_ell(A, dt)
            finally:
                _native._LIB = lib_save
            np.testing.assert_array_equal(np.asarray(M1.cols),
                                          np.asarray(M2.cols))
            np.testing.assert_array_equal(np.asarray(M1.data),
                                          np.asarray(M2.data))
