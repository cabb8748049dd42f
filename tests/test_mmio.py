"""Matrix Market I/O tests (reference tier: utility unit tests,
/root/reference/tests/test_utilities.cpp)."""
import io
import os

import numpy as np
import pytest

from basic_iterative_solvers_tpu.io.mmio import (
    MatrixMarketError, read_mtx, read_mtx_coo, write_mtx)
from basic_iterative_solvers_tpu.generators import fdm_2d

GENERAL = """%%MatrixMarket matrix coordinate real general
% comment line
3 3 4
1 1 2.0
2 2 3.0
3 3 4.0
1 3 -1.5
"""

SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 5
1 1 2.0
2 1 -1.0
2 2 2.0
3 2 -1.0
3 3 2.0
"""

PATTERN = """%%MatrixMarket matrix coordinate pattern general
2 2 3
1 1
2 2
2 1
"""


def test_read_general():
    A = read_mtx(io.StringIO(GENERAL))
    dense = A.to_dense()
    expected = np.array([[2.0, 0, -1.5], [0, 3.0, 0], [0, 0, 4.0]])
    np.testing.assert_allclose(dense, expected)


def test_read_symmetric_expands():
    A = read_mtx(io.StringIO(SYMMETRIC))
    dense = A.to_dense()
    expected = np.array([[2.0, -1, 0], [-1, 2, -1], [0, -1, 2.0]])
    np.testing.assert_allclose(dense, expected)
    assert A.nnz == 7  # 5 stored + 2 mirrored off-diagonals


def test_read_pattern_value():
    # pattern entries are valued 0.01 (reference mmio.hpp:178-181)
    A = read_mtx(io.StringIO(PATTERN))
    assert np.all(A.val == 0.01)
    assert A.nnz == 3


def test_bad_banner_rejected():
    with pytest.raises(MatrixMarketError):
        read_mtx(io.StringIO("%%MatrixMarket matrix array real general\n1 1\n2\n"))
    with pytest.raises(MatrixMarketError):
        read_mtx(io.StringIO("%%MatrixMarket matrix coordinate complex general\n"
                             "1 1 1\n1 1 1 0\n"))


def test_nonsquare_rejected_when_required():
    txt = "%%MatrixMarket matrix coordinate real general\n2 3 1\n1 1 1.0\n"
    with pytest.raises(MatrixMarketError):
        read_mtx(io.StringIO(txt), require_square=True)
    A = read_mtx(io.StringIO(txt), require_square=False)
    assert (A.n_rows, A.n_cols) == (2, 3)


def test_roundtrip(tmp_path, rng):
    from basic_iterative_solvers_tpu.generators import banded
    A = banded(20, bandwidth=3, seed=7)
    p = tmp_path / "m.mtx"
    write_mtx(p, A)
    B = read_mtx(p)
    np.testing.assert_allclose(A.to_dense(), B.to_dense(), rtol=1e-15)


REF_FDM = "/root/reference/data/matrices/FDM-2d-16.mtx"


@pytest.mark.skipif(not os.path.exists(REF_FDM),
                    reason="reference fixture not available")
def test_reference_fixture_matches_generator():
    """The in-tree fixture FDM-2d-16.mtx is exactly our fdm_2d(16)."""
    A = read_mtx(REF_FDM)
    B = fdm_2d(16)
    assert A.n_rows == B.n_rows == 256
    assert A.nnz == B.nnz == 1216  # 736 stored, symmetric-expanded
    np.testing.assert_allclose(A.to_dense(), B.to_dense())


def test_surplus_entries_rejected():
    """Both parser paths (native strtol and NumPy fallback) must reject a
    file with MORE data lines than the header declares (ADVICE r1: the
    native path used to silently ignore the surplus)."""
    surplus = GENERAL.replace("3 3 4", "3 3 3")  # header claims 3, file has 4
    with pytest.raises(MatrixMarketError, match="expected 3 entries"):
        read_mtx(io.StringIO(surplus))
    os.environ["BIS_NO_NATIVE"] = "1"
    try:
        import basic_iterative_solvers_tpu._native as _native
        lib, tried = _native._LIB, _native._TRIED
        _native._LIB, _native._TRIED = None, True
        with pytest.raises(MatrixMarketError, match="expected 3 entries"):
            read_mtx(io.StringIO(surplus))
        _native._LIB, _native._TRIED = lib, tried
    finally:
        del os.environ["BIS_NO_NATIVE"]
