"""ctypes bindings for the native C++ host layer (csrc/bis_host.cpp).

The reference's host pipeline is C++ (reference utilities/*.hpp); this
module loads our C++ equivalent as a shared library, compiling it with g++
on first use into csrc/build/.  The library's file name carries a hash of
the source and the host's machine type, so an edited source or a copy
moved to another kind of host builds afresh instead of loading a stale or
foreign binary; it is compiled for the generic target of the machine type
(no -march=native).  Every binding has a NumPy fallback at its call site,
so the framework works (slower) without a C++ toolchain; set
BIS_NO_NATIVE=1 to force the fallbacks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SRC = os.path.join(_CSRC, "bis_host.cpp")
_BUILD_DIR = os.path.join(_CSRC, "build")
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def so_path(src: str = _SRC) -> str:
    """Build output for `src`: keyed on the source bytes, the compile
    flags and the host's machine type."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libbis_host-{platform.machine()}-"
                                    f"{h.hexdigest()[:16]}.so")


def _build(src: str, out: str) -> bool:
    """Compile to a temporary file, then rename: concurrent builders
    (parallel test workers) never see a half-written library."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, src],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("BIS_NO_NATIVE") or not os.path.exists(_SRC):
        return None
    so = so_path()
    if not os.path.exists(so) and not _build(_SRC, so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.bis_parse_triplets.restype = ctypes.c_longlong
    lib.bis_parse_triplets.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_double, _i32p, _i32p, _f64p]
    lib.bis_coo_to_csr.restype = ctypes.c_int
    lib.bis_coo_to_csr.argtypes = [
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
    lib.bis_coo_dedup_csr.restype = ctypes.c_longlong
    lib.bis_coo_dedup_csr.argtypes = [
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
    lib.bis_split_lu_count.restype = None
    lib.bis_split_lu_count.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _i64p, _i64p, _i64p, _i64p]
    lib.bis_split_lu_fill.restype = None
    lib.bis_split_lu_fill.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _f64p]
        + [_i64p, _i32p, _f64p] * 4)
    lib.bis_peel_diag.restype = ctypes.c_longlong
    lib.bis_peel_diag.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_double, ctypes.c_int,
        _f64p, _i64p]
    lib.bis_ilu0.restype = ctypes.c_longlong
    lib.bis_ilu0.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i64p, _i32p, _f64p,
        ctypes.c_double, ctypes.c_double]
    lib.bis_level_sets.restype = None
    lib.bis_level_sets.argtypes = [ctypes.c_int32, _i64p, _i32p,
                                   ctypes.c_int, _i32p]
    lib.bis_spmv_csr.restype = None
    lib.bis_spmv_csr.argtypes = [ctypes.c_int32, _i64p, _i32p, _f64p,
                                 _f64p, _f64p]
    lib.bis_greedy_color.restype = ctypes.c_longlong
    lib.bis_greedy_color.argtypes = [ctypes.c_int32, _i64p, _i32p,
                                     ctypes.c_int, _i32p]
    lib.bis_bfs_perm.restype = None
    lib.bis_bfs_perm.argtypes = [ctypes.c_int32, _i64p, _i32p, ctypes.c_int,
                                 ctypes.c_int, _i32p]
    lib.bis_permute_csr.restype = None
    lib.bis_permute_csr.argtypes = [ctypes.c_int32, _i64p, _i32p, _f64p,
                                    _i32p, _i32p, _i64p, _i32p, _f64p]
    lib.bis_permute_factor_csr.restype = ctypes.c_longlong
    lib.bis_permute_factor_csr.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i32p, _i32p,
        ctypes.c_double, ctypes.c_double, _i64p, _i32p, _f64p]
    lib.bis_csr_to_ell_pack.restype = None
    lib.bis_csr_to_ell_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_longlong,
        ctypes.c_int, _i32p, ctypes.c_void_p]
    lib.bis_csr_to_dia_pack.restype = None
    lib.bis_csr_to_dia_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i64p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bis_csr_pattern_stats.restype = ctypes.c_longlong
    lib.bis_csr_pattern_stats.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i64p, _i32p, ctypes.c_longlong,
        _i64p, _i64p]
    lib.bis_lane_ell_ranges.restype = ctypes.c_longlong
    lib.bis_lane_ell_ranges.argtypes = [
        ctypes.c_int32, _i64p, _i32p, ctypes.c_int32, _i32p, _i32p]
    lib.bis_lane_ell_pack.restype = None
    lib.bis_lane_ell_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_longlong, _i32p, ctypes.c_int, ctypes.c_void_p, _i32p]
    lib.bis_hpcg_csr.restype = None
    lib.bis_hpcg_csr.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_double,
                                 ctypes.c_double, _i64p, _i32p, _f64p]
    lib.bis_expand_perm_triplets.restype = None
    lib.bis_expand_perm_triplets.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i32p, _i32p, _i32p, _f64p]
    lib.bis_sb_analyze.restype = ctypes.c_longlong
    lib.bis_sb_analyze.argtypes = (
        [ctypes.c_longlong, _i32p, _i32p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_longlong, _i64p, _i64p, _i64p, _i64p, _i64p])
    lib.bis_sb_scatter.restype = ctypes.c_longlong
    lib.bis_sb_scatter.argtypes = (
        [ctypes.c_longlong, _i32p, _i32p, _f64p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_int, _i64p, ctypes.c_int32, _i64p, ctypes.c_int32,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p])
    lib.bis_sb_analyze_csr.restype = ctypes.c_longlong
    lib.bis_sb_analyze_csr.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _i32p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_longlong, _i64p, _i64p, _i64p, _i64p, _i64p])
    lib.bis_sb_scatter_csr.restype = ctypes.c_longlong
    lib.bis_sb_scatter_csr.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _f64p, _i32p]
        + [ctypes.c_int32] * 6
        + [_i64p, ctypes.c_int32] * 4
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [_f64p])
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _as(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def parse_triplets(data_text: str, nnz_stored: int, with_value: bool,
                   pattern_value: float = 0.01):
    """Parse 'i j [v]' lines -> (I, J, V) 0-based, or None if the native
    library is unavailable.  Asks the parser for nnz_stored + 1 entries so a
    file with MORE data lines than its header declares yields a count the
    caller's exact-count check rejects — matching the NumPy fallback, which
    parses everything and raises on a surplus."""
    lib = _load()
    if lib is None:
        return None
    buf = data_text.encode()
    cap = nnz_stored + 1
    I = np.empty(cap, dtype=np.int32)
    J = np.empty(cap, dtype=np.int32)
    V = np.empty(cap, dtype=np.float64)
    got = lib.bis_parse_triplets(buf, len(buf), cap,
                                 1 if with_value else 0, pattern_value,
                                 I, J, V)
    if got < 0:
        raise ValueError("malformed matrix market entry")
    return I[:got], J[:got], V[:got]


def coo_to_csr(nnz, n_rows, n_cols, I, J, V):
    """(row_ptr, col, val) row-major sorted, or None. Raises on duplicates."""
    lib = _load()
    if lib is None:
        return None
    I, J, V = _as(I, np.int32), _as(J, np.int32), _as(V, np.float64)
    row_ptr = np.empty(n_rows + 1, dtype=np.int64)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    rc = lib.bis_coo_to_csr(nnz, n_rows, n_cols, I, J, V, row_ptr, col, val)
    if rc == -2:
        raise ValueError("duplicate (row, col) entries in COO matrix")
    if rc != 0:
        raise ValueError("COO indices out of range")
    return row_ptr, col, val


def coo_dedup_csr(nnz, n_rows, n_cols, I, J, V):
    """CSR with duplicate (i,j) entries summed in input order (stable LSD
    sorts — bit-identical to a stable argsort + add.at pipeline), or None.
    Returns (row_ptr, col, val) with the deduplicated nnz."""
    lib = _load()
    if lib is None:
        return None
    I, J, V = _as(I, np.int32), _as(J, np.int32), _as(V, np.float64)
    row_ptr = np.empty(n_rows + 1, dtype=np.int64)
    col = np.empty(max(1, nnz), dtype=np.int32)
    val = np.empty(max(1, nnz), dtype=np.float64)
    out = lib.bis_coo_dedup_csr(nnz, n_rows, n_cols, I, J, V,
                                row_ptr, col, val)
    if out < 0:
        raise ValueError("COO indices out of range")
    return row_ptr, col[:out].copy(), val[:out].copy()


def split_lu(A):
    """Native split into (L, L_strict, U, U_strict) MatrixCSR, or None."""
    lib = _load()
    if lib is None:
        return None
    from .matrix import MatrixCSR
    n = A.n_rows
    rp = _as(A.row_ptr, np.int64)
    cl = _as(A.col, np.int32)
    vl = _as(A.val, np.float64)
    ptrs = [np.empty(n + 1, dtype=np.int64) for _ in range(4)]
    lib.bis_split_lu_count(n, rp, cl, *ptrs)
    outs = []
    args = [n, rp, cl, vl]
    for ptr in ptrs:
        nnz = int(ptr[-1])
        c = np.empty(nnz, dtype=np.int32)
        v = np.empty(nnz, dtype=np.float64)
        outs.append((ptr, c, v))
        args += [ptr, c, v]
    lib.bis_split_lu_fill(*args)
    return tuple(MatrixCSR(n, A.n_cols, int(p[-1]), p, c, v)
                 for (p, c, v) in outs)


def peel_diag(A, zero_tol: float, check_missing: bool, check_zero: bool):
    """Dense diagonal of A, or None.  Raises the factor.py exception types
    on missing/zero diagonals (mapped from the C error codes)."""
    lib = _load()
    if lib is None:
        return None
    D = np.empty(A.n_rows, dtype=np.float64)
    bad_row = np.empty(1, dtype=np.int64)
    flags = (1 if check_missing else 0) | (2 if check_zero else 0)
    rc = lib.bis_peel_diag(A.n_rows, _as(A.row_ptr, np.int64),
                           _as(A.col, np.int32), _as(A.val, np.float64),
                           zero_tol, flags, D, bad_row)
    if rc < 0:
        from .factor import MissingDiagonalError, ZeroDiagonalError
        if rc == -4:
            raise ZeroDiagonalError(
                f"ERROR: Zero diagonal element in row {int(bad_row[0])}")
        if rc == -3:
            raise MissingDiagonalError(
                f"ERROR: No diagonal element found in row {int(bad_row[0])}")
        raise RuntimeError(f"bis_peel_diag failed with code {rc}")
    return D


def ilu0(A, pivot_tolerance: float, pivot_replacement: float):
    """In-pattern ILU(0) values (modified copy of A.val), or None."""
    lib = _load()
    if lib is None:
        return None
    lu_val = _as(A.val, np.float64).copy()
    rc = lib.bis_ilu0(A.n_rows, A.n_cols, _as(A.row_ptr, np.int64),
                      _as(A.col, np.int32), lu_val,
                      pivot_tolerance, pivot_replacement)
    if rc < 0:
        from .factor import MissingDiagonalError
        raise MissingDiagonalError(
            "ERROR: ILU(0) requires a full diagonal; missing in row "
            f"{-rc - 1000}")
    return lu_val


def level_sets(T_strict, upper: bool = False):
    """Wavefront level per row, or None."""
    lib = _load()
    if lib is None:
        return None
    level = np.empty(T_strict.n_rows, dtype=np.int32)
    lib.bis_level_sets(T_strict.n_rows, _as(T_strict.row_ptr, np.int64),
                       _as(T_strict.col, np.int32), 1 if upper else 0, level)
    return level


def level_sets_upper(T_strict):
    return level_sets(T_strict, upper=True)


def greedy_color(A, balanced: bool):
    """Greedy (first-fit / balanced) coloring of the CSR graph, or None."""
    lib = _load()
    if lib is None:
        return None
    colors = np.empty(A.n_rows, dtype=np.int32)
    lib.bis_greedy_color(A.n_rows, _as(A.row_ptr, np.int64),
                         _as(A.col, np.int32), 1 if balanced else 0, colors)
    return colors


def bfs_perm(A, reverse: bool, sort_by_degree: bool):
    """BFS/RCM ordering (perm[new] = old), or None."""
    lib = _load()
    if lib is None:
        return None
    perm = np.empty(A.n_rows, dtype=np.int32)
    lib.bis_bfs_perm(A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
                     1 if reverse else 0, 1 if sort_by_degree else 0, perm)
    return perm


def csr_to_ell_pack(A, K: int, dtype):
    """(data, cols) padded-row ELL planes in one C sweep, or None."""
    lib = _load()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    cols = np.zeros((A.n_rows, K), dtype=np.int32)
    data = np.zeros((A.n_rows, K), dtype=dt)
    lib.bis_csr_to_ell_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), K, 1 if dt == np.dtype(np.float32) else 0,
        cols, data.ctypes.data_as(ctypes.c_void_p))
    return data, cols


def csr_to_dia_pack(A, offsets, npad: int, dtype):
    """(n_diags, npad) DIA data planes in one C sweep, or None."""
    lib = _load()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    offsets = _as(np.asarray(offsets), np.int64)
    data = np.zeros((max(1, len(offsets)), npad), dtype=dt)
    lib.bis_csr_to_dia_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), offsets, len(offsets), npad,
        1 if dt == np.dtype(np.float32) else 0,
        data.ctypes.data_as(ctypes.c_void_p))
    return data


def csr_pattern_stats(A, cap: int = 4096):
    """One-pass pattern stats: (offsets | None-if-more-than-cap, span,
    sorted_ok) — the fused form of analyze_diagonals + lane_ell_span.
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    offs = np.empty(max(1, cap), dtype=np.int64)
    stats = np.zeros(3, dtype=np.int64)
    lib.bis_csr_pattern_stats(A.n_rows, A.n_cols, _as(A.row_ptr, np.int64),
                              _as(A.col, np.int32), cap, offs, stats)
    n_diags = int(stats[0])
    return ((offs[:n_diags].copy() if n_diags >= 0 else None),
            int(stats[1]), bool(stats[2]))


def lane_ell_build(A, K: int, S: int, R_pad: int, dtype):
    """Lane-ELL planes (vals, idx, slot_ranges) straight off the CSR in two
    C sweeps (no global lexsort, no fancy scatter).  None when unavailable
    or the columns are not ascending (NumPy path handles those)."""
    lib = _load()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    lo = np.empty(K, dtype=np.int32)
    hi = np.empty(K, dtype=np.int32)
    if lib.bis_lane_ell_ranges(A.n_rows, _as(A.row_ptr, np.int64),
                               _as(A.col, np.int32), K, lo, hi) != 0:
        return None
    vals = np.empty((K, R_pad, 128), dtype=dt)
    idx = np.empty((K, R_pad, 128), dtype=np.int32)
    lib.bis_lane_ell_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), K, S, R_pad, lo,
        1 if dt == np.dtype(np.float32) else 0,
        vals.ctypes.data_as(ctypes.c_void_p), idx)
    ranges = tuple((int(a), int(b)) for a, b in zip(lo, hi))
    return vals, idx, ranges


def permute_factor_csr(A, perm, inv_perm, pivot_tolerance: float,
                       pivot_replacement: float):
    """Fused P A P^T + in-pattern ILU(0): (Ap, lu_val) where Ap is the
    permuted CSR whose .val IS the factored value array — one C sweep
    instead of permute + copy + factor (3x the memory passes on the
    throttled host).  None when the library is unavailable; raises
    MissingDiagonalError like ilu0."""
    lib = _load()
    if lib is None or A.n_rows != A.n_cols:
        return None
    from .matrix import MatrixCSR
    row_ptr = np.empty(A.n_rows + 1, dtype=np.int64)
    col = np.empty(A.nnz, dtype=np.int32)
    lu_val = np.empty(A.nnz, dtype=np.float64)
    perm = _as(perm, np.int32)
    rc = lib.bis_permute_factor_csr(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), perm, _as(inv_perm, np.int32),
        pivot_tolerance, pivot_replacement, row_ptr, col, lu_val)
    if rc < 0:
        from .factor import MissingDiagonalError
        raise MissingDiagonalError(
            "ERROR: ILU(0) requires a full diagonal; missing in row "
            f"{int(perm[int(-rc - 1000)])}")
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr, col, lu_val), lu_val


def permute_csr(A, perm, inv_perm):
    """A' = P A P^T as a new MatrixCSR, or None."""
    lib = _load()
    if lib is None:
        return None
    from .matrix import MatrixCSR
    row_ptr = np.empty(A.n_rows + 1, dtype=np.int64)
    col = np.empty(A.nnz, dtype=np.int32)
    val = np.empty(A.nnz, dtype=np.float64)
    lib.bis_permute_csr(A.n_rows, _as(A.row_ptr, np.int64),
                        _as(A.col, np.int32), _as(A.val, np.float64),
                        _as(perm, np.int32), _as(inv_perm, np.int32),
                        row_ptr, col, val)
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr, col, val)


def spmv_csr(A, x):
    """y = A @ x host oracle, or None."""
    lib = _load()
    if lib is None:
        return None
    y = np.empty(A.n_rows, dtype=np.float64)
    lib.bis_spmv_csr(A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
                     _as(A.val, np.float64), _as(x, np.float64), y)
    return y


def hpcg_csr(nx: int, ny: int, nz: int, diag: float, off: float):
    """27-point stencil CSR (row_ptr, col, val), or None."""
    lib = _load()
    if lib is None:
        return None
    n = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    row_ptr = np.empty(n + 1, dtype=np.int64)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    lib.bis_hpcg_csr(nx, ny, nz, diag, off, row_ptr, col, val)
    return row_ptr, col, val


def expand_perm_triplets(Ap, lu_val, perm):
    """(rows_o, cols_o int32, U_D) for permuted-CSR factor values mapped
    back to the original ordering, or None."""
    lib = _load()
    if lib is None:
        return None
    n = Ap.n_rows
    rows_o = np.empty(Ap.nnz, dtype=np.int32)
    cols_o = np.empty(Ap.nnz, dtype=np.int32)
    U_D = np.zeros(n, dtype=np.float64)
    lib.bis_expand_perm_triplets(n, _as(Ap.row_ptr, np.int64),
                                 _as(Ap.col, np.int32),
                                 _as(lu_val, np.float64),
                                 _as(perm, np.int32), rows_o, cols_o, U_D)
    return rows_o, cols_o, U_D


def sb_analyze(rows, cols, nx, ny, nz, sx, sy, sz, cap: int):
    """One-pass superblock group discovery for BOTH triangles.

    Returns {'cross_lo','self_lo','cross_up','self_up'} ascending int64 key
    arrays; None when the native library is unavailable, the indices exceed
    int32, or a structural check fails (the NumPy builder then re-derives
    the properly ordered error).  Raises ImproperColoringError directly
    (that verdict is scan-order independent)."""
    lib = _load()
    if lib is None or len(rows) and (rows.max() >= 2**31
                                     or cols.max() >= 2**31):
        return None
    rows32 = _as(rows, np.int32)
    cols32 = _as(cols, np.int32)
    bufs = [np.empty(cap, dtype=np.int64) for _ in range(4)]
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.bis_sb_analyze(len(rows32), rows32, cols32, nx, ny, nz,
                            sx, sy, sz, cap, *bufs, counts)
    if rc == -10:
        from .ops.block_trisolve import ImproperColoringError
        raise ImproperColoringError("coloring is not proper for this pattern")
    if rc != 0:
        return None
    keys = ("cross_lo", "self_lo", "cross_up", "self_up")
    return {k: bufs[i][:counts[i]].copy() for i, k in enumerate(keys)}


def sb_analyze_csr(Ap, perm, nx, ny, nz, sx, sy, sz, cap: int):
    """Group discovery straight off the color-permuted CSR (row i of Ap =
    original row perm[i]); same contract as sb_analyze."""
    lib = _load()
    if lib is None or Ap.n_rows >= 2**31:
        return None
    bufs = [np.empty(cap, dtype=np.int64) for _ in range(4)]
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.bis_sb_analyze_csr(Ap.n_rows, _as(Ap.row_ptr, np.int64),
                                _as(Ap.col, np.int32), _as(perm, np.int32),
                                nx, ny, nz, sx, sy, sz, cap, *bufs, counts)
    if rc == -10:
        from .ops.block_trisolve import ImproperColoringError
        raise ImproperColoringError("coloring is not proper for this pattern")
    if rc != 0:
        return None
    keys = ("cross_lo", "self_lo", "cross_up", "self_up")
    return {k: bufs[i][:counts[i]].copy() for i, k in enumerate(keys)}


def sb_scatter_csr(Ap, lu_val, perm, nx, ny, nz, sx, sy, sz, analysis,
                   Rb128_lo: int, Rb128_up: int,
                   pc_lo, ps_lo, pc_up, ps_up) -> "Optional[np.ndarray]":
    """Fill BOTH triangles' (pre-zeroed) group planes and the peeled
    diagonal in one pass over the permuted CSR; returns U_D or None."""
    lib = _load()
    if lib is None:
        return None
    U_D = np.zeros(Ap.n_rows, dtype=np.float64)
    dtype32 = 1 if pc_lo.dtype == np.float32 else 0
    args = []
    for k in ("cross_lo", "self_lo", "cross_up", "self_up"):
        uk = _as(analysis[k], np.int64)
        args += [uk, len(uk)]
    rc = lib.bis_sb_scatter_csr(
        Ap.n_rows, _as(Ap.row_ptr, np.int64), _as(Ap.col, np.int32),
        _as(lu_val, np.float64), _as(perm, np.int32),
        nx, ny, nz, sx, sy, sz, *args, Rb128_lo, Rb128_up, dtype32,
        pc_lo.ctypes.data_as(ctypes.c_void_p),
        ps_lo.ctypes.data_as(ctypes.c_void_p),
        pc_up.ctypes.data_as(ctypes.c_void_p),
        ps_up.ctypes.data_as(ctypes.c_void_p), U_D)
    if rc != 0:
        raise RuntimeError(f"bis_sb_scatter_csr failed with code {rc}")
    return U_D


def sb_scatter(rows, cols, vals, nx, ny, nz, sx, sy, sz, upper: bool,
               ukc, uks, Rb128: int, planes_cross, planes_self) -> bool:
    """Scatter one triangle's values into the (pre-zeroed) group planes
    laid out in ukey order; False when unavailable."""
    lib = _load()
    if lib is None:
        return False
    rows32 = _as(rows, np.int32)
    cols32 = _as(cols, np.int32)
    dtype32 = 1 if planes_cross.dtype == np.float32 else 0
    rc = lib.bis_sb_scatter(
        len(rows32), rows32, cols32, _as(vals, np.float64),
        nx, ny, nz, sx, sy, sz, 1 if upper else 0,
        _as(ukc, np.int64), len(ukc), _as(uks, np.int64), len(uks),
        Rb128, dtype32,
        planes_cross.ctypes.data_as(ctypes.c_void_p),
        planes_self.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"bis_sb_scatter failed with code {rc}")
    return True
