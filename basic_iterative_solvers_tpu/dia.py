"""Device-native DIA construction and factorization.

The reference does all matrix setup on the host: generate/read COO, convert
to CRS, then `split_LU` + `peel_diag_crs` make four more CRS copies and a
dense diagonal (/root/reference/utilities/LU_factors.hpp:122-318,783-878).
That is O(nnz) host passes — cheap on a workstation, but host memory is not
where an accelerator's bandwidth lives.

In DIA form all of that setup is *structural*: the offsets are static
metadata, so

* `peel_diag`  = take the offset-0 data row,
* `split_LU`   = slice the data rows with offsets < 0 (L_strict) and > 0
  (U_strict) — offsets are sorted, so both are contiguous static slices,
* symmetric diagonal scaling = elementwise multiply with shifted scale
  vectors.

None of it moves a byte through the host.  This module also builds the
generator matrices (HPCG 27-point stencil, Anderson, FDM, banded — the
reference's SCAMAC analogs, /root/reference/sparse_matrix.hpp:560-735)
directly on the device with `jnp`: each diagonal's values are a closed-form
function of the row index, so construction is a handful of fused elementwise
ops on the device instead of minutes of host COO/CSR shuffling.
"""
from __future__ import annotations

import re
from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .device_matrix import MIN_ROW_TILE, DeviceDIA


def _row_tile_for(offsets) -> int:
    """Same tile rule as device_matrix.csr_to_dia: ≥ halo, ≥ MIN_ROW_TILE."""
    hneg = int(max(0, -min(offsets))) if len(offsets) else 0
    hpos = int(max(0, max(offsets))) if len(offsets) else 0
    return max(MIN_ROW_TILE, -(-(hneg + hpos) // MIN_ROW_TILE) * MIN_ROW_TILE)


def _npad(n: int, row_tile: int) -> int:
    return max(row_tile, -(-n // row_tile) * row_tile)


# ---------------------------------------------------------------------------
# DIA structural factorization (split_LU / peel_diag / extract_scale analogs)
# ---------------------------------------------------------------------------

def dia_diag(A: DeviceDIA) -> jax.Array:
    """The matrix diagonal as a length-n vector (peel_diag_crs analog,
    /root/reference/utilities/LU_factors.hpp:783-878).  Raises if the offset-0
    diagonal is not stored (the reference aborts on a missing diagonal too,
    common.hpp:388-396)."""
    if 0 not in A.offsets:
        raise ValueError("matrix has no stored main diagonal")
    k0 = A.offsets.index(0)
    return A.data[k0, :A.n_rows]


def dia_split(A: DeviceDIA) -> Tuple[DeviceDIA, DeviceDIA, jax.Array, jax.Array]:
    """(L_strict, U_strict, D, D_inv) by slicing diagonal rows.

    The device split_LU (reference utilities/LU_factors.hpp:122-318):
    offsets are sorted ascending, so the strictly-lower diagonals are a
    prefix of the data rows and the strictly-upper ones a suffix — both
    zero-copy static slices.  The strict parts keep A's row_tile (their halo
    can only shrink).  Zero-diagonal entries raise, matching the reference's
    SanityChecker::zero_diag abort.
    """
    offs = A.offsets
    if 0 not in offs:
        raise ValueError("matrix has no stored main diagonal")
    k0 = offs.index(0)
    n = A.n_rows
    D = A.data[k0, :n]
    if bool(jnp.any(D == 0)):
        raise ValueError("zero on the matrix diagonal")
    D_inv = 1.0 / D
    empty = jnp.zeros((1, A.data.shape[1]), dtype=A.data.dtype)
    L = DeviceDIA(data=A.data[:k0] if k0 else empty,
                  offsets=offs[:k0] if k0 else (),
                  n_rows=n, n_cols=A.n_cols, row_tile=A.row_tile)
    U = DeviceDIA(data=A.data[k0 + 1:] if k0 + 1 < len(offs) else empty,
                  offsets=offs[k0 + 1:],
                  n_rows=n, n_cols=A.n_cols, row_tile=A.row_tile)
    return L, U, D, D_inv


def dia_extract_scale(A: DeviceDIA) -> jax.Array:
    """scale[i] = 1/sqrt(|a_ii|) (extract_scale analog,
    /root/reference/utilities/LU_factors.hpp:880-898)."""
    return 1.0 / jnp.sqrt(jnp.abs(dia_diag(A)))


def dia_scale(A: DeviceDIA, s: jax.Array) -> DeviceDIA:
    """Symmetric diagonal scaling A' = diag(s)·A·diag(s) on device
    (scale_mat analog, /root/reference/preprocessing.hpp:8-24):
    data'[d, i] = s[i] · data[d, i] · s[i + off_d]."""
    npad = A.data.shape[1]
    n = A.n_rows
    hneg = max(0, -min(A.offsets)) if A.offsets else 0
    hpos = max(0, max(A.offsets)) if A.offsets else 0
    sp = jnp.zeros(hneg + npad + hpos, dtype=A.data.dtype)
    sp = sp.at[hneg:hneg + n].set(s.astype(A.data.dtype))
    rows = []
    srow = sp[hneg:hneg + npad]
    for d, off in enumerate(A.offsets):
        shifted = jax.lax.slice(sp, (hneg + off,), (hneg + off + npad,))
        rows.append(A.data[d] * srow * shifted)
    return DeviceDIA(data=jnp.stack(rows), offsets=A.offsets,
                     n_rows=n, n_cols=A.n_cols, row_tile=A.row_tile)


# ---------------------------------------------------------------------------
# Device-side generators
# ---------------------------------------------------------------------------

def _grid_coords(npad: int, nx: int, ny: int):
    i = jnp.arange(npad, dtype=jnp.int32)
    x = i % nx
    y = (i // nx) % ny
    z = i // (nx * ny)
    return i, x, y, z


def _stencil_dia(nx: int, ny: int, nz: int, entries, dtype,
                 periodic: bool = False) -> DeviceDIA:
    """Generic 3-D stencil → DeviceDIA, built on device.

    `entries` is a list of ((dx, dy, dz), value).  Entries are grouped by
    linear offset dx + nx*(dy + ny*dz) (wrap-corrected when periodic) and
    their masked contributions accumulated, so degenerate grids where two
    stencil legs share a diagonal still sum correctly.
    """
    n = nx * ny * nz

    # Group by static linear offset on the host (metadata only, no data).
    # Structurally-empty legs (a stencil direction falling fully outside the
    # grid) are dropped so the offset list matches what the host CSR pipeline
    # discovers from the actual nonzeros (device_matrix.analyze_diagonals).
    def _axis_count(d: int, L: int, kind) -> int:
        if kind == "wrap":
            return min(abs(d), L)
        if kind == "all":
            return L
        return L - abs(d)  # interior span (open boundary or periodic "in")

    groups: Dict[int, List] = {}
    for (dx, dy, dz), v in entries:
        if periodic:
            # A periodic leg contributes at every row, but its linear offset
            # depends on whether the coordinate wraps → split into the
            # interior (no wrap) and wrap parts, each a fixed offset.
            parts = [[], [], []]
            for axis, (d, L) in enumerate(zip((dx, dy, dz), (nx, ny, nz))):
                if d == 0:
                    parts[axis] = [(0, "all")]
                else:
                    parts[axis] = [(d, "in"), (d - int(np.sign(d)) * L, "wrap")]
            for px, kx in parts[0]:
                for py, ky in parts[1]:
                    for pz, kz in parts[2]:
                        cnt = (_axis_count(dx, nx, kx) * _axis_count(dy, ny, ky)
                               * _axis_count(dz, nz, kz))
                        if cnt <= 0:
                            continue
                        off = px + nx * (py + ny * pz)
                        groups.setdefault(off, []).append(
                            ((dx, dy, dz), (kx, ky, kz), v))
        else:
            cnt = ((nx - abs(dx)) * (ny - abs(dy)) * (nz - abs(dz)))
            if cnt <= 0:
                continue
            off = dx + nx * (dy + ny * dz)
            groups.setdefault(off, []).append(((dx, dy, dz), None, v))

    offsets = tuple(sorted(groups))
    row_tile = _row_tile_for(offsets)
    npad = _npad(n, row_tile)

    @partial(jax.jit, static_argnums=())
    def build():
        i, x, y, z = _grid_coords(npad, nx, ny)
        in_range = i < n
        rows = []
        for off in offsets:
            acc = jnp.zeros(npad, dtype=dtype)
            for (dx, dy, dz), wrapkinds, v in groups[off]:
                if periodic:
                    m = in_range
                    for c, d, L, kind in ((x, dx, nx, wrapkinds[0]),
                                          (y, dy, ny, wrapkinds[1]),
                                          (z, dz, nz, wrapkinds[2])):
                        if kind == "all":
                            continue
                        if kind == "in":
                            m = m & (c + d >= 0) & (c + d < L)
                        else:  # wrap: only the boundary layer wraps
                            m = m & ((c + d < 0) | (c + d >= L))
                else:
                    m = (in_range
                         & (x + dx >= 0) & (x + dx < nx)
                         & (y + dy >= 0) & (y + dy < ny)
                         & (z + dz >= 0) & (z + dz < nz))
                acc = acc + jnp.where(m, jnp.asarray(v, dtype), 0)
            rows.append(acc)
        return jnp.stack(rows)

    return DeviceDIA(data=build(), offsets=offsets, n_rows=n, n_cols=n,
                     row_tile=row_tile)


def stencil_27pt_device(nx: int, ny: int = None, nz: int = None,
                        diag: float = 26.0, off: float = -1.0,
                        dtype=jnp.float32) -> DeviceDIA:
    """HPCG 27-point stencil (generators.stencil_27pt), built on device."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    entries = [((dx, dy, dz), diag if (dx, dy, dz) == (0, 0, 0) else off)
               for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return _stencil_dia(nx, ny, nz, entries, dtype)


def fdm_2d_device(nx: int, diag: float = -4.0, off: float = 1.0,
                  dtype=jnp.float32) -> DeviceDIA:
    """2-D 5-point FDM Laplacian (generators.fdm_2d), built on device."""
    entries = [((0, 0, 0), diag)]
    entries += [((dx, dy, 0), off)
                for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    return _stencil_dia(nx, nx, 1, entries, dtype)


def anderson_device(Lx: int, Ly: int = None, Lz: int = None, t: float = 1.0,
                    ranpot: float = 0.0, seed: int = 1,
                    boundary: str = "open", dtype=jnp.float32) -> DeviceDIA:
    """3-D Anderson model (generators.anderson), hopping built on device.

    The random on-site energies use the same host RNG stream as the host
    generator (numpy default_rng(seed)) so both builders produce the *same
    matrix* for a given spec; only the n-element eps vector crosses the host
    boundary.
    """
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    entries = [((dx, dy, dz), -t)
               for (dx, dy, dz) in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                    (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    A = _stencil_dia(Lx, Ly, Lz, entries + [((0, 0, 0), 0.0)], dtype,
                     periodic=(boundary == "periodic"))
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    k0 = A.offsets.index(0)
    data = A.data.at[k0, :n].set(jnp.asarray(eps, dtype=dtype))
    return DeviceDIA(data=data, offsets=A.offsets, n_rows=n, n_cols=n,
                     row_tile=A.row_tile)


def banded_device(n: int, bandwidth: int = 2, seed: int = 0,
                  diag_boost: float = None, dtype=jnp.float32) -> DeviceDIA:
    """Random banded matrix (generators.banded), same host RNG stream —
    the per-diagonal random draws are the only host↔device traffic."""
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-bandwidth, bandwidth + 1))
    row_tile = _row_tile_for(offsets)
    npad = _npad(n, row_tile)
    data = np.zeros((len(offsets), npad), dtype=np.dtype(jnp.dtype(dtype).name))
    for d, off in enumerate(offsets):
        m = n - abs(off)
        rows = np.arange(max(0, -off), max(0, -off) + m)
        vals = rng.uniform(-1.0, 1.0, size=m)
        if off == 0:
            boost = diag_boost if diag_boost is not None else 2.0 * bandwidth + 1.0
            vals = vals + np.sign(vals + (vals == 0)) * boost
        data[d, rows] = vals
    return DeviceDIA(data=jnp.asarray(data), offsets=offsets, n_rows=n,
                     n_cols=n, row_tile=row_tile)


_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|band|anderson):(.*)$", re.IGNORECASE)


def from_source_device(source: str, dtype=jnp.float32) -> DeviceDIA:
    """Device-native counterpart of generators.from_source for generator
    specs (hpcg:/fdm:/band:/scamac:/anderson:).  .mtx paths are not handled
    here — file input goes through the host CSR pipeline."""
    m = _GEN_RE.match(source)
    if not m:
        raise ValueError(f"not a generator spec: {source}")
    kind, spec = m.group(1).lower(), m.group(2)
    if kind in ("scamac", "anderson"):
        from .generators import _parse_anderson_kwargs
        return anderson_device(dtype=dtype, **_parse_anderson_kwargs(spec))
    if kind == "hpcg":
        dims = [int(d) for d in re.split(r"[x,]", spec) if d]
        return stencil_27pt_device(*dims, dtype=dtype)
    if kind == "fdm":
        return fdm_2d_device(int(spec), dtype=dtype)
    if kind == "band":
        dims = [int(d) for d in re.split(r"[x,]", spec) if d]
        return banded_device(*dims, dtype=dtype)
    raise ValueError(f"unknown matrix source: {source}")
