"""Matrix-free constant-stencil operator.

Every matrix family the reference benchmarks is a constant-coefficient
stencil on a regular grid (HPCG 27-point, FDM Laplacian, Anderson hopping —
reference README.md:3-6, sparse_matrix.hpp:560-735).  The reference
stores them as general CRS because a CPU SpMV doesn't care; on an
accelerator the matrix stream *is* the cost (DIA moves ~4 bytes of matrix
data per nonzero).  A constant stencil needs **zero** matrix traffic:
y[i] = Σ_leg c · x[i+off] with boundary masks computed from index
arithmetic.  The SpMV then reads x and writes y — ~2 vector passes per
application on HPCG-128 instead of ~260 MB of CRS streams.

`DeviceStencil` carries:
  * static legs (dx, dy, dz) with one scalar coefficient each (open
    boundary), and
  * an optional dense diagonal vector (Anderson's random on-site term),
    streamed like a single DIA row.

The L/U "factorization" for preconditioners is leg partitioning by linear
offset sign — the same structural free lunch as dia.dia_split.  Not every
matrix is a constant stencil; this is an opt-in format
(matrix_format="stencil") valid only for generator sources, and
`stencil_to_dia` lowers to DIA for paths that need explicit data (GSPMD
sharding, ELL comparisons).
"""
from __future__ import annotations

import dataclasses
import re
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .device_matrix import MIN_ROW_TILE, DeviceDIA


@partial(jax.tree_util.register_dataclass,
         data_fields=["coeffs", "diag"],
         meta_fields=["legs", "coeff_values", "dims", "n_rows", "n_cols",
                      "row_tile", "planar"])
@dataclasses.dataclass
class DeviceStencil:
    """Constant-coefficient stencil on an open-boundary nx×ny×nz grid.

    coeffs[l] multiplies x at grid offset legs[l] = (dx, dy, dz); when
    `diag` is given it overrides the (0,0,0) leg with a dense vector.
    Rows are x-fastest (i = x + nx*(y + ny*z)), padded to row_tile.
    """

    coeffs: jax.Array                      # (n_legs,) vector dtype
    diag: Optional[jax.Array]              # (npad,) flat / (rows_pad*L,)
                                           # planar, or None
    legs: Tuple[Tuple[int, int, int], ...]
    #: static copies of the coefficients (trace-time constants) — lets the
    #: builders read the values without a device transfer
    coeff_values: Tuple[float, ...]
    dims: Tuple[int, int, int]
    n_rows: int
    n_cols: int
    row_tile: int
    #: when True, SpMV consumes/produces vectors in the planar halo layout
    #: (see `to_planar_vec`) — no per-apply pad/crop.
    planar: bool = False

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def offsets(self) -> Tuple[int, ...]:
        nx, ny, _ = self.dims
        return tuple(sorted({dx + nx * (dy + ny * dz)
                             for (dx, dy, dz) in self.legs}))

    @property
    def nnz_stored(self) -> int:
        # streamed bytes per apply: only the dense diagonal (if any)
        return self.n_rows if self.diag is not None else 0


def _legs_sorted(legs_coeffs):
    return tuple(sorted(legs_coeffs,
                        key=lambda lc: (lc[0][2], lc[0][1], lc[0][0])))


def _row_tile_for_dims(legs, nx, ny, nz) -> int:
    offs = [dx + nx * (dy + ny * dz) for (dx, dy, dz) in legs] or [0]
    h = max(0, -min(offs)) + max(0, max(offs))
    return max(MIN_ROW_TILE, -(-h // MIN_ROW_TILE) * MIN_ROW_TILE)


def make_stencil(legs_coeffs, nx: int, ny: int, nz: int, dtype=jnp.float32,
                 diag: Optional[jax.Array] = None) -> DeviceStencil:
    """legs_coeffs: iterable of ((dx, dy, dz), coefficient)."""
    legs_coeffs = [(tuple(l), float(c)) for (l, c) in legs_coeffs
                   if (nx - abs(l[0])) > 0 and (ny - abs(l[1])) > 0
                   and (nz - abs(l[2])) > 0]
    legs_coeffs = _legs_sorted(legs_coeffs)
    legs = tuple(l for (l, _) in legs_coeffs)
    if len(set(legs)) != len(legs):
        raise ValueError("duplicate stencil legs")
    values = tuple(c for (_, c) in legs_coeffs)
    coeffs = jnp.asarray(values, dtype=dtype)
    n = nx * ny * nz
    row_tile = _row_tile_for_dims(legs, nx, ny, nz)
    npad = max(row_tile, -(-n // row_tile) * row_tile)
    if diag is not None:
        d = jnp.zeros(npad, dtype=dtype).at[:n].set(
            jnp.asarray(diag, dtype=dtype))
    else:
        d = None
    return DeviceStencil(coeffs=coeffs, diag=d, legs=legs,
                         coeff_values=values, dims=(nx, ny, nz), n_rows=n,
                         n_cols=n, row_tile=row_tile)


# ---------------------------------------------------------------------------
# SpMV: y[i] = Σ_leg c · x[i + off], each leg a static shifted slice of a
# zero-padded x with its boundary mask from iota arithmetic — XLA fuses the
# whole chain into one loop.
#
# Planar halo layout (planar_vectors="on"): x is kept as a 2-D array
# (rows, L) with lanes = the x grid dimension (padded to L ≥ 128-multiple)
# and row r = (z+1)·(ny+2) + (y+1) — one zero halo row around every plane
# and one zero halo plane at each z end.  The SpMV decodes, applies on the
# flat path and re-encodes.
# ---------------------------------------------------------------------------

#: planar rows are padded to a multiple of this row tile
_ROW_TILE_2D = 1024


def _planar_geometry(A: "DeviceStencil"):
    nx, ny, nz = A.dims
    L = max(128, -(-nx // 128) * 128)
    rows_plane = ny + 2
    rows_total = (nz + 2) * rows_plane
    # drmax floors at the dims-only bound rows_plane+1 (covers any
    # |dy|,|dz| ≤ 1 leg) so L/U leg SUBSETS of a stencil share its planar
    # geometry — planar vectors then flow through splits unchanged.
    drmax = max([rows_plane + 1]
                + [abs(dz) * rows_plane + abs(dy)
                   for (dx, dy, dz) in A.legs])
    TR = max(_ROW_TILE_2D, -(-2 * drmax // _ROW_TILE_2D) * _ROW_TILE_2D)
    rows_pad = -(-rows_total // TR) * TR
    return L, rows_plane, rows_total, drmax, TR, rows_pad


def _to_planar(A, x, L, rows_plane, total_rows, prologue):
    """Flat x (n,) → zero-haloed planar (total_rows, L), data starting at
    row `prologue` (everything else zero)."""
    nx, ny, nz = A.dims
    x3 = x.reshape(nz, ny, nx)
    x3 = jnp.pad(x3, ((1, 1), (1, 1), (0, L - nx)))   # halo planes/rows
    rows = x3.reshape((nz + 2) * rows_plane, L)
    out = jnp.zeros((total_rows, L), dtype=x.dtype)
    return jax.lax.dynamic_update_slice(out, rows, (prologue, 0))


def _from_planar(A, y_rows, L, rows_plane):
    nx, ny, nz = A.dims
    y3 = y_rows[:(nz + 2) * rows_plane].reshape(nz + 2, rows_plane, L)
    return y3[1:nz + 1, 1:ny + 1, :nx].reshape(A.n_rows)


def to_planar_vec(A: "DeviceStencil", x: jax.Array) -> jax.Array:
    """Flat (n,) → planar-resident (rows_pad, L)."""
    L, rows_plane, rows_total, drmax, TR, rows_pad = _planar_geometry(A)
    return _to_planar(A, x, L, rows_plane, rows_pad, 0)


def from_planar_vec(A: "DeviceStencil", xp: jax.Array) -> jax.Array:
    """Planar-resident (rows_pad, L) → flat (n,)."""
    L, rows_plane, rows_total, drmax, TR, rows_pad = _planar_geometry(A)
    return _from_planar(A, xp.reshape(rows_pad, L), L, rows_plane)


def planar_fill_halo(A: "DeviceStencil", xp: jax.Array,
                     value: float) -> jax.Array:
    """Replace halo entries of a planar vector with `value` (e.g. diagonal
    vectors get halo 1.0 so elementwise division keeps halos at zero)."""
    L, rows_plane, rows_total, drmax, TR, rows_pad = _planar_geometry(A)
    mask = _to_planar(A, jnp.ones(A.n_rows, dtype=xp.dtype), L, rows_plane,
                      rows_pad, 0)
    return jnp.where(mask != 0, xp, jnp.asarray(value, xp.dtype))


def to_planar_matrix(A: "DeviceStencil") -> "DeviceStencil":
    """Return A configured for planar-resident vectors (diag re-laid-out)."""
    if A.planar:
        return A
    d = None
    if A.diag is not None:
        d = to_planar_vec(A, A.diag[:A.n_rows])
    return dataclasses.replace(A, diag=d, planar=True)


def stencil_spmv_planar_xla(A: "DeviceStencil", xp: jax.Array) -> jax.Array:
    """Planar-resident semantics: decode, flat apply, re-encode."""
    flat = from_planar_vec(A, xp)
    A_flat = dataclasses.replace(
        A, planar=False,
        diag=(None if A.diag is None else from_planar_vec(A, A.diag)))
    y = stencil_spmv_xla(A_flat, flat)
    return to_planar_vec(A, y)


def _leg_masks(g, legs, nx, ny, nz, n):
    """Boundary-validity mask per leg from the flat row index vector g."""
    i32 = jnp.int32
    xc = jax.lax.rem(g, i32(nx))
    yc = jax.lax.rem(jax.lax.div(g, i32(nx)), i32(ny))
    zc = jax.lax.div(g, i32(nx * ny))
    in_n = g < i32(n)
    ax = {-1: xc > i32(0), 0: None, 1: xc < i32(nx - 1)}
    ay = {-1: yc > i32(0), 0: None, 1: yc < i32(ny - 1)}
    az = {-1: zc > i32(0), 0: None, 1: zc < i32(nz - 1)}
    masks = []
    for (dx, dy, dz) in legs:
        m = in_n
        for part in (ax[dx], ay[dy], az[dz]):
            if part is not None:
                m = m & part
        masks.append(m)
    return masks


def stencil_spmv_xla(A: DeviceStencil, x: jax.Array) -> jax.Array:
    """Flat-vector SpMV: masked shifted adds over a zero-padded x."""
    n = A.n_rows
    nx, ny, nz = A.dims
    offs = A.offsets
    hneg = max(0, -min(offs)) if offs else 0
    hpos = max(0, max(offs)) if offs else 0
    # jnp.pad (not a scatter into zeros) keeps the padded copy fusible and
    # lets GSPMD partition it as neighbour halo exchanges
    xp = jnp.pad(x, (hneg, hpos))
    g = jnp.arange(n, dtype=jnp.int32)
    masks = _leg_masks(g, A.legs, nx, ny, nz, n)
    y = jnp.zeros(n, dtype=x.dtype)
    for l, (dx, dy, dz) in enumerate(A.legs):
        lin = dx + nx * (dy + ny * dz)
        sl = jax.lax.slice(xp, (hneg + lin,), (hneg + lin + n,))
        contrib = jnp.where(masks[l], sl, 0.0)
        coeff = (A.diag[:n] if (lin == 0 and A.diag is not None)
                 else A.coeffs[l])
        y = y + coeff * contrib
    return y


def stencil_spmv(A: DeviceStencil, x: jax.Array) -> jax.Array:
    if A.planar:
        return stencil_spmv_planar_xla(A, x)
    return stencil_spmv_xla(A, x)



# ---------------------------------------------------------------------------
# Structural factorization (split/peel analogs — leg partitioning)
# ---------------------------------------------------------------------------

def stencil_diag(A: DeviceStencil) -> jax.Array:
    """Dense main diagonal (length n, flat layout)."""
    if A.diag is not None:
        if A.planar:
            return from_planar_vec(A, A.diag)
        return A.diag[:A.n_rows]
    for l, leg in enumerate(A.legs):
        if leg == (0, 0, 0):
            return jnp.full(A.n_rows, 1.0, dtype=A.dtype) * A.coeffs[l]
    raise ValueError("stencil has no (0,0,0) leg")


def stencil_diag_vec(A: DeviceStencil) -> jax.Array:
    """The diagonal in A's *vector layout*: flat (n,) normally; planar with
    halo entries set to 1.0 (so elementwise divides/multiplies keep planar
    halos at exactly zero)."""
    d = stencil_diag(A)
    if not A.planar:
        return d
    return planar_fill_halo(A, to_planar_vec(A, d), 1.0)


def stencil_split(A: DeviceStencil):
    """(L_strict, U_strict, D, D_inv) by linear-offset sign of each leg.
    The splits inherit A's vector layout (planar flag); D/D_inv come in the
    vector layout with planar halos at 1.0."""
    nx, ny, _ = A.dims
    has_center = A.diag is not None or (0, 0, 0) in A.legs
    if not has_center:
        raise ValueError("matrix has no stored main diagonal")
    lower, upper = [], []
    coeffs = np.asarray(A.coeffs)
    for l, (dx, dy, dz) in enumerate(A.legs):
        lin = dx + nx * (dy + ny * dz)
        if lin < 0:
            lower.append(((dx, dy, dz), float(coeffs[l])))
        elif lin > 0:
            upper.append(((dx, dy, dz), float(coeffs[l])))
    nxd, nyd, nzd = A.dims
    L = make_stencil(lower, nxd, nyd, nzd, dtype=A.dtype)
    U = make_stencil(upper, nxd, nyd, nzd, dtype=A.dtype)
    if A.planar:
        if (_planar_geometry(L)[4:] != _planar_geometry(A)[4:]
                or _planar_geometry(U)[4:] != _planar_geometry(A)[4:]):
            raise ValueError(
                "stencil split geometry differs from the parent's (legs with "
                "|dy| or |dz| > 1); use planar_vectors='off' for this matrix")
        L = dataclasses.replace(L, planar=True)
        U = dataclasses.replace(U, planar=True)
    if bool(jnp.any(stencil_diag(A) == 0)):
        raise ValueError("zero on the matrix diagonal")
    D = stencil_diag_vec(A)
    return L, U, D, 1.0 / D


def stencil_to_dia(A: DeviceStencil) -> DeviceDIA:
    """Lower to explicit DIA (for GSPMD sharding / format comparisons)."""
    from .dia import _stencil_dia
    nx, ny, nz = A.dims
    coeffs = np.asarray(A.coeffs, dtype=np.float64)
    entries = [(leg, float(coeffs[l])) for l, leg in enumerate(A.legs)]
    M = _stencil_dia(nx, ny, nz, entries, A.dtype)
    if A.diag is not None:
        k0 = M.offsets.index(0)
        d = stencil_diag(A)  # flat (n,), any vector layout
        data = M.data.at[k0, :A.n_rows].set(d)
        M = dataclasses.replace(M, data=data)
    return M


# ---------------------------------------------------------------------------
# Builders / source dispatch
# ---------------------------------------------------------------------------

def stencil_27pt_operator(nx: int, ny: int = None, nz: int = None,
                          diag: float = 26.0, off: float = -1.0,
                          dtype=jnp.float32) -> DeviceStencil:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    legs = [((dx, dy, dz), diag if (dx, dy, dz) == (0, 0, 0) else off)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return make_stencil(legs, nx, ny, nz, dtype=dtype)


def fdm_2d_operator(nx: int, diag: float = -4.0, off: float = 1.0,
                    dtype=jnp.float32) -> DeviceStencil:
    legs = [((0, 0, 0), diag)]
    legs += [((dx, dy, 0), off)
             for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    return make_stencil(legs, nx, nx, 1, dtype=dtype)


def anderson_operator(Lx: int, Ly: int = None, Lz: int = None, t: float = 1.0,
                      ranpot: float = 0.0, seed: int = 1,
                      boundary: str = "open",
                      dtype=jnp.float32) -> DeviceStencil:
    if boundary != "open":
        raise ValueError("stencil operator supports open boundary only; "
                         "use the DIA builder for periodic")
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    legs = [((dx, dy, dz), -t)
            for (dx, dy, dz) in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                 (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    legs.append(((0, 0, 0), 0.0))
    return make_stencil(legs, Lx, Ly, Lz, dtype=dtype,
                        diag=jnp.asarray(eps, dtype=dtype))


_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|anderson):(.*)$", re.IGNORECASE)


def stencil_buildable(source: str) -> bool:
    """True when `from_source_operator` can build this spec (used by the
    CLI/solve_system to auto-upgrade matrix_format for '-p mg')."""
    m = _GEN_RE.match(source)
    if not m:
        return False
    kind = m.group(1).lower()
    if kind == "scamac":
        from .generators import _split_scamac_spec
        return _split_scamac_spec(m.group(2))[0] == "anderson"
    return kind in ("anderson", "hpcg", "fdm")


def from_source_operator(source: str, dtype=jnp.float32) -> DeviceStencil:
    """Matrix-free operator for a generator spec (banded has random
    per-diagonal data → not constant-stencil; use DIA)."""
    m = _GEN_RE.match(source)
    if not m:
        raise ValueError(f"not a stencil-operator source: {source}")
    kind, spec = m.group(1).lower(), m.group(2)
    if kind in ("scamac", "anderson"):
        from .generators import _parse_anderson_kwargs
        return anderson_operator(dtype=dtype, **_parse_anderson_kwargs(spec))
    if kind == "hpcg":
        dims = [int(d) for d in re.split(r"[x,]", spec) if d]
        return stencil_27pt_operator(*dims, dtype=dtype)
    if kind == "fdm":
        return fdm_2d_operator(int(spec), dtype=dtype)
    raise ValueError(f"unknown stencil source: {source}")
