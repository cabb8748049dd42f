"""Blocked multicolor triangular solves: factors stream ONCE per solve.

The colored-sweep form of an exact triangular solve (coloring.py) applies
the FULL operator once per color — #colors SpMV-sized streams per solve.
This module is the traffic-optimal form for SPEC colorings (grid / mod,
where the color-sorted permutation is a pure reshape/transpose): solve in
rank space, where every factor nonzero is read exactly once.

Key structural fact (the reason this is possible without gathers): for a
separable coloring, the color-sorted permutation maps "row j is a pattern
neighbor of row i" to "rank(j) = rank(i) + Δ" with Δ CONSTANT per
(target-color, source-color, pattern-leg) triple.  E.g. HPCG's 27-point
stencil under the 2×2×2 grid coloring: rank = rx + mx·ry + mx·my·rz and a
leg (dx,dy,dz) from color (cx,cy,cz) lands at a fixed rank offset.  So the
strict factor decomposes into a small set of GROUPS (src color, Δ), each a
dense plane of values aligned to target rank slots, and the solve step for
color c is

    x_c = (y_c − Σ_groups vals_g ⊙ shift(x_src(g), Δ_g)) · D_c⁻¹

— pure shifted reads (static row offset + lane rotation), no index arrays,
no gathers.  Per triangular solve the HBM traffic is |T| values + a few
vector passes, vs #colors·|T| for masked sweeps.  The reference can only
run these solves serially (native_sptrsv, reference kernels.hpp:54-117)
or via SMAX level scheduling (smax_helpers.hpp:25-28).

Eligibility (else callers fall back to masked sweeps / level scans):
* spec coloring of kind "grid" (strides dividing the dims) or "mod" —
  the block permutation is then a reshape/transpose, never a gather;
* the distinct (tc, sc, Δ) group count is small (pattern-structured);
* max |Δ| fits the kernel's 3-tile window.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..matrix import MatrixCSR

LANES = 128

#: default row tile (x2 rows per kernel grid step)
_TB = 256

#: refuse patterns whose (tc, sc, Δ) group count explodes (irregular
#: sparsity — the dense planes would be mostly padding)
_MAX_GROUPS = 512

#: test hook: skip the C++ builder fast paths (csrc bis_sb_*) so the NumPy
#: oracles run even when the native library is available
FORCE_NUMPY = False

#: kill-switch for constant-coefficient plane elision (BIS_SB_CONST=0
#: forces plane mode — the A/B lever for the matrix-free trisolve)
import os as _os  # noqa: E402
NO_CONST = _os.environ.get("BIS_SB_CONST", "1") == "0"
#: kill-switch for the aligned-fused any-nx layout (BIS_SB_ALIGNED=0 falls
#: back to the split-parity layout)
NO_ALIGNED = _os.environ.get("BIS_SB_ALIGNED", "1") == "0"
#: kill-switch for the packed-table factor layout (BIS_SB_PACKED=0 keeps
#: full plane slabs for translation-table ILU(0))
NO_PACKED = _os.environ.get("BIS_SB_PACKED", "1") == "0"
#: packed tables only above this row count (capacity sizes; tests
#: monkeypatch this)
PACK_MIN_ROWS = 2 ** 24


class BlockIneligibleError(ValueError):
    """Raised when a matrix/coloring cannot use the blocked form."""


class ImproperColoringError(BlockIneligibleError):
    """The supplied coloring couples same-colored rows — the colors
    themselves are invalid for this matrix (not just the blocked layout);
    callers must recolor, not merely fall back to masked sweeps."""


def _entries_of(T):
    """(rows, cols, vals, n) from a MatrixCSR or a raw triplet tuple
    (rows, cols, vals, n) — the triplet form skips CSR assembly entirely
    (factor.factor_ilu0_colored_triplets).  Integer dtype is preserved
    (int32 triplets stay int32 — half the memory traffic on the throttled
    host; all consumers only index/gather with them)."""
    if isinstance(T, MatrixCSR):
        rows = np.repeat(np.arange(T.n_rows, dtype=np.int64), T.row_nnz())
        return rows, T.col.astype(np.int64), T.val, T.n_rows
    rows, cols, vals, n = T
    return (np.asarray(rows), np.asarray(cols), np.asarray(vals), int(n))


def _group_inverse(key, key_range):
    """np.unique(key, return_inverse=True) via a dense LUT when the key
    domain is small — O(n + range) beats the 27M-entry sort by ~5x on the
    throttled host."""
    if key_range <= (1 << 27):
        present = np.zeros(key_range, dtype=bool)
        present[key] = True
        uniq = np.flatnonzero(present)
        lut = np.zeros(key_range, dtype=np.int32)
        lut[uniq] = np.arange(uniq.size, dtype=np.int32)
        return uniq, lut[key]
    return np.unique(key, return_inverse=True)


def _grid_coords(idx, nx: int, ny: int):
    """(x, y, z) grid coordinates of flat x-fastest row indices.
    Two divmods (4 array passes) instead of %,//,%,// (6) — these run over
    full nnz-sized index arrays on the throttled host."""
    q, x = np.divmod(idx, nx)
    z, y = np.divmod(q, ny)
    return x, y, z


@lru_cache(maxsize=4)
def _spec_colors_cached(spec, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.int32 if n < 2**31 else np.int64)
    if spec.kind == "mod":
        out = (i % spec.params[0]).astype(np.int32)
    elif spec.kind in ("parity", "grid"):
        nx, ny = spec.params[0], spec.params[1]
        x, y, z = _grid_coords(i, nx, ny)
        if spec.kind == "parity":
            out = ((x + y + z) % 2).astype(np.int32)
        else:
            sx, sy, sz = spec.params[3], spec.params[4], spec.params[5]
            out = ((x % sx) + sx * ((y % sy) + sy * (z % sz))).astype(np.int32)
    else:
        raise ValueError(f"unknown color spec kind: {spec.kind}")
    out.flags.writeable = False   # cached: shared across callers
    return out


def spec_colors_np(spec, n: int) -> np.ndarray:
    """NumPy twin of coloring.color_ids for flat row indices.  Memoized —
    one setup computes the same structural coloring 2-3 times (validity
    check, perm build, plane pack), each a multi-pass O(n) host sweep."""
    return _spec_colors_cached(spec, n)


def spec_colors_valid(colors, spec, n: int) -> bool:
    """True iff `colors` is exactly the spec's structural coloring (the
    native builder derives colors arithmetically, so mismatched arrays
    must take the NumPy path)."""
    try:
        return np.array_equal(np.asarray(colors), spec_colors_np(spec, n))
    except Exception:
        return False


def _check_spec(spec, n: int) -> int:
    """Validate separability; return the (padded) per-block slot count m."""
    if spec.kind == "mod":
        return -(-n // spec.params[0])
    if spec.kind == "grid":
        nx, ny, nz, sx, sy, sz = spec.params
        if nx * ny * nz != n:
            raise BlockIneligibleError("grid spec dims do not match n_rows")
        if nx % sx or ny % sy or nz % sz:
            raise BlockIneligibleError("grid strides must divide the dims")
        return n // (sx * sy * sz)
    raise BlockIneligibleError(
        f"blocked trisolve needs a grid/mod coloring, got {spec.kind!r}")


@partial(jax.tree_util.register_dataclass,
         data_fields=["vals", "dinv", "d"],
         meta_fields=["n_rows", "n_colors", "m", "R_b", "TB", "levels",
                      "spec_kind", "spec_params"])
@dataclasses.dataclass
class BlockedTriSolve:
    """One triangular solve's packed data (see module docstring).

    vals:   tuple of (R_b, 128) planes, one per (tc, sc, Δ) group
    dinv:   tuple of C (R_b, 128) blocks — 1/D at real slots, 0 at pads
    d:      optional tuple of C blocks with D itself (SGS middle multiply)
    levels: ordered tuple of (color, groups) where groups is a tuple of
            (src_color, delta, group_index); solve order is the tuple order.
    """

    vals: Tuple[jax.Array, ...]
    dinv: Tuple[jax.Array, ...]
    d: Optional[Tuple[jax.Array, ...]]
    n_rows: int
    n_colors: int
    m: int          # real slots per block
    R_b: int        # padded x2-rows per block (multiple of TB)
    TB: int
    levels: Tuple[Tuple[int, Tuple[Tuple[int, int, int], ...]], ...]
    spec_kind: str
    spec_params: Tuple[int, ...]

    @property
    def dtype(self):
        return self.dinv[0].dtype


def build_blocked_trisolve(T, D: Optional[np.ndarray],
                           colors: np.ndarray, spec, *, upper: bool,
                           dtype=np.float32, need_d: bool = False,
                           tile_rows: int = _TB) -> BlockedTriSolve:
    """Pack the color-{lower,upper} part of T (entries with
    color(j) {<,>} color(i)) for the blocked solve.

    `T` may be the full matrix (entries filtered by color comparison) or an
    already-split strict part (e.g. factor_ilu0_colored outputs — the filter
    then keeps everything).  `D` is the diagonal to divide by (None = unit).
    Raises BlockIneligibleError when the structure does not qualify.
    """
    rows, cols, vals, n = _entries_of(T)
    C = spec.n_colors
    # Properness FIRST, structure second: every raise after this point
    # means "the colors are valid, the blocked layout is not" — callers may
    # then safely fall back to masked sweeps WITH these colors (any proper
    # coloring gives an exact colored solve), instead of recoloring.
    ci = colors[rows].astype(np.int64)
    cj = colors[cols].astype(np.int64)
    if np.any((ci == cj) & (rows != cols)):
        raise ImproperColoringError(
            "coloring is not proper for this pattern")
    m = _check_spec(spec, n)
    if C != int(colors.max()) + 1 and n:
        # colors must come from this spec
        raise BlockIneligibleError("colors/spec mismatch")

    # rank = position within the color class in natural order — identical
    # to colors_to_perm ranks and the reshape/transpose layout, computed in
    # closed form (no O(n log n) sort on the throttled host): mod spec →
    # i // k; grid spec → rx + mx·ry + mx·my·rz with ra = coord // stride.
    idx = np.arange(n, dtype=np.int64)
    if spec.kind == "mod":
        rank = idx // spec.params[0]
    else:
        nx, ny, nz, sx, sy, sz = spec.params
        mx, my = nx // sx, ny // sy
        X, Y, Z = _grid_coords(idx, nx, ny)
        rank = (X // sx) + mx * ((Y // sy) + my * (Z // sz))

    keep = (cj > ci) if upper else (cj < ci)
    rows, cols, ci, cj = rows[keep], cols[keep], ci[keep], cj[keep]
    v = vals[keep]
    delta = rank[cols] - rank[rows]

    # group by (target color, source color, Δ)
    span = 2 * m + 1
    key = (ci * C + cj) * span + (delta + m)
    ukey, ginv = _group_inverse(key, C * C * span)
    G = ukey.size
    if G > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{G} (color,color,Δ) groups — pattern too irregular")
    g_tc = (ukey // span) // C
    g_sc = (ukey // span) % C
    g_dl = (ukey % span) - m

    # tile size: the 3-tile window must cover every Δ's row reach; small
    # blocks shrink the tile to the block so padding never dominates
    qmax = int(np.abs(g_dl).max()) // LANES + 1 if G else 0
    R_rows = -(-m // LANES)
    TB = max(8 * -(-(qmax + 1) // 8),
             min(tile_rows, 8 * -(-R_rows // 8)), 8)
    R_b = -(-R_rows // TB) * TB
    if TB > R_b:
        R_b = TB

    vals_np = np.zeros((G, R_b * LANES), dtype=dtype)
    vals_np[ginv, rank[rows]] = v.astype(dtype)

    dinv_np = np.zeros((C, R_b * LANES), dtype=dtype)
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")
    dinv_np[colors, rank] = (1.0 / dv).astype(dtype)
    d_np = None
    if need_d:
        d_np = np.zeros((C, R_b * LANES), dtype=dtype)
        d_np[colors, rank] = dv.astype(dtype)

    # per-level group lists, solve order ascending (lower) / descending
    level_order = range(C - 1, -1, -1) if upper else range(C)
    levels = []
    for c in level_order:
        sel = np.nonzero(g_tc == c)[0]
        groups = sorted((int(g_sc[g]), int(g_dl[g]), int(g))
                        for g in sel)
        levels.append((int(c), tuple(groups)))

    as_blocks = lambda a: tuple(jnp.asarray(x.reshape(R_b, LANES))
                                for x in a)
    return BlockedTriSolve(
        vals=as_blocks(vals_np), dinv=as_blocks(dinv_np),
        d=(as_blocks(d_np) if d_np is not None else None),
        n_rows=n, n_colors=C, m=m, R_b=R_b, TB=TB,
        levels=tuple(levels), spec_kind=spec.kind,
        spec_params=tuple(int(p) for p in spec.params))


# ---------------------------------------------------------------------------
# Block layout <-> flat vectors (pure reshape/transpose — never a gather)
# ---------------------------------------------------------------------------

def permute_blocks(B: BlockedTriSolve, y: jax.Array) -> Tuple[jax.Array, ...]:
    """Flat (n,) → C color blocks of shape (R_b, 128), rank-ordered."""
    n, C, m = B.n_rows, B.n_colors, B.m
    if B.spec_kind == "mod":
        k = B.spec_params[0]
        yp = jnp.pad(y, (0, k * m - n))
        arr = yp.reshape(m, k).T                      # (C, m)
    else:
        nx, ny, nz, sx, sy, sz = B.spec_params
        mx, my, mz = nx // sx, ny // sy, nz // sz
        arr = (y.reshape(mz, sz, my, sy, mx, sx)
               .transpose(1, 3, 5, 0, 2, 4)
               .reshape(C, m))
    arr = jnp.pad(arr, ((0, 0), (0, B.R_b * LANES - m)))
    return tuple(arr[c].reshape(B.R_b, LANES) for c in range(C))


def unpermute_blocks(B: BlockedTriSolve, xb) -> jax.Array:
    """C color blocks → flat (n,)."""
    n, C, m = B.n_rows, B.n_colors, B.m
    arr = jnp.stack([x.reshape(-1)[:m] for x in xb])  # (C, m)
    if B.spec_kind == "mod":
        k = B.spec_params[0]
        return arr.T.reshape(k * m)[:n]
    nx, ny, nz, sx, sy, sz = B.spec_params
    mx, my, mz = nx // sx, ny // sy, nz // sz
    return (arr.reshape(sz, sy, sx, mz, my, mx)
            .transpose(3, 0, 4, 1, 5, 2)
            .reshape(n))


# ---------------------------------------------------------------------------
# The level step
# ---------------------------------------------------------------------------

def _shifted_read_xla(x_blk: jax.Array, delta: int) -> jax.Array:
    """shift(x, Δ)[t] = x[t + Δ] in flat rank order (XLA fallback path).
    jnp.roll wraps, but wrapped positions always multiply a zero value
    (real entries satisfy 0 ≤ rank+Δ < m; pads hold val 0)."""
    return jnp.roll(x_blk.reshape(-1), -delta).reshape(x_blk.shape)


def _level_xla(B, groups, y_blk, dinv_blk, xb):
    acc = y_blk
    for sc, delta, g in groups:
        acc = acc - B.vals[g] * _shifted_read_xla(xb[sc], delta)
    return acc * dinv_blk


# ---------------------------------------------------------------------------
# Superblock grid path: row-granular permutes + x-parity sub-steps
# ---------------------------------------------------------------------------
#
# The rank-space layout above interleaves the x (lane) axis across color
# blocks, which makes the block permutation a lane-granular transpose.  The
# superblock layout removes the lane interleave: blocks are formed by the
# (y, z) color components ONLY (slot = x + nx·(ry + my·rz), x contiguous in
# lanes), so the permutation is a row-granular transpose, and the x-stride
# colorings become LANE PARITIES: a super-level solves its sx parities as
# masked sub-steps (parity cx reads parity cx' through a lane shift —
# legal because proper colorings put same-superblock couplings at
# dy = dz = 0).

@partial(jax.tree_util.register_dataclass,
         data_fields=["vals_cross", "vals_self", "dinv", "d", "packed"],
         meta_fields=["n_rows", "S", "m", "R_b", "TB", "sx", "levels",
                      "upper", "spec_params", "fused", "const_cross",
                      "const_self", "pack_geom"])
@dataclasses.dataclass
class SuperBlockTriSolve:
    """Superblock form of a colored triangular solve (grid specs).

    vals_cross[li]: (G_li, R_b, 128) plane slab for cross-superblock groups
                    of level li (None when the level has none), rows aligned
                    with levels[li][1]
    vals_self[li]:  (Gs_li, R_b, 128) same-superblock (pure-dx) planes,
                    rows aligned with levels[li][2]
    dinv, d:        per-SUPERBLOCK (R_b, 128) blocks (d only when need_d)
    levels:         ordered tuple (sb, cross, selfs); cross = ((src, Δ),…)
                    sorted by (src, Δ); selfs = (dx, …) sorted
    """

    vals_cross: Tuple[Optional[jax.Array], ...]
    vals_self: Tuple[Optional[jax.Array], ...]
    dinv: Tuple[jax.Array, ...]
    d: Optional[Tuple[jax.Array, ...]]
    n_rows: int
    S: int
    m: int
    R_b: int
    TB: int
    sx: int
    levels: Tuple
    upper: bool
    spec_params: Tuple[int, ...]
    #: True → one kernel per level with the x-parities chained in register
    #: (needs 128 % nx == 0 so lane rolls never cross a vreg row at a real
    #: entry); False → SPLIT mode: an acc kernel per level plus one masked
    #: kernel per parity, self couplings read through windows (any nx)
    fused: bool = True
    #: CONSTANT-COEFFICIENT mode (matrix-free factors): when every group
    #: plane of every level equals coeff × (geometric in-bounds mask of a
    #: single stencil leg), the planes are dropped entirely and the solve
    #: kernels regenerate them in-register from iota arithmetic — the
    #: factor's HBM traffic per apply falls from |T| values to ZERO (only
    #: vector/window passes remain).  const_cross[li] is a tuple of
    #: (coeff, dx, dy, dz) aligned with levels[li][1]; const_self[li] a
    #: tuple of (coeff, dx) aligned with levels[li][2].  None → plane mode
    #: (vals_cross/vals_self hold the slabs).  Detected by _const_detect
    #: on generic builds, or constructed analytically from a DeviceStencil
    #: (build_superblock_gs_pair_stencil) with no host CSR at all.
    const_cross: Optional[Tuple] = None
    const_self: Optional[Tuple] = None
    #: PACKED-TABLE mode (translation-invariant factors, nx % 128 == 0):
    #: per level, ONE (G+1, R_b/8, 128) slab holding each leg's per-row
    #: x-class values — 8 rows × 16 x-classes per packed lane row (the
    #: verified clamp distance makes ≤16 x-classes bitwise-exact).  The
    #: apply regenerates full (TB, 128) planes (_packed_expand_xla): factor
    #: memory traffic drops 8×.  Slab group
    #: order per level: cross legs, self legs, then dinv.  None → plane /
    #: const mode.
    packed: Optional[Tuple] = None
    #: (slots, Pxr, dx_star) for packed mode: slots = packed classes per
    #: row (16), Pxr = reduced x-class count, dx_star = verified clamp
    pack_geom: Optional[Tuple] = None

    @property
    def is_packed(self) -> bool:
        return self.packed is not None

    @property
    def is_const(self) -> bool:
        return self.const_cross is not None

    @property
    def dtype(self):
        if self.packed is not None:
            return self.packed[0].dtype
        return self.dinv[0].dtype


def _leg_from_delta(sb_t: int, src: int, delta: int, spec_params):
    """Recover the (dx, dy, dz) stencil leg behind a cross-group key
    (target superblock, source superblock, slot offset Δ), taking the
    smallest-|dx| decomposition of Δ = dx + nx·(dRy + my·dRz).  The
    caller VERIFIES the candidate against the actual plane, so an
    ambiguous decomposition (possible only for |dx| ≥ nx/2 stencils)
    just fails detection instead of mis-classifying."""
    nx, ny, nz, sx, sy, sz = spec_params
    my = ny // sy
    dx = ((delta + nx // 2) % nx) - nx // 2
    rem = (delta - dx) // nx
    dRy = ((rem + my // 2) % my) - my // 2
    dRz = (rem - dRy) // my
    dy = (src % sy - sb_t % sy) + sy * dRy
    dz = (src // sy - sb_t // sy) + sz * dRz
    return dx, dy, dz


@lru_cache(maxsize=8)
def _slot_coords(spec_params, sb: int, size: int):
    """Per-slot (x, y, z) target coordinates of superblock `sb`'s rank
    space, padded to `size` slots (read-only, shared across groups)."""
    nx, ny, nz, sx, sy, sz = spec_params
    my = ny // sy
    s = np.arange(size, dtype=np.int64)
    x = s % nx
    t = s // nx
    y = sy * (t % my) + sb % sy
    z = sz * (t // my) + sb // sy
    for a in (x, y, z):
        a.flags.writeable = False
    return x, y, z


def _leg_mask_np(sb_t: int, leg, spec_params, m: int, size: int,
                 self_upper=None):
    """Boolean in-bounds mask of `leg`'s neighbor over the (padded) slot
    axis — exactly the nonzero structure a constant-coefficient plane
    must have.

    `self_upper` (self legs only): same-superblock couplings are split
    between the two triangles by the X-PARITY order (color = px + sx·SB,
    so within a superblock the x-parity decides the triangle): False
    keeps rows where parity(x+dx) < parity(x) (lower), True the reverse.
    Cross legs (self_upper=None) need no parity term — their superblock
    ids differ, which dominates the color comparison."""
    nx, ny, nz, sx, _sy, _sz = spec_params
    dx, dy, dz = leg
    x, y, z = _slot_coords(spec_params, sb_t, size)
    mask = np.arange(size) < m
    mask &= (x + dx >= 0) & (x + dx < nx)
    if dy:
        mask &= (y + dy >= 0) & (y + dy < ny)
    if dz:
        mask &= (z + dz >= 0) & (z + dz < nz)
    if self_upper is not None:
        ps, pt = (x + dx) % sx, x % sx
        mask &= (ps > pt) if self_upper else (ps < pt)
    return mask


def _plane_const_coeff(plane: np.ndarray, mask: np.ndarray):
    """coeff c if plane == c·mask exactly, else None.  Subsamples first so
    genuinely non-constant factors (ILU(0) values) fail in O(1)."""
    probe = plane[:4096]
    pnz = probe[probe != 0]
    if pnz.size and not (pnz == pnz[0]).all():
        return None
    nz = np.flatnonzero(mask)
    if nz.size == 0:
        return None
    c = plane[nz[0]]
    if c == 0:
        return None
    ok = np.array_equal(plane != 0, mask) and (plane[nz] == c).all()
    return float(c) if ok else None


def _const_detect_level(sb: int, cross, selfs, vc_np, vs_np, spec_params,
                        m: int, size: int, upper: bool):
    """(cross_consts, self_consts) for one level, or None when any group
    plane is not coeff × leg-mask.  vc_np/vs_np are the level's NumPy
    slabs flattened to (G, size)."""
    cc = []
    for gi, (src, delta) in enumerate(cross):
        leg = _leg_from_delta(sb, src, delta, spec_params)
        c = _plane_const_coeff(vc_np[gi], _leg_mask_np(sb, leg, spec_params,
                                                       m, size))
        if c is None:
            return None
        cc.append((c,) + leg)
    sc = []
    for gi, dx in enumerate(selfs):
        c = _plane_const_coeff(
            vs_np[gi], _leg_mask_np(sb, (dx, 0, 0), spec_params, m, size,
                                    self_upper=upper))
        if c is None:
            return None
        sc.append((c, dx))
    return tuple(cc), tuple(sc)


def _pack_levels(raw, spec_params, m: int, R_b: int, fused: bool,
                 upper: bool = False):
    """Finalize per-level slabs: try constant-coefficient detection first
    (fused mode only — the split kernels also support const, but split
    implies nx > 128 capacity grids where detection cost grows), else
    upload the planes.

    raw: list of (sb, cross, selfs, vc_np, vs_np), slabs (G, R_b·LANES)
    NumPy (or None when the level has no groups of that kind).
    Returns (levels, vals_cross, vals_self, const_cross, const_self).
    """
    size = R_b * LANES
    levels = tuple((int(sb), cross, selfs) for sb, cross, selfs, _, _ in raw)
    if fused and not NO_CONST:
        consts = []
        for sb, cross, selfs, vc, vs in raw:
            det = _const_detect_level(
                sb, cross, selfs,
                vc if vc is not None else np.zeros((0, size)),
                vs if vs is not None else np.zeros((0, size)),
                spec_params, m, size, upper)
            if det is None:
                consts = None
                break
            consts.append(det)
        if consts is not None:
            n = len(raw)
            return (levels, (None,) * n, (None,) * n,
                    tuple(c for c, _ in consts),
                    tuple(s for _, s in consts))

    def up(v):
        return (jnp.asarray(v.reshape(-1, R_b, LANES))
                if v is not None and len(v) else None)

    return (levels,
            tuple(up(vc) for _, _, _, vc, _ in raw),
            tuple(up(vs) for _, _, _, _, vs in raw),
            None, None)


def build_superblock_trisolve(T, D: Optional[np.ndarray],
                              colors: np.ndarray, spec, *, upper: bool,
                              dtype=np.float32, need_d: bool = False,
                              tile_rows: int = _TB,
                              _analysis=None) -> SuperBlockTriSolve:
    """Pack the color-{lower,upper} part of T in superblock form.

    Eligibility beyond the grid-spec checks: 128 % nx == 0 (lane rolls for
    the in-register parity sub-steps never cross a vreg row at a position
    holding a real entry) and same-superblock couplings at dy = dz = 0.

    `_analysis` (pair builder) carries the one-pass native group discovery
    shared by both triangles (csrc bis_sb_analyze).
    """
    if spec.kind != "grid":
        raise BlockIneligibleError("superblock path needs a grid coloring")
    rows, cols, vals, n = _entries_of(T)
    nx, ny, nz, sx, sy, sz = spec.params
    if nx * ny * nz != n:
        raise BlockIneligibleError("grid spec dims do not match n_rows")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    fused = nx <= LANES and LANES % nx == 0
    S = sy * sz
    my, mz = ny // sy, nz // sz
    m = nx * my * mz

    # C++ fast path: one-pass group discovery + plane scatter, no full-nnz
    # intermediates (the throttled host makes each 55M-entry NumPy
    # temporary cost seconds).  Structural rejections fall through to the
    # NumPy path, which re-derives the properly ordered error.
    analysis = (_analysis if _analysis is not None
                else _native_analysis_for((rows, cols, vals, n), colors,
                                          spec))
    if analysis is not None:
        return _build_superblock_from_analysis(
            analysis, rows, cols, vals, n, D, spec, upper=upper,
            dtype=dtype, need_d=need_d, tile_rows=tile_rows,
            fused=fused)

    idx = np.arange(n, dtype=np.int64)
    X, Y, Z = _grid_coords(idx, nx, ny)
    SB = (Y % sy) + sy * (Z % sz)
    SLOT = X + nx * ((Y // sy) + my * (Z // sz))

    ci = colors[rows].astype(np.int64)
    cj = colors[cols].astype(np.int64)
    keep = (cj > ci) if upper else (cj < ci)
    if np.any((ci == cj) & (rows != cols)):
        raise ImproperColoringError(
            "coloring is not proper for this pattern")
    rows, cols = rows[keep], cols[keep]
    v = vals[keep]

    sb_i, sb_j = SB[rows], SB[cols]
    is_self = sb_i == sb_j
    # same-superblock couplings must be pure-x (dy = dz = 0) for the
    # in-register sub-steps
    if np.any(is_self & ((Y[rows] != Y[cols]) | (Z[rows] != Z[cols]))):
        raise BlockIneligibleError("same-superblock coupling beyond x axis")
    dx_self = X[cols[is_self]] - X[rows[is_self]]
    if is_self.any() and np.abs(dx_self).max() >= min(nx, LANES):
        raise BlockIneligibleError("self coupling reach exceeds a lane row")

    delta = SLOT[cols] - SLOT[rows]
    span = 2 * m + 1
    # cross groups keyed (sb_i, sb_j, Δ) — sb_i-major so each level's
    # groups are contiguous after the sort inside np.unique
    keyc = ((sb_i * S + sb_j) * span + (delta + m))[~is_self]
    ukc, ginvc = _group_inverse(keyc, S * S * span)
    # self groups keyed (sb_i, dx)
    keys = sb_i[is_self] * (2 * LANES + 1) + (dx_self + LANES)
    uks, ginvs = _group_inverse(keys, S * (2 * LANES + 1))
    Gc, Gs = ukc.size, uks.size
    if Gc + Gs > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{Gc + Gs} superblock groups — pattern too irregular")
    gc_tb = (ukc // span) // S
    gc_sb = (ukc // span) % S
    gc_dl = (ukc % span) - m
    gs_tb = uks // (2 * LANES + 1)
    gs_dx = (uks % (2 * LANES + 1)) - LANES

    qmax = int(np.abs(gc_dl).max()) // LANES + 1 if Gc else 0
    R_rows = -(-m // LANES)
    TB = max(8 * -(-(qmax + 1) // 8),
             min(tile_rows, 8 * -(-R_rows // 8)), 8)
    if not fused and not NO_ALIGNED:
        import math
        step = nx // math.gcd(nx, LANES)
        step = step * 64 // math.gcd(step, 64)
        TB = -(-TB // step) * step
        fused = True           # aligned-fused geometry (see _sb_plan)
    R_b = -(-R_rows // TB) * TB
    if TB > R_b:
        R_b = TB

    vc = np.zeros((Gc, R_b * LANES), dtype=dtype)
    vc[ginvc, SLOT[rows[~is_self]]] = v[~is_self].astype(dtype)
    vs = np.zeros((Gs, R_b * LANES), dtype=dtype)
    vs[ginvs, SLOT[rows[is_self]]] = v[is_self].astype(dtype)

    dinv_np = np.zeros((S, R_b * LANES), dtype=dtype)
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")
    dinv_np[SB, SLOT] = (1.0 / dv).astype(dtype)
    d_np = None
    if need_d:
        d_np = np.zeros((S, R_b * LANES), dtype=dtype)
        d_np[SB, SLOT] = dv.astype(dtype)

    order = range(S - 1, -1, -1) if upper else range(S)
    raw = []
    for sb in order:
        selc = np.nonzero(gc_tb == sb)[0]
        sels = np.nonzero(gs_tb == sb)[0]
        cross = tuple(sorted((int(gc_sb[g]), int(gc_dl[g])) for g in selc))
        # re-order the slab rows to match the sorted group order
        cidx = sorted(selc, key=lambda g: (int(gc_sb[g]), int(gc_dl[g])))
        sidx = sorted(sels, key=lambda g: int(gs_dx[g]))
        selfs = tuple(int(gs_dx[g]) for g in sidx)
        raw.append((sb, cross, selfs,
                    vc[cidx] if len(cidx) else None,
                    vs[sidx] if len(sidx) else None))
    spec_params = tuple(int(p) for p in spec.params)
    levels, vals_cross, vals_self, cc, cs = _pack_levels(
        raw, spec_params, m, R_b, fused, upper)

    as_blocks = lambda a: tuple(jnp.asarray(x.reshape(R_b, LANES))
                                for x in a)
    return SuperBlockTriSolve(
        vals_cross=vals_cross, vals_self=vals_self,
        dinv=as_blocks(dinv_np),
        d=(as_blocks(d_np) if d_np is not None else None),
        n_rows=n, S=S, m=m, R_b=R_b, TB=TB, sx=sx,
        levels=levels, upper=upper,
        spec_params=spec_params, fused=fused,
        const_cross=cc, const_self=cs)


def _native_analysis_for(trip, colors, spec):
    """Native one-pass group discovery for a grid spec, or None when the
    fast path does not apply (no library, non-spec colors, bad dims, or a
    structural violation — the NumPy builder then re-derives the properly
    ordered error).  Raises ImproperColoringError directly."""
    rows, cols, vals, n = trip
    if FORCE_NUMPY or spec.kind != "grid":
        return None
    nx, ny, nz, sx, sy, sz = spec.params
    if nx * ny * nz != n or ny % sy or nz % sz or n == 0:
        return None
    if not spec_colors_valid(colors, spec, n):
        return None
    from .. import _native
    return _native.sb_analyze(rows, cols, nx, ny, nz, sx, sy, sz,
                              _MAX_GROUPS + 1)


def _sb_plan(analysis, upper: bool, spec, tile_rows: int):
    """Decode one triangle's ascending group keys (whose order IS the
    level/slab order) and pick the tile geometry."""
    import types
    nx, ny, nz, sx, sy, sz = spec.params
    S = sy * sz
    my, mz = ny // sy, nz // sz
    m = nx * my * mz
    span = 2 * m + 1
    ukc = analysis["cross_up" if upper else "cross_lo"]
    uks = analysis["self_up" if upper else "self_lo"]
    Gc, Gs = len(ukc), len(uks)
    if Gc + Gs > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{Gc + Gs} superblock groups — pattern too irregular")
    gc_tb = (ukc // span) // S
    gc_sb = (ukc // span) % S
    gc_dl = (ukc % span) - m
    gs_tb = uks // (2 * LANES + 1)
    gs_dx = (uks % (2 * LANES + 1)) - LANES
    qmax = int(np.abs(gc_dl).max()) // LANES + 1 if Gc else 0
    R_rows = -(-m // LANES)
    TB = max(8 * -(-(qmax + 1) // 8),
             min(tile_rows, 8 * -(-R_rows // 8)), 8)
    fused = nx <= LANES and LANES % nx == 0
    if not fused and not NO_ALIGNED:
        # aligned-fused tile geometry (see _stencil_pair_plan): pin tile
        # boundaries to x = 0 so the one-call-per-level kernel runs at any
        # nx instead of the 3-call split-parity chain
        import math
        step = nx // math.gcd(nx, LANES)
        step = step * 64 // math.gcd(step, 64)
        TB = -(-TB // step) * step
        fused = True
    R_b = -(-R_rows // TB) * TB
    if TB > R_b:
        R_b = TB
    return types.SimpleNamespace(
        ukc=ukc, uks=uks, Gc=Gc, Gs=Gs, gc_tb=gc_tb, gc_sb=gc_sb,
        gc_dl=gc_dl, gs_tb=gs_tb, gs_dx=gs_dx, TB=TB, R_b=R_b, S=S, m=m,
        fused=fused)


@lru_cache(maxsize=4)
def _sb_coords(spec_params, n: int):
    """(superblock id, in-block slot) per row — shared by the L and U
    assemblies of one setup (each is a multi-pass O(n) host sweep)."""
    nx, ny, nz, sx, sy, sz = spec_params
    my = ny // sy
    idx = np.arange(n, dtype=np.int32 if n < 2**31 else np.int64)
    X, Y, Z = _grid_coords(idx, nx, ny)
    SB = (Y % sy) + sy * (Z % sz)
    SLOT = X + nx * ((Y // sy) + my * (Z // sz))
    SB.flags.writeable = False
    SLOT.flags.writeable = False
    return SB, SLOT


def _sb_assemble(plan, vc_big, vs_big, D, n, spec, *, upper, dtype, need_d,
                 fused) -> SuperBlockTriSolve:
    """dinv/d blocks + per-level slab views → SuperBlockTriSolve (the
    ascending-key order makes each level's groups contiguous and already
    slab-sorted, so slabs are views, never copies)."""
    nx, ny, nz, sx, sy, sz = spec.params
    S, R_b, TB = plan.S, plan.R_b, plan.TB
    SB, SLOT = _sb_coords(tuple(int(p) for p in spec.params), n)
    dinv_np = np.zeros((S, R_b * LANES), dtype=dtype)
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")
    dinv_np[SB, SLOT] = (1.0 / dv).astype(dtype)
    d_np = None
    if need_d:
        d_np = np.zeros((S, R_b * LANES), dtype=dtype)
        d_np[SB, SLOT] = dv.astype(dtype)

    order = range(S - 1, -1, -1) if upper else range(S)
    raw = []
    for sb in order:
        c_lo, c_hi = np.searchsorted(plan.gc_tb, [sb, sb + 1])
        s_lo, s_hi = np.searchsorted(plan.gs_tb, [sb, sb + 1])
        cross = tuple((int(plan.gc_sb[g]), int(plan.gc_dl[g]))
                      for g in range(c_lo, c_hi))
        selfs = tuple(int(plan.gs_dx[g]) for g in range(s_lo, s_hi))
        raw.append((sb, cross, selfs,
                    vc_big[c_lo:c_hi] if c_hi > c_lo else None,
                    vs_big[s_lo:s_hi] if s_hi > s_lo else None))
    spec_params = tuple(int(p) for p in spec.params)
    levels, vals_cross, vals_self, cc, cs = _pack_levels(
        raw, spec_params, plan.m, R_b, fused, upper)

    as_blocks = lambda a: tuple(jnp.asarray(x.reshape(R_b, LANES))
                                for x in a)
    return SuperBlockTriSolve(
        vals_cross=vals_cross, vals_self=vals_self,
        dinv=as_blocks(dinv_np),
        d=(as_blocks(d_np) if d_np is not None else None),
        n_rows=n, S=S, m=plan.m, R_b=R_b, TB=TB, sx=sx,
        levels=levels, upper=upper,
        spec_params=spec_params, fused=fused,
        const_cross=cc, const_self=cs)


def _build_superblock_from_analysis(analysis, rows, cols, vals, n, D, spec,
                                    *, upper, dtype, need_d, tile_rows,
                                    fused) -> SuperBlockTriSolve:
    """Assemble a SuperBlockTriSolve from the native one-pass analysis:
    scatter the triangle's values in C (csrc bis_sb_scatter), then the
    shared assembly."""
    from .. import _native
    nx, ny, nz, sx, sy, sz = spec.params
    plan = _sb_plan(analysis, upper, spec, tile_rows)
    vc_big = np.zeros((max(plan.Gc, 1), plan.R_b * LANES), dtype=dtype)
    vs_big = np.zeros((max(plan.Gs, 1), plan.R_b * LANES), dtype=dtype)
    if not _native.sb_scatter(rows, cols, vals, nx, ny, nz, sx, sy, sz,
                              upper, plan.ukc, plan.uks, plan.R_b * LANES,
                              vc_big, vs_big):
        raise RuntimeError("native library vanished mid-build")
    return _sb_assemble(plan, vc_big, vs_big, D, n, spec, upper=upper,
                        dtype=dtype, need_d=need_d, fused=plan.fused)


def _sb_pack_pair_from_csr(Ap, vals, perm, spec, *, D_L, D_U,
                           need_d_L, dtype, tile_rows):
    """Shared CSR-direct pair packing: analyze + scatter BOTH triangles in
    two C passes over the (possibly permuted) CSR, then assemble the
    (lower, upper) SuperBlockTriSolve pair.  Returns (L, U, U_D_peeled)."""
    from .. import _native
    if FORCE_NUMPY or spec.kind != "grid":
        raise BlockIneligibleError("csr-direct path needs a grid coloring")
    nx, ny, nz, sx, sy, sz = spec.params
    n = Ap.n_rows
    if nx * ny * nz != n or n == 0:
        raise BlockIneligibleError("grid spec dims do not match n_rows")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    analysis = _native.sb_analyze_csr(Ap, perm, nx, ny, nz, sx, sy, sz,
                                      _MAX_GROUPS + 1)
    if analysis is None:
        raise BlockIneligibleError(
            "native CSR analysis unavailable or structurally ineligible")
    fused = nx <= LANES and LANES % nx == 0
    plan_L = _sb_plan(analysis, False, spec, tile_rows)
    plan_U = _sb_plan(analysis, True, spec, tile_rows)
    pc_lo = np.zeros((max(plan_L.Gc, 1), plan_L.R_b * LANES), dtype=dtype)
    ps_lo = np.zeros((max(plan_L.Gs, 1), plan_L.R_b * LANES), dtype=dtype)
    pc_up = np.zeros((max(plan_U.Gc, 1), plan_U.R_b * LANES), dtype=dtype)
    ps_up = np.zeros((max(plan_U.Gs, 1), plan_U.R_b * LANES), dtype=dtype)
    U_D = _native.sb_scatter_csr(Ap, vals, perm, nx, ny, nz, sx, sy, sz,
                                 analysis, plan_L.R_b * LANES,
                                 plan_U.R_b * LANES,
                                 pc_lo, ps_lo, pc_up, ps_up)
    if U_D is None:
        raise RuntimeError("native library vanished mid-build")
    # D_L=None → unit-diagonal L (ILU(0)); D_U=None → the scatter pass's
    # peeled diagonal (the ILU(0) U factor's U_D)
    L = _sb_assemble(plan_L, pc_lo, ps_lo, D_L, n, spec, upper=False,
                     dtype=dtype, need_d=need_d_L, fused=plan_L.fused)
    U = _sb_assemble(plan_U, pc_up, ps_up,
                     D_U if D_U is not None else U_D, n, spec, upper=True,
                     dtype=dtype, need_d=False, fused=plan_U.fused)
    return L, U, U_D


def build_superblock_gs_pair_from_csr(A, D, spec, *, dtype=np.float32,
                                      need_d: bool = False,
                                      tile_rows: int = _TB):
    """(L_blk, U_blk) for the GS family straight off the natural-order CSR
    (identity permutation).  Both triangles solve with the matrix diagonal
    D; `need_d` stores D blocks on L (blocked_sgs's middle multiply).
    Raises BlockIneligibleError when inapplicable."""
    perm = np.arange(A.n_rows, dtype=np.int32)
    L, U, _ = _sb_pack_pair_from_csr(A, A.val, perm, spec, D_L=D, D_U=D,
                                     need_d_L=need_d, dtype=dtype,
                                     tile_rows=tile_rows)
    return L, U


def stencil_blocked_eligible(op, spec) -> bool:
    """Cheap predicate: can build_superblock_gs_pair_stencil succeed for
    this DeviceStencil + grid spec?  (Metadata checks only — used by
    preprocessing_device to gate planar vectors before the build.)
    The const-mode GS pair needs the FUSED layout (in-register plane
    regeneration chains x-parities through lane rotations)."""
    try:
        return _stencil_pair_plan(op, spec).fused
    except (BlockIneligibleError, ImproperColoringError):
        return False


def _stencil_pair_plan(op, spec):
    """Shared eligibility + geometry for the analytic stencil pair.
    Returns (legs_coeffs, self_legs, cross_legs, S, m, TB, R_b)."""
    if NO_CONST:
        raise BlockIneligibleError("const mode disabled (BIS_SB_CONST=0)")
    if spec.kind != "grid":
        raise BlockIneligibleError("superblock path needs a grid coloring")
    nx, ny, nz, sx, sy, sz = spec.params
    if tuple(op.dims) != (nx, ny, nz):
        raise BlockIneligibleError("grid spec dims do not match operator")
    if op.diag is not None:
        raise BlockIneligibleError(
            "dense-diagonal stencil: diagonal is not a trace-time constant")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    # fused layout (x-parities chained in-register) needs lane rotations
    # that never cross a vreg row at a real entry; otherwise the solve
    # tries the ALIGNED-fused layout (tile boundaries pinned to x = 0 by
    # choosing TB with TB·LANES ≡ 0 mod nx, so self-leg reads never cross
    # a tile), and only failing that the split-parity layout (any nx)
    fused = nx <= LANES and LANES % nx == 0
    aligned = False
    my, mz = ny // sy, nz // sz
    S = sy * sz
    m = nx * my * mz
    diag_c = None
    self_legs, cross_legs = [], []
    for leg, c in zip(op.legs, op.coeff_values):
        dx, dy, dz = leg
        if leg == (0, 0, 0):
            diag_c = float(c)
            continue
        if float(c) == 0.0:
            continue
        if dx % sx == 0 and dy % sy == 0 and dz % sz == 0:
            raise ImproperColoringError(
                f"leg {leg} couples same-colored rows under this spec")
        if dy == 0 and dz == 0:
            if abs(dx) >= min(nx, LANES):
                raise BlockIneligibleError(
                    "self coupling reach exceeds a lane row")
            self_legs.append((dx, float(c)))
        elif dy % sy == 0 and dz % sz == 0:
            raise BlockIneligibleError(
                "same-superblock coupling beyond x axis")
        else:
            cross_legs.append((leg, float(c)))
    if diag_c is None or diag_c == 0.0:
        raise BlockIneligibleError("stencil has no constant nonzero "
                                   "diagonal leg")
    # per (target sb, cross leg): source sb + slot offset Δ
    deltas = []
    per_sb = []
    for sb in range(S):
        py_t, pz_t = sb % sy, sb // sy
        rows = []
        for (dx, dy, dz), c in cross_legs:
            py_s, pz_s = (py_t + dy) % sy, (pz_t + dz) % sz
            src = py_s + sy * pz_s
            dRy = (py_t + dy - py_s) // sy
            dRz = (pz_t + dz - pz_s) // sz
            delta = dx + nx * (dRy + my * dRz)
            rows.append((src, delta, c, (dx, dy, dz)))
            deltas.append(delta)
        per_sb.append(rows)
    qmax = (max(abs(d) for d in deltas) // LANES + 1) if deltas else 0
    R_rows = -(-m // LANES)
    TB = max(8 * -(-(qmax + 1) // 8), min(_TB, 8 * -(-R_rows // 8)), 8)
    if not fused and not NO_ALIGNED:
        # TB·LANES ≡ 0 (mod nx): every tile's x range is [0, nx) complete,
        # so self couplings (|dx| < sx) never reach across a tile boundary
        # — the one dependency that forced the split-parity kernels.
        import math
        step = nx // math.gcd(nx, LANES)
        # lcm(step, 64): ×64 so TB/8 stays a multiple of 8 (packed-slab
        # block height)
        step = step * 64 // math.gcd(step, 64)
        TB_al = -(-TB // step) * step
        if TB_al <= max(R_rows, TB_al):               # always feasible
            TB = TB_al
            fused = aligned = True
    if fused and nx % LANES == 0:
        # z-slab tile alignment: TB rounded to whole (y-plane, z) slabs.
        # Only a removed permute-free apply needed it; kept so the layout
        # (and the tests that pin it) stays as it was
        zrows = my * (nx // LANES)
        if TB % zrows and zrows <= 2048:
            import math
            L_z = zrows * 64 // math.gcd(zrows, 64)   # lcm(zrows, 64):
            TB_z = -(-TB // L_z) * L_z                # whole z slabs AND a
            if TB_z <= 4096:                          # legal packed block
                TB = TB_z
    R_b = -(-R_rows // TB) * TB
    if TB > R_b:
        R_b = TB
    import types
    return types.SimpleNamespace(
        diag_c=diag_c, self_legs=sorted(self_legs), per_sb=per_sb,
        S=S, m=m, TB=TB, R_b=R_b, fused=fused, aligned=aligned,
        spec_params=tuple(int(p) for p in spec.params))


def build_superblock_gs_pair_stencil(op, spec, *, dtype=np.float32,
                                     need_d: bool = False):
    """(L, U) const-mode superblock pair STRAIGHT from a constant-
    coefficient DeviceStencil — pure metadata, zero host CSR and zero
    O(nnz) work (the reference must materialize CRS factors,
    /root/reference/utilities/LU_factors.hpp:900-934; here the operator's
    legs ARE the factors).  Triangle membership: cross legs by superblock
    id order (src < tgt → L), self legs appear in BOTH triangles behind
    their x-parity masks."""
    plan = _stencil_pair_plan(op, spec)
    if not plan.fused:
        raise BlockIneligibleError(
            "analytic const-mode GS pair needs the fused layout "
            "(128 % nx == 0)")
    nx, ny, nz, sx, sy, sz = plan.spec_params
    S, m, TB, R_b = plan.S, plan.m, plan.TB, plan.R_b
    n = nx * ny * nz

    # dinv/d planes: the diagonal is one constant → a single (R_b, 128)
    # block shared by every superblock (same buffer, no copies)
    valid = (np.arange(R_b * LANES) < m)
    dinv_blk = jnp.asarray(
        np.where(valid, 1.0 / plan.diag_c, 0.0).astype(dtype)
        .reshape(R_b, LANES))
    d_blk = jnp.asarray(
        np.where(valid, plan.diag_c, 0.0).astype(dtype)
        .reshape(R_b, LANES))
    dinv = (dinv_blk,) * S

    selfs = tuple(dx for dx, _c in plan.self_legs)
    self_consts = tuple((c, dx) for dx, c in plan.self_legs)

    def one(upper: bool):
        order = range(S - 1, -1, -1) if upper else range(S)
        levels, cc = [], []
        for sb in order:
            rows = [(src, delta, c, leg) for src, delta, c, leg
                    in plan.per_sb[sb]
                    if (src > sb if upper else src < sb)]
            rows.sort(key=lambda r: (r[0], r[1]))
            levels.append((sb, tuple((src, delta) for src, delta, _, _
                                     in rows), selfs))
            cc.append(tuple((c,) + leg for _, _, c, leg in rows))
        nlev = len(levels)
        return SuperBlockTriSolve(
            vals_cross=(None,) * nlev, vals_self=(None,) * nlev,
            dinv=dinv,
            d=((d_blk,) * S if (need_d and not upper) else None),
            n_rows=n, S=S, m=m, R_b=R_b, TB=TB, sx=sx,
            levels=tuple(levels), upper=upper,
            spec_params=plan.spec_params, fused=True,
            const_cross=tuple(cc),
            const_self=(self_consts,) * nlev)

    return one(False), one(True)


def build_superblock_ilu0_pair(Ap, lu_val, perm, spec, *, dtype=np.float32,
                               tile_rows: int = _TB):
    """(L_blk, U_blk, U_D) for colored-ILU(0) factors straight off the
    color-PERMUTED CSR: no original-ordering triplet arrays at all.
    L solves with a unit diagonal, U with the peeled factor diagonal —
    the apply pair of blocked_ilu0.  Raises BlockIneligibleError when the
    fast path does not apply (callers fall back to the triplet pipeline).
    """
    return _sb_pack_pair_from_csr(Ap, lu_val, perm, spec, D_L=None,
                                  D_U=None, need_d_L=False, dtype=dtype,
                                  tile_rows=tile_rows)


# ---------------------------------------------------------------------------
# Translation-table exact ILU(0) for constant stencils: O(1) host work.
# ---------------------------------------------------------------------------

def stencil_ilu0_eligible(op, spec) -> bool:
    """Cheap predicate for build_superblock_ilu0_pair_stencil (metadata
    only).  Unlike the const-mode GS pair, the ILU(0) planes are real
    arrays, so BOTH superblock kernel layouts work — fused (128 % nx == 0)
    and split-parity (any nx, e.g. HPCG-384³)."""
    try:
        _stencil_pair_plan(op, spec)
        return True
    except (BlockIneligibleError, ImproperColoringError):
        return False


def _ilu0_translation_tables(op, spec_params, n_colors, pivot_tolerance,
                             pivot_replacement):
    """Exact colored-ILU(0) factor values for ANY grid size from one tiny
    prototype factorization.

    Why this is exact: under a proper grid coloring, row i's factored
    values depend only on rows k in its pattern with STRICTLY LOWER color
    (same-color rows are never pattern neighbors), recursively — so the
    dependency cone of any entry is a chain of at most (n_colors − 1)
    hops, each within the stencil's L∞ reach h.  With constant
    coefficients, two rows whose in-bounds masks agree on the radius
    R = h·n_colors ball therefore factor to IDENTICAL values.  Per axis,
    a row's mask on that ball is determined by min(i, R-ish) from each
    edge plus its phase i mod s (the coloring period), so a prototype of
    2R + s points per axis (edge-aligned + s interior phases) realizes
    every class.  The reference must factor all n rows
    (/root/reference/utilities/LU_factors.hpp:337-430); here the host
    factors ~(2R+s)³ rows (~ms) regardless of grid size.

    Returns (T, Tdiag, (Px, Py, Pz), R, h): T[kd, z, y, x] = the factor
    value of leg kd at prototype row (x, y, z) (0 where absent), Tdiag
    the U diagonal."""
    nx, ny, nz, sx, sy, sz = spec_params
    legs = [((dx, dy, dz), float(c))
            for (dx, dy, dz), c in zip(op.legs, op.coeff_values)
            if float(c) != 0.0]
    h = max(max(abs(dx), abs(dy), abs(dz)) for (dx, dy, dz), _c in legs)
    R = h * n_colors

    def proto(n_a, s_a):
        # identity axis when the grid is too small for distinct zones —
        # then the "prototype" axis IS the axis and mapping is exact
        if n_a <= 2 * R + 2 * s_a:
            return n_a
        # alignment P ≡ n (mod s) keeps the right-edge map phase-true
        return 2 * R + s_a + (n_a - (2 * R + s_a)) % s_a

    Px, Py, Pz = proto(nx, sx), proto(ny, sy), proto(nz, sz)
    Np = Px * Py * Pz
    idx = np.arange(Np, dtype=np.int64)
    x, y, z = _grid_coords(idx, Px, Py)
    rr, cc, vv = [], [], []
    for (dx, dy, dz), c in legs:
        mask = ((x + dx >= 0) & (x + dx < Px) & (y + dy >= 0)
                & (y + dy < Py) & (z + dz >= 0) & (z + dz < Pz))
        rr.append(idx[mask])
        cc.append(idx[mask] + (dx + Px * (dy + Py * dz)))
        vv.append(np.full(int(mask.sum()), c))
    from ..matrix import MatrixCOO, convert_coo_to_csr
    csr = convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(rr), np.concatenate(cc), np.concatenate(vv),
        n_rows=Np, n_cols=Np))
    from ..coloring import ColorSpec
    pspec = ColorSpec(kind="grid", n_colors=n_colors,
                      params=(Px, Py, Pz, sx, sy, sz))
    from ..factor import factor_ilu0_colored_triplets
    rows_o, cols_o, lu_vals, U_D = factor_ilu0_colored_triplets(
        csr, spec_colors_np(pspec, Np),
        pivot_tolerance=pivot_tolerance,
        pivot_replacement=pivot_replacement)
    xr, yr, zr = _grid_coords(np.asarray(rows_o), Px, Py)
    xc, yc, zc = _grid_coords(np.asarray(cols_o), Px, Py)
    w = 2 * h + 1
    kd = (xc - xr + h) + w * ((yc - yr + h) + w * (zc - zr + h))
    T = np.zeros((w * w * w, Pz, Py, Px), dtype=np.float64)
    T[kd, zr, yr, xr] = lu_vals
    Tdiag = np.asarray(U_D, dtype=np.float64).reshape(Pz, Py, Px)
    return T, Tdiag, (Px, Py, Pz), R, h


def build_superblock_ilu0_pair_stencil(op, spec, *, dtype=np.float32,
                                       pivot_tolerance: float = 1e-8,
                                       pivot_replacement: float = 1e-4):
    """(L, U) colored-ILU(0) superblock pair for a constant-coefficient
    DeviceStencil via TRANSLATION TABLES: the host factors only a
    ~(2R+s)³ prototype (milliseconds) and the full-size factor planes are
    gathered ON DEVICE from the resulting class table — no host CSR, no
    O(nnz) host pass at all.  Exactness argument in
    _ilu0_translation_tables; parity with the full CSR factorization is
    pinned by tests/test_block_trisolve.py.  Replaces a ~13-28 s
    host-throughput-bound setup at HPCG-128³ (~1.4 GB fused permute+
    factor sweep) with ~1 s.  Raises BlockIneligibleError /
    ImproperColoringError exactly like the analytic GS builder."""
    plan = _stencil_pair_plan(op, spec)
    nx, ny, nz, sx, sy, sz = plan.spec_params
    S, m, TB, R_b = plan.S, plan.m, plan.TB, plan.R_b
    n = nx * ny * nz
    n_colors = S * sx
    T_np, Td_np, (Px, Py, Pz), R, h = _ilu0_translation_tables(
        op, plan.spec_params, n_colors, pivot_tolerance, pivot_replacement)
    w = 2 * h + 1
    Np = Px * Py * Pz
    # cast at the TABLE (value-preserving through the gather): the planes
    # land directly at the solve dtype
    T_dev = jnp.asarray(T_np.reshape(w * w * w, Np).astype(dtype))
    Tdinv_dev = jnp.asarray((1.0 / Td_np).reshape(Np).astype(dtype))

    size = R_b * LANES
    my = ny // sy
    selfs = tuple(dx for dx, _c in plan.self_legs)

    # PACKED-TABLE mode: when every vreg row is x-pure (nx % 128 == 0) and
    # the x-classes clamp to ≤ 16 at the solve dtype (verified BITWISE on
    # the prototype table), store per-row x-class values instead of full
    # planes — 8 rows × 16 classes per packed lane row, 8× less factor
    # storage; the apply regenerates exact planes (_packed_expand_xla).
    PACK_SLOTS = 16
    dx_star = Pxr = None
    # capacity sizes only (PACK_MIN_ROWS); on the card neither side of
    # this size gate has been measured
    packed_ok = (not NO_PACKED and nx % LANES == 0 and plan.fused
                 and n > PACK_MIN_ROWS
                 and (TB % 64 == 0 or TB == R_b)
                 and np.dtype(dtype).itemsize <= 4)
    if packed_ok:
        Tc = T_np.astype(dtype)          # verify at the SOLVE dtype
        Tdc = Td_np.astype(dtype)
        dx_star = None
        for d in range(0, R + 1):
            ok = True
            for c in range(d, Px - d):
                rep = d + (c - d) % sx
                if not (np.array_equal(Tc[..., c], Tc[..., rep])
                        and np.array_equal(Tdc[..., c], Tdc[..., rep])):
                    ok = False
                    break
            if ok:
                dx_star = d
                break
        Pxr = None if dx_star is None else 2 * dx_star + sx
        packed_ok = Pxr is not None and Pxr <= PACK_SLOTS

    def _levels_for(upper: bool):
        order = range(S - 1, -1, -1) if upper else range(S)
        out = []
        for sb in order:
            rows = [r for r in plan.per_sb[sb]
                    if (r[0] > sb if upper else r[0] < sb)]
            rows.sort(key=lambda r: (r[0], r[1]))
            out.append((sb, rows))
        return out

    def _cls(i, n_a, P_a, s_a):
        if P_a == n_a:
            return i
        right = P_a - 1 - (n_a - 1 - i)
        inter = R + ((i - R) % s_a)
        return jnp.where(i < R, i,
                         jnp.where(n_a - 1 - i < R, right, inter))

    def _build(Tt, Tdi):
        """Both triangles' plane slabs + U dinv, one traced computation:
        slot coords are iota arithmetic, values one gather per group."""
        out = {}
        for upper in (False, True):
            lc, ls, ld = [], [], []
            for sb, rows in _levels_for(upper):
                s_idx = jnp.arange(size, dtype=jnp.int32)
                x = s_idx % nx
                t = s_idx // nx
                y = sy * (t % my) + sb % sy
                z = sz * (t // my) + sb // sy
                valid = s_idx < m
                base = (jnp.clip(_cls(x, nx, Px, sx), 0, Px - 1)
                        + Px * (jnp.clip(_cls(y, ny, Py, sy), 0, Py - 1)
                                + Py * jnp.clip(_cls(z, nz, Pz, sz),
                                                0, Pz - 1)))
                planes = []
                for _src, _delta, _c, (dx, dy, dz) in rows:
                    kdi = (dx + h) + w * ((dy + h) + w * (dz + h))
                    v = jnp.take(Tt[kdi], base)
                    planes.append(
                        jnp.where(valid, v, 0).reshape(R_b, LANES))
                lc.append(jnp.stack(planes) if planes else None)
                sp = []
                for dx in selfs:
                    kdi = (dx + h) + w * (h + w * h)
                    v = jnp.take(Tt[kdi], base)
                    ps, pt = (x + dx) % sx, x % sx
                    pm = (ps > pt) if upper else (ps < pt)
                    sp.append(
                        jnp.where(valid & pm, v, 0).reshape(R_b, LANES))
                ls.append(jnp.stack(sp) if sp else None)
                if upper:
                    dv = jnp.take(Tdi, base)
                    ld.append(jnp.where(valid, dv, 0).reshape(R_b, LANES))
            out[upper] = (tuple(lc), tuple(ls), tuple(ld))
        return out

    def _build_packed(Tt, Tdi):
        """Per-level packed slabs (G+1, R_b/8, 128): every leg's per-row
        reduced x-class values + the dinv row (ones for L), zeros at pad
        rows/slots; group order: cross, self, dinv."""
        out = {}
        r = jnp.arange(R_b, dtype=jnp.int32)
        tt = (r * jnp.int32(LANES)) // jnp.int32(nx)   # x-pure vreg rows
        validr = (r * jnp.int32(LANES)) < m
        xrep = jnp.asarray(
            [j if j < dx_star + sx else Px - Pxr + j
             for j in range(Pxr)] + [0] * (PACK_SLOTS - Pxr), jnp.int32)
        jvalid = jnp.arange(PACK_SLOTS) < Pxr
        phase = xrep % sx                              # proto ≡ axis phase
        for upper in (False, True):
            slabs = []
            for sb, rows in _levels_for(upper):
                y = sy * (tt % my) + sb % sy
                z = sz * (tt // my) + sb // sy
                rowbase = Px * (jnp.clip(_cls(y, ny, Py, sy), 0, Py - 1)
                                + Py * jnp.clip(_cls(z, nz, Pz, sz),
                                                0, Pz - 1))
                base2 = rowbase[:, None] + xrep[None, :]     # (R_b, 16)
                ok2 = validr[:, None] & jvalid[None, :]
                groups = []
                for _src, _delta, _c, (dx, dy, dz) in rows:
                    kdi = (dx + h) + w * ((dy + h) + w * (dz + h))
                    groups.append(
                        jnp.where(ok2, jnp.take(Tt[kdi], base2), 0))
                for dx in selfs:
                    kdi = (dx + h) + w * (h + w * h)
                    ps = jnp.mod(phase + dx, sx)
                    pm = (ps > phase) if upper else (ps < phase)
                    groups.append(
                        jnp.where(ok2 & pm[None, :],
                                  jnp.take(Tt[kdi], base2), 0))
                dv = (jnp.take(Tdi, base2) if upper
                      else jnp.ones((R_b, PACK_SLOTS), dtype=Tt.dtype))
                groups.append(jnp.where(ok2, dv, 0))
                slab = jnp.stack(groups)              # (G+1, R_b, 16)
                slabs.append(slab.reshape(len(groups), R_b // 8,
                                          8 * PACK_SLOTS))
            out[upper] = tuple(slabs)
        return out

    if packed_ok:
        built_packed = jax.jit(_build_packed)(T_dev, Tdinv_dev)
    else:
        built = jax.jit(_build)(T_dev, Tdinv_dev)

    valid_np = (np.arange(size) < m)
    ones_blk = jnp.asarray(
        np.where(valid_np, 1.0, 0.0).astype(dtype).reshape(R_b, LANES))

    def _assemble(upper: bool):
        levels = tuple(
            (sb, tuple((src, delta) for src, delta, _c, _leg in rows),
             selfs)
            for sb, rows in _levels_for(upper))
        if packed_ok:
            return SuperBlockTriSolve(
                vals_cross=(None,) * S, vals_self=(None,) * S,
                dinv=(), d=None, n_rows=n, S=S, m=m, R_b=R_b, TB=TB,
                sx=sx, levels=levels, upper=upper,
                spec_params=plan.spec_params, fused=plan.fused,
                packed=built_packed[upper],
                pack_geom=(PACK_SLOTS, Pxr, dx_star))
        lc, ls, ld = built[upper]
        # dinv is indexed BY SUPERBLOCK ID (B.dinv[sb]); ld was collected
        # in LEVEL order, which for the upper triangle is sb = S-1 … 0
        return SuperBlockTriSolve(
            vals_cross=lc, vals_self=ls,
            dinv=(tuple(reversed(ld)) if upper else (ones_blk,) * S),
            d=None, n_rows=n, S=S, m=m, R_b=R_b, TB=TB, sx=sx,
            levels=levels, upper=upper,
            spec_params=plan.spec_params, fused=plan.fused)

    return _assemble(False), _assemble(True)


def _permute_super(B: SuperBlockTriSolve, y: jax.Array):
    nx, ny, nz, sx, sy, sz = B.spec_params
    my, mz = ny // sy, nz // sz
    arr = (y.reshape(mz, sz, my, sy, nx)
           .transpose(1, 3, 0, 2, 4)
           .reshape(B.S, B.m))
    arr = jnp.pad(arr, ((0, 0), (0, B.R_b * LANES - B.m)))
    return tuple(arr[s].reshape(B.R_b, LANES) for s in range(B.S))


def _unpermute_super(B: SuperBlockTriSolve, xb) -> jax.Array:
    nx, ny, nz, sx, sy, sz = B.spec_params
    my, mz = ny // sy, nz // sz
    arr = jnp.stack([x.reshape(-1)[:B.m] for x in xb])
    return (arr.reshape(sz, sy, mz, my, nx)
            .transpose(2, 0, 3, 1, 4)
            .reshape(B.n_rows))


def _parity_order(B: SuperBlockTriSolve):
    return range(B.sx - 1, -1, -1) if B.upper else range(B.sx)


def _leg_mask_jnp(B, sb: int, leg, slot, self_leg: bool = False):
    """In-register (R_b-or-tile, LANES) in-bounds mask of `leg` at target
    superblock `sb` — the trace-time regeneration of a constant plane's
    nonzero structure (works under jit on any backend; all i32).
    `self_leg` adds the x-parity triangle condition (see _leg_mask_np)."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    my = ny // sy
    dx, dy, dz = leg
    x = jax.lax.rem(slot, jnp.int32(nx))
    mask = slot < jnp.int32(B.m)
    if dx > 0:
        mask &= x < jnp.int32(nx - dx)
    elif dx < 0:
        mask &= x >= jnp.int32(-dx)
    if self_leg:
        # shift by a multiple of sx so the rem operand stays non-negative
        K = sx * ((abs(dx) + sx - 1) // sx)
        ps = jax.lax.rem(x + jnp.int32(dx + K), jnp.int32(sx))
        pt = jax.lax.rem(x, jnp.int32(sx))
        mask &= (ps > pt) if B.upper else (ps < pt)
    if dy or dz:
        t = jax.lax.div(slot, jnp.int32(nx))
        if dy:
            y = (jax.lax.rem(t, jnp.int32(my)) * jnp.int32(sy)
                 + jnp.int32(sb % sy))
            if dy > 0:
                mask &= y < jnp.int32(ny - dy)
            else:
                mask &= y >= jnp.int32(-dy)
        if dz:
            z = (jax.lax.div(t, jnp.int32(my)) * jnp.int32(sz)
                 + jnp.int32(sb // sy))
            if dz > 0:
                mask &= z < jnp.int32(nz - dz)
            else:
                mask &= z >= jnp.int32(-dz)
    return mask


def _packed_cx(x, nx, pack_geom, sx):
    """Reduced x-class id per element — the verified-bitwise clamp map
    (edge positions exact, interior collapsed to its phase)."""
    _slots, Pxr, dxs = pack_geom
    hi = jnp.int32(nx) - 1 - x
    inter = jnp.int32(dxs) + jax.lax.rem(x - jnp.int32(dxs),
                                         jnp.int32(sx))
    return jnp.where(x < jnp.int32(dxs), x,
                     jnp.where(hi < jnp.int32(dxs),
                               jnp.int32(Pxr) - 1 - hi, inter))


def _packed_expand_xla(B, li):
    """All of one level's planes + dinv from its packed slab (XLA path):
    (G+1, R_b, 128), group order cross…self…dinv."""
    nx = B.spec_params[0]
    slots = B.pack_geom[0]
    slab = B.packed[li]
    G_all = slab.shape[0]
    flat = slab.reshape(G_all, B.R_b, slots)
    slot = jnp.arange(B.R_b * LANES, dtype=jnp.int32).reshape(B.R_b, LANES)
    cx = _packed_cx(slot % jnp.int32(nx), nx, B.pack_geom, B.sx)
    idx = jnp.broadcast_to(cx[None], (G_all, B.R_b, LANES))
    from jax._src.config import enable_x64 as _x64_ctx
    with _x64_ctx(False):
        return jnp.take_along_axis(flat, idx, axis=2)


def _super_level_xla(B, li, y_blk, xb):
    sb, cross, selfs = B.levels[li]
    nx = B.spec_params[0]
    const = B.is_const
    slot = jnp.arange(B.R_b * LANES, dtype=jnp.int32).reshape(B.R_b, LANES)
    pk = _packed_expand_xla(B, li) if B.is_packed else None
    dinv_blk = pk[len(cross) + len(selfs)] if pk is not None \
        else B.dinv[sb]
    acc = y_blk
    for gi, (src, delta) in enumerate(cross):
        shifted = _shifted_read_xla(xb[src], delta)
        if const:
            c, dx, dy, dz = B.const_cross[li][gi]
            plane = jnp.where(_leg_mask_jnp(B, sb, (dx, dy, dz), slot),
                              jnp.asarray(c, y_blk.dtype), 0)
        elif pk is not None:
            plane = pk[gi]
        else:
            plane = B.vals_cross[li][gi]
        acc = acc - plane * shifted
    parity = (slot % jnp.int32(nx)) % jnp.int32(B.sx)
    xt = jnp.zeros_like(y_blk)
    for cx in _parity_order(B):
        a = acc
        for gi, dx in enumerate(selfs):
            if const:
                c, sdx = B.const_self[li][gi]
                plane = jnp.where(_leg_mask_jnp(B, sb, (sdx, 0, 0), slot,
                                                self_leg=True),
                                  jnp.asarray(c, y_blk.dtype), 0)
            elif pk is not None:
                plane = pk[len(cross) + gi]
            else:
                plane = B.vals_self[li][gi]
            a = a - plane * _shifted_read_xla(xt, dx)
        xt = jnp.where(parity == jnp.int32(cx), a * dinv_blk, xt)
    return xt


def _solve_super(B: SuperBlockTriSolve, yb):
    xb = [None] * B.S
    for li, (sb, _c, _s) in enumerate(B.levels):
        xb[sb] = _super_level_xla(B, li, yb[sb], xb)
    return xb


# ---------------------------------------------------------------------------
# Unified applies over both layouts
# ---------------------------------------------------------------------------

def _permute_any(B, y):
    if isinstance(B, SuperBlockTriSolve):
        return _permute_super(B, y)
    return permute_blocks(B, y)


def _unpermute_any(B, xb):
    if isinstance(B, SuperBlockTriSolve):
        return _unpermute_super(B, xb)
    return unpermute_blocks(B, xb)


def _solve_any(B, yb):
    if isinstance(B, SuperBlockTriSolve):
        return _solve_super(B, yb)
    return solve_blocks(B, yb)


def build_best_trisolve(T, D, colors, spec, *, upper: bool,
                        dtype=np.float32, need_d: bool = False):
    """Superblock form when the grid qualifies, else rank-space blocks.
    `T` may be a MatrixCSR or raw (rows, cols, vals, n) triplets."""
    if spec.kind == "grid":
        try:
            return build_superblock_trisolve(T, D, colors, spec, upper=upper,
                                             dtype=dtype, need_d=need_d)
        except ImproperColoringError:
            raise
        except BlockIneligibleError:
            pass
    return build_blocked_trisolve(T, D, colors, spec, upper=upper,
                                  dtype=dtype, need_d=need_d)


def build_best_trisolve_pair(T, D_L, D_U, colors, spec, *,
                             dtype=np.float32, need_d: bool = False):
    """Build the (lower, upper) solve pair in ONE CONSISTENT layout.

    blocked_sgs/blocked_ilu0 feed the L-solve's block-layout output
    straight into the U-solve, so the two objects must share their layout
    class and permutation; building them independently could mix a
    SuperBlockTriSolve L with a rank-space U on matrices where only one
    triangle trips a superblock-only eligibility check.  Expands the
    entries once and falls back AS A PAIR."""
    trip = _entries_of(T)
    if spec.kind == "grid":
        try:
            # ONE native analysis pass shared by both triangles
            analysis = _native_analysis_for(trip, colors, spec)
            return (build_superblock_trisolve(trip, D_L, colors, spec,
                                              upper=False, dtype=dtype,
                                              need_d=need_d,
                                              _analysis=analysis),
                    build_superblock_trisolve(trip, D_U, colors, spec,
                                              upper=True, dtype=dtype,
                                              _analysis=analysis))
        except ImproperColoringError:
            raise
        except BlockIneligibleError:
            pass
    return (build_blocked_trisolve(trip, D_L, colors, spec, upper=False,
                                   dtype=dtype, need_d=need_d),
            build_blocked_trisolve(trip, D_U, colors, spec, upper=True,
                                   dtype=dtype))


def solve_blocks(B: BlockedTriSolve, yb):
    """Level loop on block-layout rhs; returns x blocks (list, color order
    indices — element c is color c's block)."""
    xb = [None] * B.n_colors
    for c, groups in B.levels:
        if not groups:
            xb[c] = yb[c] * B.dinv[c]
        else:
            xb[c] = _level_xla(B, groups, yb[c], B.dinv[c], xb)
    return xb


def blocked_trisolve(B: BlockedTriSolve, y: jax.Array) -> jax.Array:
    """x = (T_color + D)⁻¹ y — same action as the colored_sweep solve with
    the same coloring (exact GS solve in the color-sorted ordering)."""
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _blocked_trisolve_impl, B, y)


def _blocked_trisolve_impl(B, y):
    yb = _permute_any(B, y)
    xb = _solve_any(B, yb)
    return _unpermute_any(B, xb)


def blocked_sgs(L, U, y: jax.Array) -> jax.Array:
    """(U_c+D)⁻¹ D (L_c+D)⁻¹ y — the exact colored symmetric GS apply,
    permuting in/out of block layout once (L must be built need_d=True)."""
    yb = _permute_any(L, y)
    tb = _solve_any(L, yb)
    tb = [t * d for t, d in zip(tb, L.d)]
    xb = _solve_any(U, tb)
    return _unpermute_any(U, xb)


def blocked_ilu0(L, U, y: jax.Array) -> jax.Array:
    """U⁻¹ L⁻¹ y with unit-diagonal L (colored ILU(0) apply)."""
    yb = _permute_any(L, y)
    tb = _solve_any(L, yb)
    xb = _solve_any(U, tb)
    return _unpermute_any(U, xb)
