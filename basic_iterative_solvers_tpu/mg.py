"""Geometric multigrid preconditioner for matrix-free stencil operators.

An addition with no reference analog (-p mg): the reference's
preconditioner menu (reference kernels.hpp:336-414) tops out at
ILU(0), whose solve cost per iteration is flat but whose iteration count
still grows with the grid (kappa ~ h^-2).  A V-cycle over the rediscretized/
Galerkin hierarchy makes the CG iteration count grid-size-independent, so
time-to-solution scales linearly with rows — the decisive regime for the
capacity benchmarks.

Design (all pieces reuse the existing stencil machinery):

* Hierarchy: every matrix family this applies to is a constant-coefficient
  stencil (stencil_op.py), so each coarse level is just another
  `DeviceStencil` on the (d+1)//2 grid — SpMV stays the zero-matrix-traffic
  stencil SpMV at every level.
* Transfers: vertex-centered, coarse point c <-> fine point 2c.
  "linear"    — prolongation = scatter-to-even then a [1/2, 1, 1/2]
                convolution per axis (trilinear interpolation);
                restriction is its exact transpose (same convolution, then
                sample-even): full weighting.  R = P^T by construction.
  "injection" — scatter/sample only (the HPCG scheme, HPCG's
                ComputeProlongation/ComputeRestriction).
* Coarse operator: "galerkin" computes the interior stencil of P^T A P
  exactly with a tiny numpy probe (constant coefficients make it a
  constant stencil again); "rediscretize" reuses the fine coefficients
  (HPCG's choice, required for injection where Galerkin degenerates).
* Smoother: the Chebyshev semi-iteration already used by -p cheby
  (precond._cheby_apply's recurrence, generalized to a nonzero initial
  iterate) — symmetric, communication-free, SPD-preserving, so the V-cycle
  is a valid CG preconditioner: R = P^T + identical pre/post smoothing +
  symmetric coarsest solve  =>  M is symmetric positive definite
  (verified numerically in tests/test_mg.py).

Vectors at each level live in that level's operator layout (flat, or the
planar halo form with planar_vectors="on"); the transfers decode/encode at
the level boundary — a few
extra vector passes at 1/8 the size per level.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.spmv import spmv
from .stencil_op import (DeviceStencil, from_planar_vec,
                         make_stencil, stencil_diag_vec, to_planar_matrix,
                         to_planar_vec)


_HIGHEST = jax.lax.Precision.HIGHEST


@partial(jax.tree_util.register_dataclass,
         data_fields=["A", "D_inv", "lmax"], meta_fields=[])
@dataclasses.dataclass
class MGLevel:
    """One grid level: operator, Jacobi scaling, Chebyshev interval top."""

    A: DeviceStencil
    D_inv: jax.Array          # in A's vector layout (planar halos = 1.0)
    lmax: jax.Array           # lambda_max(D^-1 A) upper bound (scalar)


# ---------------------------------------------------------------------------
# Transfers.  Flat (n,) <-> flat (n_c,) on the x-fastest grid ordering;
# layout encode/decode happens at the call site (level boundary).
# ---------------------------------------------------------------------------

def coarse_dims(dims) -> Tuple[int, int, int]:
    """Vertex-centered coarsening: coarse point c sits on fine point 2c, so
    a d-point axis keeps ceil(d/2) points (size-1 axes stay 1)."""
    return tuple(1 if d == 1 else (d + 1) // 2 for d in dims)


def _axis_transfer_matrix(nf: int, nc: int, transfer: str) -> np.ndarray:
    """(nf, nc) one-axis restriction matrix R_ax (vertex-centered, zero
    boundary): R[2c, c] = 1 and, for "linear", R[2c±1, c] = 1/2 — exactly
    conv([1/2, 1, 1/2]) followed by even sampling.  Prolongation along the
    axis is R_axᵀ, so R = Pᵀ holds by construction."""
    R = np.zeros((nf, nc), dtype=np.float64)
    for c in range(nc):
        R[2 * c, c] = 1.0
        if transfer == "linear":
            if 2 * c - 1 >= 0:
                R[2 * c - 1, c] = 0.5
            if 2 * c + 1 < nf:
                R[2 * c + 1, c] = 0.5
    return R


@partial(jax.jit, static_argnames=("fdims", "cdims", "transfer", "up"))
def _tensor_transfer(v, fdims, cdims, transfer, up):
    """Tensor-product grid transfer as THREE tiny constant matmuls (in
    place of strided gathers / interior-padded scatters).  The contractions
    run at full f32 precision (precision=HIGHEST): a TF32 product would
    round the transfer weights to ~3 decimal digits.  `up=False`:
    r_c = R r_f; `up=True`: z_f = Pᵀ… = R applied transposed per axis."""
    nxf, nyf, nzf = fdims
    nxc, nyc, nzc = cdims
    dt = v.dtype
    Rx = jnp.asarray(_axis_transfer_matrix(nxf, nxc, transfer), dt)
    Ry = jnp.asarray(_axis_transfer_matrix(nyf, nyc, transfer), dt)
    Rz = jnp.asarray(_axis_transfer_matrix(nzf, nzc, transfer), dt)
    if up:
        z3 = v.reshape(nzc, nyc, nxc)
        z3 = jnp.einsum("zyx,Xx->zyX", z3, Rx, precision=_HIGHEST)
        z3 = jnp.einsum("zyX,Yy->zYX", z3, Ry, precision=_HIGHEST)
        z3 = jnp.einsum("zYX,Zz->ZYX", z3, Rz, precision=_HIGHEST)
        return z3.reshape(nxf * nyf * nzf)
    r3 = v.reshape(nzf, nyf, nxf)
    r3 = jnp.einsum("zyx,xX->zyX", r3, Rx, precision=_HIGHEST)
    r3 = jnp.einsum("zyX,yY->zYX", r3, Ry, precision=_HIGHEST)
    r3 = jnp.einsum("zYX,zZ->ZYX", r3, Rz, precision=_HIGHEST)
    return r3.reshape(nxc * nyc * nzc)


def restrict_flat(rf: jax.Array, fdims, cdims, transfer: str) -> jax.Array:
    """r_c = R r_f (flat vectors, fdims/cdims = (nx, ny, nz))."""
    return _tensor_transfer(rf, tuple(fdims), tuple(cdims), transfer, False)


def prolong_flat(zc: jax.Array, fdims, cdims, transfer: str) -> jax.Array:
    """z_f = P z_c = Rᵀ z_c (flat vectors)."""
    return _tensor_transfer(zc, tuple(fdims), tuple(cdims), transfer, True)


# ---------------------------------------------------------------------------
# Galerkin coarse stencil via a numpy probe.
#
# With constant coefficients and constant-coefficient transfers, P^T A P is
# itself a constant stencil in the interior; its coefficients are read off
# by applying R.A.P to a coarse delta on a probe grid large enough that no
# boundary mask touches the chain's support.  (Boundary rows of the true
# Galerkin operator differ; the coarse DeviceStencil approximates them with
# its own open-boundary masks — the standard rediscretization compromise,
# and M stays symmetric because the coarse operator is symmetric either way.)
# ---------------------------------------------------------------------------

def _np_apply(legs_coeffs, x3):
    """y = A x for a constant stencil on an open-boundary grid (numpy)."""
    nz, ny, nx = x3.shape
    y = np.zeros_like(x3)

    def sl(d, n):
        return (slice(max(0, -d), n - max(0, d)),
                slice(max(0, d), n - max(0, -d)))

    for (dx, dy, dz), c in legs_coeffs:
        if abs(dx) >= nx or abs(dy) >= ny or abs(dz) >= nz:
            continue
        (zd, zs), (yd, ys), (xd, xs) = sl(dz, nz), sl(dy, ny), sl(dx, nx)
        y[zd, yd, xd] += c * x3[zs, ys, xs]
    return y


def _np_conv_axis(a, axis):
    if a.shape[axis] == 1:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 1)
    p = np.pad(a, pad)
    n = a.shape[axis]
    lo = p.take(range(0, n), axis=axis)
    hi = p.take(range(2, n + 2), axis=axis)
    return a + 0.5 * (lo + hi)


def _np_restrict(r3, transfer):
    if transfer == "linear":
        for ax in range(3):
            r3 = _np_conv_axis(r3, ax)
    return r3[::2, ::2, ::2]


def _np_prolong(z3, fshape, transfer):
    f = np.zeros(fshape, dtype=z3.dtype)
    f[::2, ::2, ::2] = z3
    if transfer == "linear":
        for ax in range(3):
            f = _np_conv_axis(f, ax)
    return f


def galerkin_coarse_coeffs(legs_coeffs, dims, transfer: str):
    """Interior stencil of P^T A P as [((dx,dy,dz), c), ...] (numpy probe).

    `dims` only signals which axes are degenerate (size 1); the probe grid
    is sized from the stencil reach so no boundary mask is touched.
    """
    p = 1 if transfer == "linear" else 0
    reach = [0, 0, 0]
    for (dx, dy, dz), _ in legs_coeffs:
        reach = [max(reach[0], abs(dx)), max(reach[1], abs(dy)),
                 max(reach[2], abs(dz))]
    # per-axis fine probe dim: coarse center c0 = m+1, fine f0 = 2c0, fine
    # support f0 +/- m stays >= 1 away from both boundaries
    m = [r + 2 * p for r in reach]
    nf = [1 if d == 1 else 4 * mm + 5 for mm, d in zip(m, dims)]
    nc = [1 if d == 1 else 2 * mm + 3 for mm, d in zip(m, dims)]
    c0 = [0 if d == 1 else mm + 1 for mm, d in zip(m, dims)]
    ec = np.zeros((nc[2], nc[1], nc[0]))
    ec[c0[2], c0[1], c0[0]] = 1.0
    zf = _np_prolong(ec, (nf[2], nf[1], nf[0]), transfer)
    yf = _np_apply(legs_coeffs, zf)
    wc = _np_restrict(yf, transfer)
    tol = 1e-12 * max(1.0, np.abs(wc).max())
    out = []
    for dz in range(-(nc[2] // 2), nc[2] // 2 + 1):
        for dy in range(-(nc[1] // 2), nc[1] // 2 + 1):
            for dx in range(-(nc[0] // 2), nc[0] // 2 + 1):
                v = wc[c0[2] + dz, c0[1] + dy, c0[0] + dx]
                if abs(v) > tol:
                    out.append(((dx, dy, dz), float(v)))
    return out


# ---------------------------------------------------------------------------
# Hierarchy setup
# ---------------------------------------------------------------------------

def gershgorin_lmax(legs_coeffs, dtype) -> jax.Array:
    """Gershgorin upper bound on lambda_max(D^-1 A) for a constant stencil:
    every row's disk is centered at 1 with radius <= sum|offdiag|/|diag|
    (interior rows hit the max; boundary rows have smaller radii)."""
    diag = 0.0
    off = 0.0
    for (dx, dy, dz), c in legs_coeffs:
        if dx == 0 and dy == 0 and dz == 0:
            diag += c
        else:
            off += abs(c)
    if diag == 0:
        raise ValueError("zero diagonal coefficient in the coarse stencil")
    return jnp.asarray(1.0 + off / abs(diag), dtype=dtype)


def _auto_n_levels(dims) -> int:
    n = 1
    d = dims
    while min(x for x in coarse_dims(d) if x > 1) >= 8 and n < 8:
        d = coarse_dims(d)
        n += 1
    return n


def build_mg_hierarchy(A_dev: DeviceStencil, config) -> Tuple[MGLevel, ...]:
    """Build the level tuple for `-p mg`.  Raises with guidance for inputs
    multigrid cannot serve (explicit formats, dense-diagonal stencils)."""
    if not isinstance(A_dev, DeviceStencil):
        raise ValueError(
            "multigrid requires the matrix-free stencil operator "
            "(matrix_format='stencil', generator sources hpcg:/fdm:); "
            f"got {type(A_dev).__name__}")
    if A_dev.diag is not None:
        raise ValueError(
            "multigrid needs constant coefficients to build coarse "
            "operators; this stencil carries a dense diagonal (Anderson "
            "random potential) — use '-p cheby' instead")
    transfer = config.mg_transfer
    if transfer not in ("linear", "injection"):
        raise ValueError(f"unknown mg_transfer: {transfer!r}")
    coarse_op = config.mg_coarse_op
    if coarse_op == "auto":
        coarse_op = "galerkin" if transfer == "linear" else "rediscretize"
    if coarse_op not in ("galerkin", "rediscretize"):
        raise ValueError(f"unknown mg_coarse_op: {coarse_op!r}")
    if coarse_op == "galerkin" and transfer == "injection":
        raise ValueError("Galerkin with injection transfers degenerates to "
                         "a diagonal coarse operator; use "
                         "mg_transfer='linear' or mg_coarse_op="
                         "'rediscretize'")
    n_levels = config.mg_levels or _auto_n_levels(A_dev.dims)
    if n_levels < 1:
        raise ValueError("mg_levels must be >= 1")

    dtype = config.spec_dtype()
    planar = A_dev.planar
    levels = []
    A_l = A_dev
    legs_coeffs = [(leg, c) for leg, c in zip(A_dev.legs,
                                              A_dev.coeff_values)]
    dims = A_dev.dims
    for l in range(n_levels):
        D = stencil_diag_vec(A_l)
        if bool(jnp.any(D == 0)):
            raise ValueError("zero on the matrix diagonal")
        D_inv = (1.0 / D).astype(dtype)
        # lambda_max(D^-1 A) via Gershgorin: 1 + sum|offdiag|/|diag| — an
        # UPPER bound (tight for stencils: 2.00 vs a true 1.97 on the 27-pt
        # operator), and trace-time free for constant coefficients.  A
        # power-iteration UNDER-estimate here is catastrophic: the high-
        # degree coarse Chebyshev polynomial explodes above its interval
        # (measured: an indefinite M^-1 with eig -13 on hpcg:8^3), whereas
        # the over-estimate only rounds off a little smoothing efficiency.
        lmax = gershgorin_lmax(legs_coeffs, dtype)
        levels.append(MGLevel(A=A_l, D_inv=D_inv, lmax=lmax))
        if l + 1 == n_levels:
            break
        cdims = coarse_dims(dims)
        if max(cdims) < 2:
            break   # nothing left to coarsen
        if coarse_op == "galerkin":
            legs_coeffs = galerkin_coarse_coeffs(legs_coeffs, dims, transfer)
        dims = cdims
        A_l = make_stencil(legs_coeffs, *dims, dtype=A_dev.dtype)
        if planar:
            A_l = to_planar_matrix(A_l)
    return tuple(levels)


# ---------------------------------------------------------------------------
# Apply: V(nu, nu) cycle with Chebyshev smoothing
# ---------------------------------------------------------------------------

def _cheby_smooth(lev: MGLevel, y, z0, degree: int, ratio: float):
    """`degree` Chebyshev steps toward A z = y from z0 (None = zero): the
    -p cheby recurrence (precond._cheby_apply) generalized to a nonzero
    initial iterate.  Symmetric: z - z0 = p(D^-1 A) D^-1 (y - A z0)."""
    lmax = lev.lmax.astype(y.dtype)
    lmin = lmax / ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    dinv = lev.D_inv
    if z0 is None:
        resid = y
        z = None
    else:
        z = z0
        resid = y - spmv(lev.A, z)
    d = (dinv * resid) / theta
    z = d if z is None else z + d
    rho = 1.0 / sigma
    for _ in range(max(1, degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        resid = y - spmv(lev.A, z)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * resid)
        z = z + d
        rho = rho_new
    return z


def _between(Af: DeviceStencil, Ac: DeviceStencil, v, transfer: str,
             down: bool):
    """Transfer v between level layouts (decode -> flat transfer -> encode)."""
    if down:
        vf = from_planar_vec(Af, v) if Af.planar else v
        vc = restrict_flat(vf, Af.dims, Ac.dims, transfer)
        return to_planar_vec(Ac, vc) if Ac.planar else vc
    vc = from_planar_vec(Ac, v) if Ac.planar else v
    vf = prolong_flat(vc, Af.dims, Ac.dims, transfer)
    return to_planar_vec(Af, vf) if Af.planar else vf


def mg_vcycle(levels: Tuple[MGLevel, ...], y, smooth_degree: int,
              coarse_degree: int, ratio: float, coarse_ratio: float,
              transfer: str, _l: int = 0):
    """z = M^-1 y: one V(nu, nu) cycle (python recursion over the static
    level tuple — fully unrolled under jit).

    `ratio` bounds the smoothing interval [lmax/ratio, lmax] — the
    smoother only needs to damp the upper spectrum (the coarse grid owns
    the rest), so it is small (hypre-style ~4).  The coarsest level has no
    coarser grid below it, so its Chebyshev solve covers the full spectrum
    with the wide `coarse_ratio` interval instead."""
    lev = levels[_l]
    if _l == len(levels) - 1:
        return _cheby_smooth(lev, y, None, coarse_degree, coarse_ratio)
    z = _cheby_smooth(lev, y, None, smooth_degree, ratio)
    resid = y - spmv(lev.A, z)
    rc = _between(lev.A, levels[_l + 1].A, resid, transfer, down=True)
    zc = mg_vcycle(levels, rc, smooth_degree, coarse_degree, ratio,
                   coarse_ratio, transfer, _l=_l + 1)
    z = z + _between(lev.A, levels[_l + 1].A, zc, transfer, down=False)
    return _cheby_smooth(lev, y, z, smooth_degree, ratio)


def estimated_vcycle_passes(levels, smooth_degree: int,
                            coarse_degree: int) -> float:
    """Roofline estimate: vector passes per apply, summed over levels with
    their size ratios.  Tensor-product transfers are 3 small contractions
    whose traffic is ~read fine + write intermediate sizes ≈ 4 passes at
    the finer level's size for the restrict+prolong pair."""
    n0 = max(1, levels[0].A.n_rows)
    total = 0.0
    for l, lev in enumerate(levels):
        ratio = lev.A.n_rows / n0
        last = l == len(levels) - 1
        if last:
            smooth = 3.0 + 6.0 * max(0, coarse_degree - 1)
        else:
            smooth = 2.0 * (3.0 + 6.0 * max(0, smooth_degree - 1))
            smooth += 3.0 + 4.0          # residual + transfer pair
        total += ratio * smooth
    return total
