"""SpMV — the hot kernel (O(nnz) per solver iteration).

Device replacement for native_spmv (reference kernels.hpp:22-42), one
path per format:

* DIA: y = Σ_d data[d] * shift(x, off_d).  Offsets are static, so each shift
  is a static slice of a zero-padded x; XLA fuses the whole multiply-add
  chain into one bandwidth-bound loop.
* ELL: one vectorized gather x[cols] plus a row-sum.
* lane-ELL and matrix-free stencils: see ops/lane_ell.py and stencil_op.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..device_matrix import DeviceDIA, DeviceELL


def spmv_dia(A: DeviceDIA, x: jax.Array) -> jax.Array:
    n = A.n_rows
    if not A.offsets:   # no stored diagonals (e.g. strict part of diag-only)
        return jnp.zeros(n, dtype=x.dtype)
    # DIA is used for square matrices only (the solver path guarantees this;
    # rectangular cases fall back to ELL in from_csr).  The data row
    # dimension is tile-padded (device_matrix.csr_to_dia), so slices run over
    # npad and the result is cropped.
    npad = A.data.shape[1]
    hneg = max(0, -min(A.offsets))
    hpos = max(0, max(A.offsets))
    # jnp.pad, NOT zeros().at[slice].set(x): the scatter form makes GSPMD
    # ALL-GATHER the full row-sharded x every SpMV (seen in the partitioned
    # HLO as `all-gather` with op_name .../scatter); a pad op partitions
    # natively and the shifted slices below become neighbor
    # collective-permute halo exchanges (tests/test_gspmd.py pins this).
    xp = jnp.pad(x, (hneg, npad - n + hpos))
    y = jnp.zeros(npad, dtype=x.dtype)
    for d, off in enumerate(A.offsets):
        start = hneg + off
        y = y + A.data[d] * jax.lax.slice(xp, (start,), (start + npad,))
    return y[:n]


def spmv_ell(A: DeviceELL, x: jax.Array) -> jax.Array:
    xg = jnp.take(x, A.cols, axis=0)           # (n_rows, K) gather
    return jnp.sum(A.data * xg, axis=1)


def spmv(A, x: jax.Array) -> jax.Array:
    """y = A @ x (dispatch on device format).  TIME'd as "spmv" in the
    host harness's kernel-timing mode (reference kernels.hpp:25)."""
    from ..utils.ktimers import ktime
    return ktime("spmv", _spmv_impl, A, x)


def _spmv_impl(A, x: jax.Array) -> jax.Array:
    if isinstance(A, DeviceDIA):
        return spmv_dia(A, x)
    if isinstance(A, DeviceELL):
        return spmv_ell(A, x)
    from .lane_ell import DeviceLaneELL, lane_ell_spmv
    if isinstance(A, DeviceLaneELL):
        return lane_ell_spmv(A, x)
    from ..stencil_op import DeviceStencil, stencil_spmv
    if isinstance(A, DeviceStencil):
        return stencil_spmv(A, x)
    raise TypeError(f"unsupported device matrix type: {type(A)}")


def spmv_dot(A, x: jax.Array):
    """(A @ x, dot(A@x, x)) — CG's α denominator."""
    from ..utils.ktimers import ktime
    return ktime("spmv", _spmv_dot_impl, A, x)


def _spmv_dot_impl(A, x: jax.Array):
    from .blas1 import _dot_nd
    y = _spmv_impl(A, x)
    return y, _dot_nd(y, x)


def spmv_dots(A, x: jax.Array, aux: jax.Array = None,
              with_self: bool = False):
    """y = A @ x plus reductions: returns (y[, dot(y,aux)][, dot(y,y)])
    — BiCGSTAB's α/ω dots."""
    from ..utils.ktimers import ktime
    return ktime("spmv", _spmv_dots_impl, A, x, aux, with_self)


def _spmv_dots_impl(A, x: jax.Array, aux: jax.Array = None,
                    with_self: bool = False):
    from .blas1 import _dot_nd
    y = _spmv_impl(A, x)
    out = (y,)
    if aux is not None:
        out += (_dot_nd(y, aux),)
    if with_self:
        out += (_dot_nd(y, y),)
    return out


def compute_residual(A, x: jax.Array, b: jax.Array) -> jax.Array:
    """residual = b - A@x (reference compute_residual, kernels.hpp:155-162)."""
    return b - spmv(A, x)
