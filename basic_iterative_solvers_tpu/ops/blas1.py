"""BLAS-1 vector kernels — the solver hot path's named kernel layer.

Functional analogs of reference kernels.hpp:119-257.  Under jit these are
single fused loops (XLA inlines and fuses them into the surrounding
computation, so the indirection is free).  All solver methods
(solvers/{cg,jacobi,gauss_seidel,gmres,bicgstab}.py) route their axpy/dot/
norm operations through these functions, keeping parity with the reference
kernels auditable at the call sites.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def subtract_vectors(v1, v2, scale_=1.0):
    """r = v1 - scale*v2  (kernels.hpp:119-126)."""
    from ..utils.ktimers import ktime
    return ktime("sum", lambda a, b: a - scale_ * b, v1, v2)


def sum_vectors(v1, v2, scale_=1.0):
    """r = v1 + scale*v2  (kernels.hpp:128-135)."""
    from ..utils.ktimers import ktime
    return ktime("sum", lambda a, b: a + scale_ * b, v1, v2)


def elemwise_mult_vectors(v1, v2, scale_=1.0):
    """r = v1 * (scale*v2)  (kernels.hpp:137-144)."""
    return v1 * (scale_ * v2)


def elemwise_div_vectors(v1, v2, scale_=1.0):
    """r = v1 / (scale*v2)  (kernels.hpp:146-153)."""
    return v1 / (scale_ * v2)


def _dot_nd(a, b):
    # precision=HIGHEST: an f32 dot may otherwise run in TF32 on GPUs.
    # Planar-resident vectors are 2-D (rows, 128); jnp.dot would matmul —
    # reduce elementwise instead.
    if a.ndim == 1:
        return jnp.dot(a, b, preferred_element_type=a.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(a * b, dtype=a.dtype)


def dot(v1, v2):
    """(v1, v2)  (kernels.hpp:205-212)."""
    from ..utils.ktimers import ktime
    return ktime("dot", _dot_nd, v1, v2)


def euclidean_vec_norm(v):
    """||v||_2  (kernels.hpp:194-203)."""
    from ..utils.ktimers import ktime
    return ktime("norm", lambda a: jnp.sqrt(_dot_nd(a, a)), v)


def infty_vec_norm(v):
    """max |v_i|  (kernels.hpp:164-177)."""
    return jnp.max(jnp.abs(v))


def infty_mat_norm(A):
    """max row sum of |A|  (kernels.hpp:179-192), for any device format."""
    from ..device_matrix import DeviceDIA, DeviceELL
    if isinstance(A, (DeviceDIA, DeviceELL)):
        return jnp.max(jnp.sum(jnp.abs(A.data), axis=0 if
                               isinstance(A, DeviceDIA) else 1))
    from .lane_ell import DeviceLaneELL
    if isinstance(A, DeviceLaneELL):
        return jnp.max(jnp.sum(jnp.abs(A.vals), axis=0))
    from ..stencil_op import DeviceStencil, stencil_spmv
    if isinstance(A, DeviceStencil):
        # |A| row sums = |A| applied to ones; coefficients sign-folded
        import dataclasses
        A_abs = dataclasses.replace(
            A, coeffs=jnp.abs(A.coeffs),
            diag=None if A.diag is None else jnp.abs(A.diag))
        ones = jnp.ones(A.n_rows, dtype=A.dtype)
        if A.planar:
            from ..stencil_op import to_planar_vec
            ones = to_planar_vec(A, ones)
        return jnp.max(stencil_spmv(A_abs, ones))
    raise TypeError(f"unsupported matrix type: {type(A)}")


def scale(v, scalar):
    """r = scalar * v  (kernels.hpp:214-220)."""
    return v * scalar
