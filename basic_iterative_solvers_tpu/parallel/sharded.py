"""Multi-device scale-out: row-partitioned solves over a 1-D device mesh.

The reference is a single-process OpenMP program — its only "DP" is a
row-parallel for loop (SURVEY.md §2.6).  The scale-out axis here is the
same one (matrix rows), realized as:

* the DIA diagonal data sharded along rows: `P(None, "rows")`;
* all solver vectors sharded `P("rows")`;
* SpMV's off-shard x entries fetched by a **halo exchange** — each shard
  sends its boundary slabs to its mesh neighbors with `lax.ppermute`,
  then runs the same gather-free shifted-slice SpMV locally;
* dot products / norms as local partials + `lax.psum`.

Requirement: the halo widths (max negative / positive diagonal offset) must
not exceed the local shard length — satisfied by any banded/stencil matrix
that is large enough to be worth sharding.

Preconditioners supported in sharded mode: none, Jacobi (elementwise), the
two-stage Richardson family (pure SpMV chains; same halo exchange), and the
EXACT multicolor GS family (coloring.py): a colored sweep is #colors
(SpMV + masked elementwise update) steps, so it shards exactly like SpMV —
unlike natural-order triangular sweeps, which are cross-shard sequential
(the reference's only parallel options are the same two, via SMAX coloring
or two_stage_gauss_seidel, kernels.hpp:312-333).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device_matrix import DeviceDIA

AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_dia(A: DeviceDIA, mesh: Mesh, axis: str = AXIS) -> DeviceDIA:
    """Place the DIA data row-sharded on the mesh."""
    npad = A.data.shape[1]
    n_dev = mesh.devices.size
    if npad % n_dev:
        raise ValueError(f"padded rows {npad} not divisible by {n_dev} devices")
    local = npad // n_dev
    hneg = max(0, -min(A.offsets)) if A.offsets else 0
    hpos = max(0, max(A.offsets)) if A.offsets else 0
    if hneg > local or hpos > local:
        raise ValueError(
            f"halo ({hneg},{hpos}) exceeds local shard length {local}; "
            "use fewer devices or a larger matrix")
    data = jax.device_put(A.data, NamedSharding(mesh, P(None, axis)))
    return DeviceDIA(data=data, offsets=A.offsets, n_rows=A.n_rows,
                     n_cols=A.n_cols, row_tile=A.row_tile)


def shard_vector(v: jax.Array, npad: int, mesh: Mesh, axis: str = AXIS):
    """Zero-pad a length-n vector to the padded row count and shard it."""
    n = v.shape[0]
    vp = jnp.zeros(npad, dtype=v.dtype).at[:n].set(v)
    return jax.device_put(vp, NamedSharding(mesh, P(axis)))


def _halo_exchange(x_local: jax.Array, hneg: int, hpos: int, axis: str):
    """Pull the left/right halo slabs from mesh neighbors.

    Open-boundary semantics: edge shards receive zeros (ppermute drops
    unmatched sources), matching the zero-padding of the single-chip path.
    """
    n_dev = jax.lax.axis_size(axis)
    parts = []
    if hneg > 0:
        # my left halo = left neighbor's last hneg entries → send right
        left = jax.lax.ppermute(
            x_local[-hneg:], axis,
            perm=[(i, i + 1) for i in range(n_dev - 1)])
        parts.append(left)
    parts.append(x_local)
    if hpos > 0:
        right = jax.lax.ppermute(
            x_local[:hpos], axis,
            perm=[(i + 1, i) for i in range(n_dev - 1)])
        parts.append(right)
    return jnp.concatenate(parts) if len(parts) > 1 else x_local


def sharded_spmv_dia(A_data_local: jax.Array, offsets: Tuple[int, ...],
                     x_local: jax.Array, axis: str = AXIS) -> jax.Array:
    """Local block of y = A @ x inside shard_map: halo-exchange then the
    same static shifted-slice accumulation as the single-chip kernel."""
    local = x_local.shape[0]
    hneg = max(0, -min(offsets)) if offsets else 0
    hpos = max(0, max(offsets)) if offsets else 0
    xp = _halo_exchange(x_local, hneg, hpos, axis)
    y = jnp.zeros(local, dtype=x_local.dtype)
    for d, off in enumerate(offsets):
        start = hneg + off
        y = y + A_data_local[d] * jax.lax.slice(xp, (start,), (start + local,))
    return y


def _pdot(a, b, axis):
    return jax.lax.psum(jnp.dot(a, b), axis)


def sharded_two_stage(T_data_local, offsets: Tuple[int, ...],
                      D_inv_local: jax.Array, y_local: jax.Array,
                      inner_iters: int, axis: str = AXIS) -> jax.Array:
    """Jacobi-Richardson triangular-solve approximation inside shard_map
    (reference two_stage_gauss_seidel, kernels.hpp:312-333): pure SpMV
    chains, so each inner sweep is one halo exchange + local work."""
    work = D_inv_local * y_local
    out = work
    for _ in range(inner_iters):
        work = -D_inv_local * sharded_spmv_dia(T_data_local, offsets, work,
                                               axis)
        out = out + work
    return out


@dataclasses.dataclass
class ShardedCG:
    """Distributed PCG: same recurrence as solvers/cg.py (reference
    cg.hpp:6-54), with psum dots and halo-exchanged SpMV.

    Preconditioners: None = identity; D_inv alone = Jacobi; adding
    L_strict/U_strict = the symmetric two-stage (Richardson) form — each
    inner sweep is one more halo exchange, the reference's own
    parallel-friendly SpTRSV substitute (kernels.hpp:312-333)."""

    mesh: Mesh
    A: DeviceDIA                 # sharded
    b: jax.Array                 # sharded, padded
    D_inv: Optional[jax.Array]   # sharded, padded (Jacobi M⁻¹); None = identity
    npad: int
    axis: str = AXIS
    L_strict: Optional[DeviceDIA] = None    # sharded strict parts (s2st M⁻¹)
    U_strict: Optional[DeviceDIA] = None
    D: Optional[jax.Array] = None           # sharded diagonal (s2st)
    inner_iters: int = 1

    def _apply_M(self, y, dinv, lsd, usd, dloc):
        """z = M⁻¹ y on local shards (inside shard_map)."""
        if lsd is not None:
            z = sharded_two_stage(lsd, self.L_strict.offsets, dinv, y,
                                  self.inner_iters, self.axis)
            z = z * dloc
            return sharded_two_stage(usd, self.U_strict.offsets, dinv, z,
                                     self.inner_iters, self.axis)
        if dinv is not None:
            return y * dinv
        return y

    def _mat_specs_args(self):
        """(in_specs tail, args tail) for the optional preconditioner
        operands: D_inv, L_strict data, U_strict data, D."""
        spec_v = P(self.axis)
        specs = (spec_v if self.D_inv is not None else None,
                 P(None, self.axis) if self.L_strict is not None else None,
                 P(None, self.axis) if self.U_strict is not None else None,
                 spec_v if self.D is not None else None)
        args = (self.D_inv,
                self.L_strict.data if self.L_strict is not None else None,
                self.U_strict.data if self.U_strict is not None else None,
                self.D)
        return specs, args

    def init_state(self, x0: jax.Array):
        offs = self.A.offsets
        axis = self.axis

        def init(data, dinv, lsd, usd, dloc, b, x):
            r = b - sharded_spmv_dia(data, offs, x, axis)
            z = self._apply_M(r, dinv, lsd, usd, dloc)
            rn = jnp.sqrt(_pdot(r, r, axis))
            return {"x": x, "r": r, "z": z, "p": z, "residual_norm": rn}

        spec_v = P(self.axis)
        m_specs, m_args = self._mat_specs_args()
        in_specs = (P(None, self.axis),) + m_specs + (spec_v, spec_v)
        out_specs = {"x": spec_v, "r": spec_v, "z": spec_v, "p": spec_v,
                     "residual_norm": P()}
        f = jax.shard_map(init, mesh=self.mesh, in_specs=in_specs,
                          out_specs=out_specs)
        return f(self.A.data, *m_args, self.b, x0)

    def step_fn(self):
        """One CG iteration as a jittable state→state function (shard_map)."""
        offs = self.A.offsets
        axis = self.axis

        def step(data, dinv, lsd, usd, dloc, state):
            x, r, z, p = state["x"], state["r"], state["z"], state["p"]
            t = sharded_spmv_dia(data, offs, p, axis)
            rz = _pdot(r, z, axis)
            alpha = rz / _pdot(t, p, axis)
            x = x + alpha * p
            r_new = r - alpha * t
            z_new = self._apply_M(r_new, dinv, lsd, usd, dloc)
            beta = _pdot(r_new, z_new, axis) / rz
            p_new = z_new + beta * p
            rn = jnp.sqrt(_pdot(r_new, r_new, axis))
            return {"x": x, "r": r_new, "z": z_new, "p": p_new,
                    "residual_norm": rn}

        spec_v = P(self.axis)
        state_spec = {"x": spec_v, "r": spec_v, "z": spec_v, "p": spec_v,
                      "residual_norm": P()}
        m_specs, m_args = self._mat_specs_args()
        in_specs = (P(None, self.axis),) + m_specs + (state_spec,)
        sharded = jax.shard_map(step, mesh=self.mesh, in_specs=in_specs,
                                out_specs=state_spec)
        return jax.jit(lambda s: sharded(self.A.data, *m_args, s))


def shard_setup(setup, mesh: Mesh, axis: str = AXIS):
    """Re-home a SolverSetup onto a device mesh: annotate shardings on the
    inputs and let XLA's SPMD partitioner (GSPMD) insert the collectives.
    Correct for every method/preconditioner."""
    import dataclasses as _dc

    from ..device_matrix import DeviceDIA as _DIA
    from ..ops.lane_ell import DeviceLaneELL as _LELL
    from ..stencil_op import DeviceStencil as _ST

    n_dev = mesh.devices.size
    A = setup.A
    # gate on the length of the vectors that will actually be sharded
    if isinstance(A, (_ST, _DIA, _LELL)):
        vec_len = setup.b.shape[0]
    else:
        raise ValueError(
            "shard_setup supports DIA, stencil and lane-ELL matrices")
    if vec_len % n_dev:
        raise ValueError(
            f"vector length {vec_len} not divisible by {n_dev} devices")

    mat_sh = NamedSharding(mesh, P(None, axis))
    vec_sh = NamedSharding(mesh, P(axis))
    rep_sh = NamedSharding(mesh, P())

    def place_mat(M):
        if M is None:
            return None
        if isinstance(M, _ST):
            # matrix-free: coefficients replicated, dense diagonal sharded;
            # the sharded path uses the XLA stencil apply (pure jnp ops), so
            # GSPMD partitions it like any elementwise+shift graph.
            return _dc.replace(
                M, coeffs=jax.device_put(M.coeffs, rep_sh),
                diag=(jax.device_put(M.diag, vec_sh)
                      if M.diag is not None else None))
        if isinstance(M, _LELL):
            # slot planes sharded along the x2-row axis when divisible
            # (else replicated); the sharded path runs the XLA flat-gather
            # SpMV, whose source vector GSPMD all-gathers — correct on any
            # pattern, bandwidth-optimal only for row-local ones.
            sh = (NamedSharding(mesh, P(None, axis, None))
                  if M.vals.shape[1] % n_dev == 0 else rep_sh)
            return _dc.replace(M, vals=jax.device_put(M.vals, sh),
                               idx=jax.device_put(M.idx, sh))
        return _DIA(data=jax.device_put(M.data, mat_sh), offsets=M.offsets,
                    n_rows=M.n_rows, n_cols=M.n_cols, row_tile=M.row_tile)

    def place_vec(v):
        # Solver vectors are flat (n,) or planar 2-D (rows, lanes); shard
        # the leading axis when evenly divisible, else keep replicated
        # (correct, just not distributed).
        if v is None:
            return None
        if v.shape[0] % n_dev == 0:
            if v.ndim == 2:
                return jax.device_put(
                    v, NamedSharding(mesh, P(axis, None)))
            return jax.device_put(v, vec_sh)
        return jax.device_put(v, NamedSharding(mesh, P()))

    def place_rep(tree):
        # blocked-trisolve pytrees: value planes replicated (their slot
        # axis is color-permuted — not the row partition); the solve then
        # runs replicated per device, which is correct
        # and costs one all-gather-free pass (preconditioner applies are
        # elementwise+shift chains, no cross-shard state)
        if tree is None:
            return None
        return jax.tree.map(lambda a: jax.device_put(a, rep_sh), tree)

    M = setup.M
    M_sh = _dc.replace(
        M,
        A_D=place_vec(M.A_D), A_D_inv=place_vec(M.A_D_inv),
        L_strict_dev=place_mat(M.L_strict_dev),
        U_strict_dev=place_mat(M.U_strict_dev),
        A_full_dev=place_mat(M.A_full_dev),
        L_block=place_rep(M.L_block), U_block=place_rep(M.U_block),
        color_arr=place_vec(M.color_arr))
    cfg = _dc.replace(setup.config)
    return _dc.replace(
        setup, config=cfg, A=place_mat(A), M=M_sh,
        b=place_vec(setup.b), x0=place_vec(setup.x0),
        A_D=place_vec(setup.A_D),
        color_arr=place_vec(setup.color_arr))


def make_sharded_cg(A: DeviceDIA, b: jax.Array, mesh: Mesh,
                    D_inv: Optional[jax.Array] = None,
                    two_stage: bool = False, inner_iters: int = 1,
                    axis: str = AXIS) -> ShardedCG:
    """two_stage=True builds the symmetric two-stage (Richardson)
    preconditioner from on-device L/U splits (dia.dia_split) — D_inv must
    be given; both strict parts are halo-exchanged like A."""
    from ..dia import dia_split
    npad = A.data.shape[1]
    A_sh = shard_dia(A, mesh, axis)
    b_sh = shard_vector(b, npad, mesh, axis)
    dinv_sh = (shard_vector(D_inv, npad, mesh, axis)
               if D_inv is not None else None)
    L_sh = U_sh = D_sh = None
    if two_stage:
        if D_inv is None:
            raise ValueError("two_stage needs D_inv")
        L, U, D, _ = dia_split(A)
        L_sh = shard_dia(L, mesh, axis)
        U_sh = shard_dia(U, mesh, axis)
        D_sh = jax.device_put(
            jnp.zeros(npad, dtype=D.dtype).at[:A.n_rows].set(D),
            NamedSharding(mesh, P(axis)))
    return ShardedCG(mesh=mesh, A=A_sh, b=b_sh, D_inv=dinv_sh, npad=npad,
                     axis=axis, L_strict=L_sh, U_strict=U_sh, D=D_sh,
                     inner_iters=inner_iters)
