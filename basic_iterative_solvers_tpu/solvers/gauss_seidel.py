"""Gauss-Seidel and symmetric Gauss-Seidel solvers.

Re-design of GaussSeidelSolver / SymmetricGaussSeidelSolver
(/root/reference/methods/gauss_seidel.hpp:26-141):

    forward sweep:  t = U_strict·x;  x ← (L_strict + D)⁻¹ (b − t)
    backward sweep: t = L_strict·x;  x ← (U_strict + D)⁻¹ (b − t)

Two exact execution modes (SolverConfig.gs_mode):

* "levels"  — level-scheduled scans (ops/trisolve.py) in the natural
  ordering: the data-parallel replacement for the reference's serial sptrsv/bsptrsv
  (kernels.hpp:54-117), arithmetic-order-matched to the reference.
* "colored" — multicolor masked sweeps (coloring.py): exact GS for the
  color-sorted ordering, evaluated as #colors (SpMV + masked update) steps
  with the FULL operator — the data-parallel form of the reference's SMAX
  coloring modes (smax_helpers.hpp:25-28).  Works at any scale (the level
  count of a natural-order 3-D stencil sweep is n; colors are 2-8).

Residual sampling recomputes ||b − A·x|| explicitly
(gauss_seidel.hpp:99-104).
"""
from __future__ import annotations

from ..ops.blas1 import euclidean_vec_norm, subtract_vectors
from ..ops.spmv import spmv
from ..ops.trisolve import trisolve
from .base import SolverSetup
from .fused import fused_solve


class GaussSeidelMethod:
    supports_fused = True
    symmetric = False

    def __init__(self, setup: SolverSetup):
        self.blocked = setup.gs_L_block is not None
        self.colored = setup.n_colors > 0 and not self.blocked
        if self.colored:
            if setup.A_D is None:
                raise ValueError("colored Gauss-Seidel requires the diagonal")
            self.D_inv = 1.0 / setup.A_D
        elif not self.blocked and (setup.L_solve is None
                                   or setup.U_strict_dev is None):
            raise ValueError("Gauss-Seidel requires L/U solver data")
        self.setup = setup
        self.A = setup.A
        self.b = setup.b

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        if self.blocked:
            # the residual-form sweep consumes r and the next iterate
            # recomputes it anyway — carrying it halves the SpMV count
            # (sample_norm's explicit ||b − A·x|| re-evaluation was a
            # second full operator apply per iteration)
            return {"x": x, "r": r, "residual_norm": euclidean_vec_norm(r)}
        return {"x": x, "residual_norm": euclidean_vec_norm(r)}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def _sweep(self, x, reverse: bool):
        from ..coloring import colored_sweep
        s = self.setup
        return colored_sweep(self.A, self.D_inv, self.b, x, s.color_spec,
                             s.color_arr, s.n_colors, reverse=reverse)

    def iterate(self, state):
        x = state["x"]
        if self.blocked:
            # residual-form sweep through the const-mode blocked
            # trisolves (ops/block_trisolve.py): x ← x + M⁻¹(b − A x)
            # with M the exact GS/SGS operator of the colored ordering —
            # identical math to the masked sweeps, zero factor traffic.
            # r is CARRIED (explicit b − A·x of the current iterate): the
            # sweep consumes it and the post-update recompute feeds both
            # the next sweep and the sampled norm — ONE operator apply
            # per iteration where sweep + explicit sampling used two.
            from ..ops.block_trisolve import blocked_sgs, blocked_trisolve
            r = state["r"]
            if self.symmetric:
                dx = blocked_sgs(self.setup.gs_L_block,
                                 self.setup.gs_U_block, r)
            else:
                dx = blocked_trisolve(self.setup.gs_L_block, r)
            x = x + dx
            r_new = subtract_vectors(self.b,
                                     spmv(self.A, x))
            return {"x": x, "r": r_new,
                    "residual_norm": euclidean_vec_norm(r_new)}
        if self.colored:
            # exact GS in the colored ordering, residual form (coloring.py)
            x = self._sweep(x, reverse=False)
            if self.symmetric:
                x = self._sweep(x, reverse=True)
            return dict(state, x=x)
        t = spmv(self.setup.U_strict_dev, x)
        x = trisolve(self.setup.L_solve, self.b - t)
        if self.symmetric:
            t = spmv(self.setup.L_strict_dev, x)
            x = trisolve(self.setup.U_solve, self.b - t)
        return dict(state, x=x)

    def sample_norm(self, state):
        if self.blocked:
            # already the explicit ||b − A·x|| of the carried residual
            return state["residual_norm"]
        r = subtract_vectors(self.b, spmv(self.A, state["x"]))
        return euclidean_vec_norm(r)

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x, cache_on=self)


class SymmetricGaussSeidelMethod(GaussSeidelMethod):
    """Forward + backward sweep per iteration (gauss_seidel.hpp:126-129)."""

    symmetric = True

    def __init__(self, setup: SolverSetup):
        super().__init__(setup)
        if not self.colored and not self.blocked and (
                setup.U_solve is None or setup.L_strict_dev is None):
            raise ValueError("Symmetric GS requires backward-solve data")
