"""Jacobi solver.

Re-design of JacobiSolver (/root/reference/methods/jacobi.hpp): the
"separate" iteration the reference actually runs (jacobi.hpp:43-52) —
full SpMV then a normalize step — expressed functionally:

    t = A·x
    x' = (b − (t − D·x)) / D        [normalize_x, jacobi.hpp:27-40]

Residual sampling recomputes ||b − A·x'|| explicitly with an extra SpMV,
exactly like the reference (jacobi.hpp:102-107).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.blas1 import euclidean_vec_norm, subtract_vectors
from ..ops.spmv import spmv
from .base import SolverSetup
from .fused import fused_solve


class JacobiMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        if setup.A_D is None:
            raise ValueError("Jacobi requires the matrix diagonal")
        self.setup = setup
        self.A = setup.A
        self.b = setup.b
        self.D = setup.A_D

    def init_state(self):
        x = self.setup.x0
        Ax = spmv(self.A, x)
        r = subtract_vectors(self.b, Ax)
        return {"x": x, "Ax": Ax,
                "residual_norm": euclidean_vec_norm(r)}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state):
        # One SpMV per iteration: A·x_new feeds BOTH the explicit residual
        # sample (jacobi.hpp:102-107 recomputes it) and the next update's
        # A·x_old — the reference pays two SpMVs for the same numbers.
        x, Ax = state["x"], state["Ax"]
        x_new = (self.b - (Ax - self.D * x)) / self.D
        Ax_new = spmv(self.A, x_new)
        return dict(state, x=x_new, Ax=Ax_new)

    def sample_norm(self, state):
        r = subtract_vectors(self.b, state["Ax"])
        return euclidean_vec_norm(r)

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x, cache_on=self)
