"""Preconditioned Conjugate Gradient.

Re-design of ConjugateGradientSolver (/root/reference/methods/cg.hpp).
Recurrence (cg_separate_iteration, cg.hpp:6-54):

    t      = A·p
    ρ      = (r, z)
    α      = ρ / (t, p)
    x'     = x + α·p
    r'     = r − α·t
    z'     = M⁻¹·r'
    β      = (r', z') / ρ
    p'     = z' + β·p

Initialization (cg.hpp:100-120): r₀ = b − A·x₀, z₀ = M⁻¹r₀, p₀ = z₀,
recorded norm = ||r₀||₂ (unpreconditioned).  The sampled residual is the
recurrence r' (cg.hpp:162-166), so sampling costs nothing extra.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.blas1 import dot, euclidean_vec_norm, subtract_vectors, sum_vectors
from ..ops.spmv import spmv, spmv_dot
from ..precond import apply_preconditioner
from .base import SolverSetup
from .fused import fused_solve


class ConjugateGradientMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        # With the identity preconditioner z IS r; carrying both as state
        # aliases forces XLA to insert a defensive full-vector copy per
        # while-loop iteration.  The
        # specialization drops z and reads ρ = (r, r) off the carried norm.
        from ..types import PrecondType
        self._identity_M = self.M.ptype == PrecondType.NONE
        # tolerance=0 benchmark guard (SolverConfig.breakdown_stall)
        self._stall = setup.config.breakdown_stall

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        rn = euclidean_vec_norm(r)
        if self._identity_M:
            return {"x": x, "r": r, "p": r, "residual_norm": rn}
        z = apply_preconditioner(self.M, r)
        return {"x": x, "r": r, "z": z, "p": z, "residual_norm": rn}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state):
        if self._identity_M:
            x, r, p = state["x"], state["r"], state["p"]
            rn = state["residual_norm"]
            t, tp = spmv_dot(self.A, p)
            rz = rn * rn                      # ρ = (r, r) = ||r||²
            alpha = rz / tp
            x = sum_vectors(x, p, alpha)
            r_new = subtract_vectors(r, t, alpha)
            rn_new = euclidean_vec_norm(r_new)
            beta = (rn_new * rn_new) / rz
            p_new = sum_vectors(r_new, p, beta)
            return {"x": x, "r": r_new, "p": p_new,
                    "residual_norm": rn_new}
        x, r, z, p = state["x"], state["r"], state["z"], state["p"]
        t, tp = spmv_dot(self.A, p)
        rz = dot(r, z)
        alpha = rz / tp
        if self._stall:
            alpha = self._finite_or_zero(alpha)
        x = sum_vectors(x, p, alpha)
        r_new = subtract_vectors(r, t, alpha)
        z_new = apply_preconditioner(self.M, r_new)
        beta = dot(r_new, z_new) / rz
        if self._stall:
            beta = self._finite_or_zero(beta)
        p_new = sum_vectors(z_new, p, beta)
        return {"x": x, "r": r_new, "z": z_new, "p": p_new,
                "residual_norm": euclidean_vec_norm(r_new)}

    @staticmethod
    def _finite_or_zero(s):
        import jax.numpy as jnp
        return jnp.where(jnp.isfinite(s), s, jnp.zeros_like(s))

    def sample_norm(self, state):
        return state["residual_norm"]

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x, cache_on=self)


class PipelinedCGMethod:
    """Ghysels–Vanroose pipelined PCG (config.cg_flavor="pipelined").

    Algebraically the same Krylov iteration as ConjugateGradientMethod
    (reference cg.hpp:6-54) re-expressed so the α/β reductions read vectors
    already available at the TOP of the iteration:

        γ = (r, u)    δ = (w, u)        [overlappable reduction point]
        m = M⁻¹·w ;  n = A·m
        β = γ/γ_old ;  α = γ / (δ − β·γ/α_old)
        z ← n + β·z ;  q ← m + β·q ;  s ← w + β·s ;  p ← u + β·p
        x ← x + α·p ;  r ← r − α·s ;  u ← u − α·q ;  w ← w − α·z

    with u = M⁻¹r and w = A·u maintained by recurrence.  Classic PCG's
    (t,p) reduction sits BETWEEN the SpMV and the vector updates — nothing
    overlaps it; here γ/δ depend on neither m nor n, so their fused psum
    runs concurrently with the iteration's M⁻¹/SpMV.  The end-of-iteration
    stopping-test norm ‖r'‖ remains, exactly as in classic (it feeds the
    while-loop predicate) — the win is removing the serialized
    mid-iteration sync, not all syncs.  The price is the s/q/z companion
    recurrences (~2 extra vector streams per iteration), so classic stays
    the single-chip default.

    First iteration: γ_old = ∞ makes β exactly 0 (finite/∞), reducing
    α to γ/δ — no special-casing inside the fused while_loop.

    Residual replacement: the extra recurrences drift, separating the
    recurrence residual from the TRUE residual — fatal at the reference's
    tol = 1e-14 (and, in f32, within ~20 iterations).  When triggered,
    the vectors are recomputed from x and p directly (r = b − A·x,
    u = M⁻¹r, w = A·u; s = A·p, q = M⁻¹s, z = A·q — Cools & Vanroose's
    standard fix).  The PRIMARY trigger is the Sleijpen/van der Vorst
    flying restart: replace when the recurrence norm drops below
    cg_rr_theta × (max norm since the last replacement) — the rounding
    drift is bounded by that max, so this fires exactly when the two
    residuals are about to separate, a handful of times per solve.  A
    fixed period alone (cg_rr_period, kept as a backstop for stagnation
    plateaus) measurably fires too late: in f32 the drift poisons p
    before iteration 25 and the replaced solve then oscillates forever.
    cg_rr_period = 0 disables replacement entirely.
    """

    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        self.rr_period = int(setup.config.cg_rr_period)
        self.rr_theta = float(getattr(setup.config, "cg_rr_theta", 1e-2))
        from ..types import PrecondType
        # With identity M: u ≡ r and the q/s recurrences coincide — carry
        # only x, r, w, p, s, z (γ = ‖r‖² comes off the carried norm).
        self._identity_M = self.M.ptype == PrecondType.NONE

    def _scalars(self, dtype):
        inf = jnp.asarray(jnp.inf, dtype=dtype)
        one = jnp.asarray(1.0, dtype=dtype)
        return inf, one

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        rn = euclidean_vec_norm(r)
        inf, one = self._scalars(rn.dtype)
        k = jnp.asarray(0, jnp.int32)
        k0 = jnp.asarray(0, jnp.int32)
        if self._identity_M:
            w = spmv(self.A, r)
            zero = jnp.zeros_like(r)
            return {"x": x, "r": r, "w": w, "p": zero, "s": zero,
                    "z": zero, "gamma_old": inf, "alpha_old": one,
                    "k": k, "residual_norm": rn, "rn_max": rn, "k_rep": k0}
        u = apply_preconditioner(self.M, r)
        w = spmv(self.A, u)
        zero = jnp.zeros_like(r)
        return {"x": x, "r": r, "u": u, "w": w, "p": zero, "s": zero,
                "q": zero, "z": zero, "gamma_old": inf, "alpha_old": one,
                "k": k, "residual_norm": rn, "rn_max": rn, "k_rep": k0}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state):
        import jax

        if self._identity_M:
            x, r, w = state["x"], state["r"], state["w"]
            p, s, z = state["p"], state["s"], state["z"]
            rn = state["residual_norm"]
            gamma = rn * rn                      # (r, u) = ‖r‖², M = I
            delta = dot(w, r)
            n = spmv(self.A, w)  # m = w when M = I
            beta = gamma / state["gamma_old"]
            alpha = gamma / (delta - beta * gamma / state["alpha_old"])
            z = sum_vectors(n, z, beta)
            s = sum_vectors(w, s, beta)
            p = sum_vectors(r, p, beta)
            x = sum_vectors(x, p, alpha)
            r = subtract_vectors(r, s, alpha)
            w = subtract_vectors(w, z, alpha)
            k = state["k"] + jnp.int32(1)
            rn_new = euclidean_vec_norm(r)
            rn_max, k_rep = state["rn_max"], state["k_rep"]
            if self.rr_period:
                k_rep = k_rep + jnp.int32(1)
                trigger = ((rn_new < self.rr_theta * rn_max)
                           | (k_rep >= jnp.int32(self.rr_period)))

                def _rep(args):
                    r2 = subtract_vectors(
                        self.b, spmv(self.A, x))
                    w2 = spmv(self.A, r2)
                    s2 = spmv(self.A, p)
                    z2 = spmv(self.A, s2)
                    rn2 = euclidean_vec_norm(r2)
                    return r2, w2, s2, z2, rn2, rn2, jnp.int32(0)

                def _keep(args):
                    r_, w_, s_, z_, rn_, rm_, kr_ = args
                    return r_, w_, s_, z_, rn_, jnp.maximum(rm_, rn_), kr_

                r, w, s, z, rn_new, rn_max, k_rep = jax.lax.cond(
                    trigger, _rep, _keep,
                    (r, w, s, z, rn_new, rn_max, k_rep))
            return {"x": x, "r": r, "w": w, "p": p, "s": s, "z": z,
                    "gamma_old": gamma, "alpha_old": alpha, "k": k,
                    "residual_norm": rn_new, "rn_max": rn_max,
                    "k_rep": k_rep}
        x, r, u, w = state["x"], state["r"], state["u"], state["w"]
        p, s, q, z = state["p"], state["s"], state["q"], state["z"]
        gamma = dot(r, u)
        delta = dot(w, u)
        m = apply_preconditioner(self.M, w)
        n = spmv(self.A, m)
        beta = gamma / state["gamma_old"]
        alpha = gamma / (delta - beta * gamma / state["alpha_old"])
        z = sum_vectors(n, z, beta)
        q = sum_vectors(m, q, beta)
        s = sum_vectors(w, s, beta)
        p = sum_vectors(u, p, beta)
        x = sum_vectors(x, p, alpha)
        r = subtract_vectors(r, s, alpha)
        u = subtract_vectors(u, q, alpha)
        w = subtract_vectors(w, z, alpha)
        k = state["k"] + jnp.int32(1)
        rn_new = euclidean_vec_norm(r)
        rn_max, k_rep = state["rn_max"], state["k_rep"]
        if self.rr_period:
            k_rep = k_rep + jnp.int32(1)
            trigger = ((rn_new < self.rr_theta * rn_max)
                       | (k_rep >= jnp.int32(self.rr_period)))

            def _rep(args):
                r2 = subtract_vectors(
                    self.b, spmv(self.A, x))
                u2 = apply_preconditioner(self.M, r2)
                w2 = spmv(self.A, u2)
                s2 = spmv(self.A, p)
                q2 = apply_preconditioner(self.M, s2)
                z2 = spmv(self.A, q2)
                rn2 = euclidean_vec_norm(r2)
                return r2, u2, w2, s2, q2, z2, rn2, rn2, jnp.int32(0)

            def _keep(args):
                r_, u_, w_, s_, q_, z_, rn_, rm_, kr_ = args
                return (r_, u_, w_, s_, q_, z_, rn_,
                        jnp.maximum(rm_, rn_), kr_)

            r, u, w, s, q, z, rn_new, rn_max, k_rep = jax.lax.cond(
                trigger, _rep, _keep,
                (r, u, w, s, q, z, rn_new, rn_max, k_rep))
        return {"x": x, "r": r, "u": u, "w": w, "p": p, "s": s, "q": q,
                "z": z, "gamma_old": gamma, "alpha_old": alpha, "k": k,
                "residual_norm": rn_new, "rn_max": rn_max, "k_rep": k_rep}

    def sample_norm(self, state):
        return state["residual_norm"]

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x, cache_on=self)
