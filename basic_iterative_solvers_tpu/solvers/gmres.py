"""Restarted, preconditioned GMRES(m).

Re-design of GMRESSolver (reference methods/gmres.hpp):

* Arnoldi with modified Gram-Schmidt (orthogonalize_V, gmres.hpp:6-53) — a
  j-deep chain of dot+axpy against the stored basis V ((m+1)×N array, row
  vectors like the reference, gmres.hpp:158-160);
* Givens least-squares maintained through an accumulated (m+1)² rotation
  matrix Q (least_squares, gmres.hpp:55-121).  The reference forms the
  updated Q with a dense J·Q product where J is identity plus one 2×2
  rotation block — algebraically that only rewrites rows j and j+1 of Q,
  which is how it's computed here;
* implicit residual ‖r‖ = |g[j+1]| with g = Q·(βe₁) (update_g,
  gmres.hpp:123-148);
* explicit solution recovery y = R⁻¹g (R = Q·H), x = x₀ + Σ y_k V_k
  (get_explicit_x, gmres.hpp:326-375);
* restart every m iterations when unconverged: recover x, recompute and
  re-precondition the residual, reset all Krylov state
  (check_restart, gmres.hpp:388-415).  Restarts count against max_iters
  (solver.hpp:180) and append the post-restart preconditioned norm to the
  residual history (gmres.hpp:312-315).

State is a fixed-shape pytree (V, H, Q, g padded to the restart length), so
the whole method — restarts included — runs under jit.

Every contraction passes precision=HIGHEST: on GPUs an f32 matmul may
otherwise run in TF32, which keeps ~3 decimal digits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.blas1 import dot, euclidean_vec_norm, subtract_vectors
from ..ops.spmv import spmv
from ..precond import apply_preconditioner
from .base import SolverSetup
from .fused import fused_solve

_HIGHEST = jax.lax.Precision.HIGHEST


class GMRESMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        self.m = setup.config.restart_length
        self.orthog = setup.config.orthog_mode
        if self.orthog not in ("mgs", "cgs2", "lowsync"):
            raise ValueError(f"unknown orthog_mode: {self.orthog} "
                             "(mgs | cgs2 | lowsync)")
        bd = setup.config.gmres_basis_dtype
        if bd is None:
            self.basis_dtype = None          # V in the solve dtype
        elif str(bd) in ("bfloat16", "bf16"):
            self.basis_dtype = jnp.bfloat16
        else:
            self.basis_dtype = jnp.dtype(bd)
        self._restart_jit = jax.jit(self._restart_state)
        self._explicit_x_jit = jax.jit(self.explicit_x)

    # -- state ---------------------------------------------------------------

    def _krylov_reset(self, x, r_prec, beta, dtype):
        # Solver vectors may be planar 2-D (rows, lanes); the BASIS is kept
        # FLAT (m+1, N) — the Givens/projection machinery is plain matmuls
        # there.
        m = self.m
        vdt = self.basis_dtype or dtype
        v0 = (r_prec / beta).astype(vdt).reshape(-1)
        V = jnp.zeros((m + 1,) + v0.shape, dtype=vdt).at[0].set(v0)
        H = jnp.zeros((m + 1, m), dtype=dtype)
        Q = jnp.eye(m + 1, dtype=dtype)
        g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
        # v_cur carries the CURRENT basis vector so the hot loop never
        # extracts a row from V; it holds exactly the stored (basis-dtype-
        # rounded) values, so the iteration is bit-identical to reading
        # V[j].
        state = {"x_old": x, "V": V, "H": H, "Q": Q, "g": g,
                 "beta": beta, "j": jnp.int32(0), "v_cur": v0}
        if self.orthog == "lowsync":
            # running Gram matrix G = V·Vᵀ of the computed basis (lowsync
            # CGS2's reorthogonalization correction operand)
            state["G"] = jnp.zeros((m + 1, m + 1), dtype=dtype).at[0, 0].set(
                1.0)
        return state

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        rn_unprec = euclidean_vec_norm(r)
        r_prec = apply_preconditioner(self.M, r)
        beta = euclidean_vec_norm(r_prec)
        state = self._krylov_reset(x, r_prec, beta, x.dtype)
        state["residual_norm"] = rn_unprec
        return state

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    # -- iteration -----------------------------------------------------------

    def iterate(self, state):
        m = self.m
        j = state["j"]
        V, H, Q, g, beta = (state["V"], state["H"], state["Q"], state["g"],
                            state["beta"])
        # w = M⁻¹ A v_j (gmres.hpp:168-176); the stored basis row is
        # upcast to the solve dtype for the operator apply
        vj = state["v_cur"]                  # flat (n,)
        w = spmv(self.A, vj.reshape(self.b.shape).astype(self.b.dtype))
        w = apply_preconditioner(self.M, w)
        sdtype = w.dtype                     # solve dtype (small quantities)
        w = w.reshape(vj.shape)              # basis math runs flat

        if self.orthog == "lowsync":
            # Low-synchronization CGS2 (Gram-corrected reorthogonalization,
            # one-reduce style): classical CGS2's second projection is
            # h2 = V·w1 = (I − G)·h1 with G = V·Vᵀ — an (m+1)² correction
            # needing NO second read of the basis.  G's column for the most
            # recent basis vector is computed EXACTLY inside the projection
            # pass as a two-column matmul Vb @ [w, v_j] (same HBM traffic as
            # the matvec; an analytic shortcut for the column is
            # unstable — cancellation amplifies its error by ‖w‖/h_{j+1,j}).
            # The basis is streamed TWICE per iteration (project+gram,
            # correct-and-write) instead of CGS2's four times; GMRES here is
            # basis-streaming-bound, so this halves the iteration cost at
            # CGS2-grade orthogonality (pinned by debug-check tests).
            G = state["G"]
            BUCKET = 8   # rows per switch branch
            n_buckets = -(-(self.m + 1) // BUCKET)
            mp1 = self.m + 1

            def project_branch(k):
                rows = min((k + 1) * BUCKET, mp1)

                def branch(V, w, vj):
                    Vb = jax.lax.slice_in_dim(V, 0, rows, axis=0)
                    # storage-dtype matmul, solve-dtype accumulation
                    rhs = jnp.stack([w.astype(V.dtype), vj], axis=-1)
                    P = jnp.matmul(Vb, rhs, preferred_element_type=sdtype,
                                   precision=_HIGHEST)
                    pad = jnp.zeros((mp1, 2), sdtype).at[:rows].set(P)
                    return pad[:, 0], pad[:, 1]

                return branch

            def correct_branch(k):
                rows = min((k + 1) * BUCKET, mp1)

                def branch(V, w, h):
                    Vb = jax.lax.slice_in_dim(V, 0, rows, axis=0)
                    corr = jnp.matmul(h[:rows].astype(V.dtype), Vb,
                                      preferred_element_type=sdtype,
                                      precision=_HIGHEST)
                    return w - corr

                return branch

            idx = jnp.minimum(j // BUCKET, n_buckets - 1)

            def orthog(V, w, vj, G):
                h1, gc = jax.lax.switch(
                    idx, [project_branch(k) for k in range(n_buckets)],
                    V, w, vj)
                G = G.at[:, j].set(gc).at[j, :].set(gc)  # exact V·v_j column
                h2 = h1 - jnp.matmul(G, h1, precision=_HIGHEST)
                # = V·(w − h1ᵀV), G-corrected
                h = h1 + h2
                w = jax.lax.switch(
                    idx, [correct_branch(k) for k in range(n_buckets)],
                    V, w, h)
                return w, h, G

            from ..utils.ktimers import ktime
            w, h, G = ktime("orthog", orthog, V, w, vj, G)
            H = H.at[:, j].set(h)
        elif self.orthog == "cgs2":
            # Classical Gram-Schmidt with re-orthogonalization: two matvec
            # pairs replace the j-deep dependent MGS chain (CGS2
            # has MGS-equivalent stability).  The basis is streamed in
            # j-adaptive row buckets via lax.switch — static slice shapes
            # per branch, so HBM traffic tracks the active basis size
            # instead of the full (m+1)-row array.
            BUCKET = 8
            n_buckets = -(-(self.m + 1) // BUCKET)
            mp1 = self.m + 1

            def make_branch(k):
                rows = min((k + 1) * BUCKET, mp1)

                def proj(Vb, v):       # (rows,) = Vb · v
                    return jnp.matmul(Vb, v, preferred_element_type=sdtype,
                                      precision=_HIGHEST)

                def expand(h, Vb):     # vector = hᵀ · Vb
                    return jnp.matmul(h, Vb, preferred_element_type=sdtype,
                                      precision=_HIGHEST)

                def branch(V, w):
                    # unconditional re-orthogonalization: a DGKS-style
                    # selective scheme was measured SLOWER here (the
                    # criterion's norm reductions serialize the pipeline)
                    Vb = jax.lax.slice_in_dim(V, 0, rows, axis=0)
                    h1 = proj(Vb, w.astype(V.dtype))
                    w1 = w - expand(h1.astype(V.dtype), Vb)
                    h2 = proj(Vb, w1.astype(V.dtype))
                    w2 = w1 - expand(h2.astype(V.dtype), Vb)
                    h = jnp.zeros((mp1,), sdtype).at[:rows].set(h1 + h2)
                    return w2, h

                return branch

            # active rows = j+1 ≤ (k+1)·BUCKET for k = j // BUCKET
            idx = jnp.minimum(j // BUCKET, n_buckets - 1)
            from ..utils.ktimers import ktime
            w, h = ktime("orthog", lambda V, w: jax.lax.switch(
                idx, [make_branch(k) for k in range(n_buckets)], V, w), V, w)
            H = H.at[:, j].set(h)
        else:
            # Modified Gram-Schmidt against v_0..v_j (gmres.hpp:6-30)
            def mgs_body(i, carry):
                w, H = carry
                vi = jnp.take(V, i, axis=0).astype(w.dtype)
                h = dot(w, vi)
                H = H.at[i, j].set(h)
                return w - h * vi, H

            from ..utils.ktimers import ktime
            w, H = ktime("orthog", lambda w, H: jax.lax.fori_loop(
                0, j + 1, mgs_body, (w, H)), w, H)
        h_next = euclidean_vec_norm(w)        # H[j+1, j] (gmres.hpp:36-38)
        H = H.at[j + 1, j].set(h_next)
        # Happy breakdown (h_next == 0): the next basis vector is
        # undefined; store a zero row instead of w/0 = NaN so
        # explicit_x's full-basis contraction stays finite (the residual
        # is 0, so the solve stops before the row is ever used as a
        # direction).
        v_next = jnp.where(h_next > 0,
                           w / jnp.where(h_next > 0, h_next, 1.0), 0.0)
        v_next = v_next.astype(V.dtype)
        V = V.at[j + 1].set(v_next)               # gmres.hpp:43-46

        extra = {}
        if self.orthog == "lowsync":
            extra["G"] = G   # v_{j+1}'s exact column lands next iteration

        # Givens least squares (gmres.hpp:55-121): rotate column j of H by the
        # accumulated Q, derive the new rotation, fold it into Q.
        def least_squares(Q, H):
            h_col = jnp.matmul(Q, jnp.take(H, j, axis=1),
                               precision=_HIGHEST)     # (m+1,)
            hjj = jnp.take(h_col, j)
            hj1j = jnp.take(h_col, j + 1)
            denom = jnp.sqrt(hjj * hjj + hj1j * hj1j)
            c = hjj / denom
            s = hj1j / denom
            Qj = jnp.take(Q, j, axis=0)
            Qj1 = jnp.take(Q, j + 1, axis=0)
            Q = Q.at[j].set(c * Qj + s * Qj1)
            return Q.at[j + 1].set(-s * Qj + c * Qj1)

        from ..utils.ktimers import ktime
        Q = ktime("least_sq", least_squares, Q, H)

        # g = Q (β e₁); implicit ‖r‖ = |g[j+1]| (update_g, gmres.hpp:123-148)
        def update_g(Q, beta):
            g = beta * Q[:, 0]
            return g, jnp.abs(jnp.take(g, j + 1))

        g, rn = ktime("update_g", update_g, Q, beta)

        return dict(state, V=V, H=H, Q=Q, g=g, j=j + 1, residual_norm=rn,
                    v_cur=v_next, **extra)

    def sample_norm(self, state):
        return state["residual_norm"]

    # -- solution recovery & restart ------------------------------------------

    def explicit_x(self, state):
        """y = R⁻¹ g over the first j rows, x = x_old + Σ y_k V_k
        (get_explicit_x, gmres.hpp:326-375)."""
        m = self.m
        n_it = state["j"]
        Q, H, g, V = state["Q"], state["H"], state["g"], state["V"]
        R = jnp.matmul(Q, H, precision=_HIGHEST)    # (m+1, m) (gmres.hpp:114-116)
        cols = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)

        def back_body(k, y):
            row = n_it - 1 - k
            rowc = jnp.maximum(row, 0)
            Rrow = jnp.take(R, rowc, axis=0)[:m]
            ssum = jnp.dot(jnp.where(cols > rowc, Rrow, 0.0), y,
                           precision=_HIGHEST)
            diag = jnp.take(Rrow, rowc)
            val = (jnp.take(g, rowc) - ssum) / diag
            return jnp.where(row >= 0, y.at[rowc].set(val), y)

        y = jax.lax.fori_loop(0, m, back_body,
                              jnp.zeros(m, dtype=g.dtype))
        # y entries at indices ≥ n_it are zero, so the full contraction equals
        # the reference's Σ_{k≤n_it} y_k V_k (gmres.hpp:358).
        dx = jnp.matmul(y.astype(V.dtype), V[:m],
                        preferred_element_type=y.dtype, precision=_HIGHEST)
        return state["x_old"] + dx.reshape(state["x_old"].shape)

    def _restart_state(self, state):
        """Reference restart: recover x, recompute + re-precondition residual,
        reset Krylov state (gmres.hpp:396-413 + init_residual 274-316)."""
        x = self.explicit_x(state)
        r = subtract_vectors(self.b, spmv(self.A, x))
        r_prec = apply_preconditioner(self.M, r)
        beta = euclidean_vec_norm(r_prec)
        new = self._krylov_reset(x, r_prec, beta, x.dtype)
        new["residual_norm"] = beta
        return new

    def check_restart(self, state, iter_count, residual_norm, stopping):
        """Host-mode restart hook (gmres.hpp:388-415)."""
        norm_conv = residual_norm < stopping
        over_max = iter_count > self.setup.config.max_iters
        cycle = (iter_count % self.m == 0) and iter_count != 0
        if not norm_conv and not over_max and cycle:
            state = self._restart_jit(state)
            return state, True, float(state["residual_norm"])
        return state, False, residual_norm

    def debug_check(self, state, iter_count):
        """SanityChecker analogs (reference common.hpp:428-530, run under
        IF_DEBUG_MODE at gmres.hpp:50,120): V-orthonormality of the current
        basis and upper-triangularity of R = Q·H."""
        import numpy as np
        j = int(state["j"])
        # rows 0..j-1 are the established basis; row j was just produced as
        # w/H[j+1,j] and is numerically meaningless at (happy) breakdown.
        V = np.asarray(state["V"])[:j].reshape(j, -1)
        if V.shape[0] == 0:
            return
        # Tolerance scales with the state dtype: a fixed fp64-calibrated
        # bound fires spuriously under float32 (V-orthonormality error is
        # already ~2e-7 at j=1).  MGS drift grows like eps·κ(A), so leave
        # headroom above eps·j — the check is for gross (O(1)) loss.
        tol = 1e4 * np.finfo(V.dtype).eps * max(1, j)
        G = V @ V.T
        err = np.max(np.abs(G - np.eye(V.shape[0])))
        if err > tol:
            raise AssertionError(
                f"GMRES V lost orthonormality at iter {iter_count}: "
                f"max |VVᵀ - I| = {err:.3e} (tol {tol:.3e})")
        R = np.asarray(state["Q"]) @ np.asarray(state["H"])
        below = np.tril(R[:, :j], k=-1)[:j]
        if np.max(np.abs(below)) > tol * max(1.0, np.max(np.abs(R))):
            raise AssertionError(
                f"GMRES R = Q·H not upper-triangular at iter {iter_count}")

    def final_x(self, state):
        return self._explicit_x_jit(state)

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x,
                           restart_state_fn=self._restart_state,
                           cycle_len=self.m, cache_on=self)
