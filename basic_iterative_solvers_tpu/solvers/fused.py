"""Fully-fused device-side solve loop — the performance mode.

The reference's harness is a host do-while around per-iteration kernel
launches (solver_harness.hpp:15-51).  On an accelerator, host round-trips
per iteration leave the device idle; this driver runs the *entire* solve as one
``lax.while_loop`` under jit: stopping criterion, divergence check,
residual-history recording and (for GMRES) restarts all happen on device.
Semantics match the host harness: sample every `res_check_len` iterations,
stop on ``||r|| < tol*||r0||`` / max_iters / NaN (solver.hpp:166-191).

`FusedRunner` compiles once per method instance; repeated `.run()` calls
reuse the executable (important: each run is a single device dispatch).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .base import SolveResult, SolverSetup


def _lift_consts(fn, *example):
    """jit(fn) with every closure-captured array passed as a runtime
    argument instead of an embedded module literal.

    jax.jit bakes concrete captured arrays into the lowered HLO as
    constants, so multi-hundred-MB operands (matrix data, preconditioner
    factors, b/x0 at 10⁸ rows) would be serialized into the compiled
    module and the compile cache entry.  Tracing
    to a jaxpr and evaluating it under jit with `closed.consts` as leading
    arguments keeps the compiled module literal-free; XLA still sees the
    same program."""
    flat_ex, in_tree = jax.tree.flatten(example)
    out_store = []

    def flat_fn(*flat):
        out = fn(*jax.tree.unflatten(in_tree, flat))
        flat_out, out_tree = jax.tree.flatten(out)
        out_store.append(out_tree)
        return flat_out

    closed = jax.make_jaxpr(flat_fn)(*flat_ex)   # the ONE trace
    out_tree = out_store[0]
    import jax.core as _core

    @jax.jit
    def call(consts, flat_args):
        out_flat = _core.eval_jaxpr(closed.jaxpr, consts, *flat_args)
        return jax.tree.unflatten(out_tree, out_flat)

    consts = list(closed.consts)

    def runner(*args):
        flat, _ = jax.tree.flatten(args)
        return call(consts, flat)

    def swap_consts(old, new) -> int:
        """Replace every closed-over const that IS `old` (object identity)
        with `new`.  The jit cache keys on abstract values, so a same-
        shape/dtype swap re-dispatches the EXISTING executable with the new
        operand — no re-trace, no re-lower, no re-compile (the refinement
        driver uses this to change the inner right-hand side per outer).
        Returns the number of replacements (0 = `old` was not captured
        by identity; caller must rebuild)."""
        hits = 0
        for i, c in enumerate(consts):
            if c is old:
                if (tuple(new.shape) != tuple(c.shape)
                        or new.dtype != c.dtype):
                    raise ValueError(
                        f"swap_consts shape/dtype mismatch: "
                        f"{c.shape}/{c.dtype} -> {new.shape}/{new.dtype}")
                consts[i] = new
                hits += 1
        return hits

    runner.swap_consts = swap_consts

    def lower(*args):
        """AOT-lower the lifted call with the CURRENT consts (their real
        shardings included) — the compiled text of the returned lowering
        is the production executable, which is what the structural
        multi-chip collective checks inspect (tests/test_gspmd.py)."""
        flat, _ = jax.tree.flatten(args)
        return call.lower(consts, flat)

    runner.lower = lower

    # let callers chain lifts without re-tracing (e.g. run's example state)
    runner.out_shape = jax.tree.unflatten(
        out_tree, [jax.ShapeDtypeStruct(a.shape, a.dtype)
                   for a in closed.out_avals])
    return runner


class FusedRunner:
    """Builds and caches the jitted init + while-loop executables.

    init_state() -> state dict with 'residual_norm' set to ||b - A x0||;
    iterate(state) -> state; sample_norm(state) -> device scalar.
    Restarted methods (GMRES) pass restart_state_fn(state) -> state (the
    full restart: explicit x, recomputed residual, Krylov reset) plus
    cycle_len = m; the runner then loops cycles of up to m iterations and
    applies the restart once per completed, unconverged cycle.
    """

    def __init__(self, setup: SolverSetup, init_state: Callable,
                 iterate: Callable, sample_norm: Callable,
                 final_x: Callable,
                 restart_state_fn: Optional[Callable] = None,
                 cycle_len: Optional[int] = None):
        self.setup = setup
        self.final_x = final_x
        config = setup.config
        max_iters = config.max_iters
        k = config.res_check_len
        # +1: index max_hist is a write-discard slot (see _record)
        max_hist = max_iters * 2 + 2

        def _record(norms_, idx, val, pred):
            """Unconditional scatter; writes land in the discard slot when
            `pred` is false — cheaper than a lax.cond per iteration."""
            return norms_.at[jnp.where(pred, idx, jnp.int32(max_hist))].set(
                val)

        def _sample(state, it, last, norms_, hist):
            # `last` = the most recently SAMPLED norm: the reference's
            # residual_norm member refreshes every res_check_len iterations
            # (sample_residual, solver.hpp:166-171) and the stopping check
            # reads that member — convergence gates on the sampled value.
            if k == 1:
                rn = sample_norm(state)
                return rn, norms_.at[hist].set(rn), hist + 1
            do = (it % k) == 0
            # keep the cond: sample_norm may be a full explicit residual
            rn = jax.lax.cond(do, sample_norm,
                              lambda s: s["residual_norm"], state)
            last = jnp.where(do, rn, last)
            return (last, _record(norms_, hist, rn, do),
                    hist + do.astype(jnp.int32))

        def _iter_body(carry):
            state, it, last, norms_, hist = carry
            state = iterate(state)
            it = it + 1
            last, norms_, hist = _sample(state, it, last, norms_, hist)
            return (state, it, last, norms_, hist)

        def run(state0):
            r0 = state0["residual_norm"]
            stopping = config.tolerance * r0
            norms = jnp.zeros(max_hist + 1, dtype=r0.dtype).at[0].set(r0)

            if restart_state_fn is None:
                def cond(carry):
                    state, it, last, norms_, hist = carry
                    return ((jnp.abs(last) >= stopping)
                            & (it < max_iters) & jnp.isfinite(last))

                state, it, last, norms, hist = jax.lax.while_loop(
                    cond, _iter_body,
                    (state0, jnp.int32(0), r0, norms, jnp.int32(1)))
                state = dict(state, residual_norm=last)
                return state, it, norms, hist, jnp.int32(0), stopping

            # Restarted methods (GMRES): CYCLE-structured loops — an outer
            # while over restart cycles, an inner while over the ≤ m
            # iterations of one cycle.  The restart branch (explicit x,
            # full residual, Krylov reset) then sits OUTSIDE the hot loop:
            # a per-iteration lax.cond costs ~0.2 ms AND blocks in-place
            # reuse of the basis (its operands get defensive copies).
            m = cycle_len

            def outer_cond(carry):
                state, it, last, norms_, hist, restarts = carry
                return ((jnp.abs(last) >= stopping)
                        & (it < max_iters - restarts) & jnp.isfinite(last))

            def outer_body(carry):
                state, it, last, norms_, hist, restarts = carry

                def inner_cond(c):
                    state, it, last, norms_, hist, j = c
                    return ((j < m) & (jnp.abs(last) >= stopping)
                            & (it < max_iters - restarts)
                            & jnp.isfinite(last))

                def inner_body(c):
                    state, it, last, norms_, hist, j = c
                    state, it, last, norms_, hist = _iter_body(
                        (state, it, last, norms_, hist))
                    return (state, it, last, norms_, hist, j + 1)

                state, it, last, norms_, hist, j = jax.lax.while_loop(
                    inner_cond, inner_body,
                    (state, it, last, norms_, hist, jnp.int32(0)))
                # reference restart condition (gmres.hpp:388-415): a full
                # cycle completed and the sampled norm has not converged
                do = ((j == m) & (jnp.abs(last) >= stopping)
                      & jnp.isfinite(last))
                state = jax.lax.cond(do, restart_state_fn,
                                     lambda s: s, state)
                restarts = restarts + do.astype(jnp.int32)
                last = jnp.where(do, state["residual_norm"], last)
                norms_ = _record(norms_, hist, state["residual_norm"], do)
                hist = hist + do.astype(jnp.int32)
                return (state, it, last, norms_, hist, restarts)

            carry = (state0, jnp.int32(0), r0, norms, jnp.int32(1),
                     jnp.int32(0))
            state, it, last, norms, hist, restarts = jax.lax.while_loop(
                outer_cond, outer_body, carry)
            state = dict(state, residual_norm=last)
            return state, it, norms, hist, restarts, stopping

        # Constant lifting: init_state/run close over the matrix,
        # preconditioner and b/x0 DEVICE arrays; a plain jit would embed
        # them as literal constants in the lowered module (large modules,
        # slow compiles).  _lift_consts traces once and re-runs the jaxpr
        # with its constants passed as runtime ARGUMENTS instead.
        self._init_jit = _lift_consts(init_state)
        self._run_jit = _lift_consts(run, self._init_jit.out_shape)

    def rebind_b(self, new_b) -> bool:
        """Point the compiled executables at a new right-hand side without
        re-tracing (same shape/dtype/layout as setup.b).  Returns False when
        the traced closures did not capture setup.b by identity (derived/
        cast arrays) — the caller must rebuild the method then."""
        import dataclasses as _dc
        old = self.setup.b
        hits = self._init_jit.swap_consts(old, new_b)
        hits += self._run_jit.swap_consts(old, new_b)
        if hits == 0:
            return False
        self.setup = _dc.replace(self.setup, b=new_b)
        return True

    def run_device(self):
        """Refinement inner-solve fast path: run the compiled init + loop
        and return (x_encoded, iters, restarts) with EVERYTHING still on
        device (x in solve encoding, counts as device scalars).  run()'s
        x*/f64-residual/finalize host materialization is not needed there:
        the refinement outer computes its own fp64 residual on device.  No block_until_ready: callers sync via the outer
        step's norm read, letting the dispatches pipeline."""
        state, it, _norms, _hist, restarts, _stop = self._run_jit(
            self._init_jit())
        return self.final_x(state), it, restarts

    def run(self) -> SolveResult:
        setup, config = self.setup, self.setup.config
        state0 = jax.block_until_ready(self._init_jit())
        t0 = time.perf_counter()
        state, it, norms, hist, restarts, stopping = jax.block_until_ready(
            self._run_jit(state0))
        solve_seconds = time.perf_counter() - t0

        it = int(it)
        hist = int(hist)
        restarts = int(restarts)
        norms = np.array(norms)[:hist + 1]
        residual_norm = float(state["residual_norm"])
        x_star = np.asarray(self.final_x(state))
        from .base import explicit_residual_norm, finalize_x
        final_norm = explicit_residual_norm(setup, x_star)
        x_star = finalize_x(setup, x_star)
        norms[hist] = final_norm
        times = np.full(hist + 1, solve_seconds / max(1, it))

        return SolveResult(
            uniform_iteration_times=True,
            x_star=x_star, iter_count=it,
            converged=bool(residual_norm < float(stopping)),
            stopping_criteria=float(stopping),
            residual_norms=norms, time_per_iteration=times,
            final_residual_norm=final_norm,
            gmres_restart_count=restarts,
            method=config.method, preconditioner=config.preconditioner,
            restart_length=config.restart_length,
            res_check_len=config.res_check_len, solve_seconds=solve_seconds)


def fused_solve(setup: SolverSetup, init_state: Callable, iterate: Callable,
                sample_norm: Callable, final_x: Callable,
                restart_state_fn: Optional[Callable] = None,
                cycle_len: Optional[int] = None,
                cache_on=None) -> SolveResult:
    """One-shot helper; pass `cache_on` (the method instance) to memoize the
    compiled runner across solve() calls."""
    if cache_on is not None:
        runner = getattr(cache_on, "_fused_runner", None)
        if runner is None:
            runner = FusedRunner(setup, init_state, iterate, sample_norm,
                                 final_x, restart_state_fn, cycle_len)
            cache_on._fused_runner = runner
        return runner.run()
    return FusedRunner(setup, init_state, iterate, sample_norm, final_x,
                       restart_state_fn, cycle_len).run()
