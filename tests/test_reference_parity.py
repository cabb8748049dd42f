"""Iteration parity against the reference implementation.

tests/goldens/reference_histories.json holds per-iteration residual-norm
histories produced by the actual reference binary (built by
scripts/gen_goldens.py from the reference sources, single-threaded, default
constants).  The reference solved its FDM-2d-16.mtx, which is exactly the
`fdm:16` generator's matrix, so those cases run from the generator.  The
reference's matrix_band_klein.mtx cases are not pinned: no generator here
rebuilds that file.  This framework, run with the same defaults in float64, must
reproduce them — the BASELINE.md north star "replicate residual-norm-per-
iteration histories within stated tolerance".

History layout: entry 0 is ||b - A x0||; entries 1..k are the per-iteration
sampled norms; the reference OVERWRITES its last entry with the explicit
final residual (save_x_star, solver.hpp:153-159) while we APPEND it — so
the comparable recurrence prefix is golden[:-1] vs ours[:len(golden)-1],
and the explicit finals are compared separately.

DELIBERATE ABSENCE — no ILU(0) parity case: the reference's active ILU(0)
path requires the external SMAX library and silently leaves the plain L/U
splits in place without it (reference utilities/LU_factors.hpp:
765-781), so no reference golden can be generated from this snapshot.
ILU(0) correctness here is pinned by the NumPy-oracle factorization tests
(tests/test_factor.py) and convergence tests instead.
"""
import json
import pathlib

import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.types import (PRECOND_CLI_NAMES,
                                               SOLVER_CLI_FLAGS)

GOLDENS = json.loads(
    (pathlib.Path(__file__).parent / "goldens" /
     "reference_histories.json").read_text())

#: (case, rtol for the recurrence prefix, prefix length limit or None,
#:  check_iteration_count)
CASES = [
    ("fdm16_j", 1e-9, 200, True),    # DNC: compare a stable prefix
    ("fdm16_gs", 1e-8, None, True),
    ("fdm16_sgs", 1e-8, None, True),
    ("fdm16_cg", 1e-5, None, True),
    ("fdm16_cg_j", 1e-5, None, True),
    ("fdm16_cg_sgs", 1e-5, None, True),
    ("fdm16_cg_2st", 1e-5, None, True),
    ("fdm16_cg_s2st", 1e-5, None, True),
    ("fdm16_bi", 1e-4, None, True),
    ("fdm16_bi_j", 1e-4, None, True),
    ("fdm16_bi_sgs", 1e-4, None, True),
    ("fdm16_bi_bgs", 1e-4, None, True),
    ("fdm16_gs_precond_cg", 1e-5, 100, True),      # DNC: stable prefix
    # PRECOND_OUTER_ITERS=2 reference build.  Only the Jacobi case is a
    # history-parity case: FDM's constant diagonal makes it insensitive to
    # the reference's outer-iters init defect (see
    # test_reference_outer_iters_init_quirk for the SGS case).
    ("fdm16_bi_j_outer2", 1e-4, None, True),
    # GMRES(50)'s implicit |g| plateaus at the f64 noise floor (~3e-13,
    # within ~2x of the stopping value) from iteration ~33, where both the
    # plateau level and the restart-vs-stop decision are float-noise
    # artifacts: pin the above-noise prefix only.
    ("fdm16_gm_j_rl50", 1e-4, 32, False),
    # GMRES(10): 19 restarts before convergence — the restart machinery
    # (explicit-x recovery, residual re-preconditioning, Krylov reset, and
    # restart entries appended to the history) matches the reference
    # entry-for-entry through the first 8 cycles (rounding divergence
    # compounds across later restarts); total iteration count still agrees.
    ("fdm16_gm_j_rl10", 1e-6, 90, True),
    ("fdm16_cg_j_scale", 1e-5, None, True),
    # Richardson (two-stage) with 2 inner sweeps, vs a reference rebuilt
    # with -DPRECOND_INNER_ITERS=2
    ("fdm16_cg_2st_inner2", 1e-7, 200, True),      # DNC: stable prefix
    ("fdm16_cg_s2st_inner2", 1e-5, None, True),
    ("fdm16_bi_s2st_inner2", 1e-4, None, True),
    # Anderson model: OUR generator produced the .mtx the reference solved
    # (its SCAMAC needs an external lib), so these pin generator + solver.
    # The disordered Hamiltonian is indefinite — every method DNCs in BOTH
    # implementations (agreeing divergence is parity too); trajectories are
    # chaotic once stalled, so pin the early history only.
    # (an SGS-preconditioned case is excluded: the triangular solves of
    # this indefinite matrix amplify by ~1e30, so both implementations
    # produce numerically meaningless, ulp-sensitive trajectories there)
    ("anderson_cg_j", 1e-3, 30, True),
    ("anderson_bi_j", 1e-3, 7, False),   # BiCGSTAB: ulp chaos doubles per iter on indefinite A
    ("anderson_gs", 1e-7, 40, False),
]


def _config_for(case):
    g = GOLDENS[case]
    opts = dict(method=SOLVER_CLI_FLAGS[g["method"]], dtype=np.float64,
                harness="fused",
                precond_inner_iters=g.get("precond_inner_iters", 0),
                precond_outer_iters=g.get("precond_outer_iters", 1))
    extra = list(g["extra"])
    while extra:
        k = extra.pop(0)
        if k == "-p":
            opts["preconditioner"] = PRECOND_CLI_NAMES[extra.pop(0)]
        elif k == "-rl":
            opts["restart_length"] = int(extra.pop(0))
        elif k == "-scale":
            opts["num_scale"] = bool(int(extra.pop(0)))
    return bis.SolverConfig(**opts)


@pytest.mark.parametrize("case,rtol,limit,check_iters", CASES)
def test_history_matches_reference(case, rtol, limit, check_iters):
    g = GOLDENS[case]
    A = bis.generators.from_source(g["matrix"])  # .mtx path or spec
    cfg = _config_for(case)
    x0 = None
    if cfg.num_scale:
        # Reference quirk: its solvers copy x_0 into their working vector
        # BEFORE preprocessing scales x_0 (preprocessing.hpp:30-49), so the
        # scaled x_0 never reaches the solve and the effective initial guess
        # stays 0.1.  We scale x0 properly; compensate to replicate.
        x0 = cfg.init_x_val * np.sqrt(np.abs(A.diagonal()))
    res = bis.solve(bis.preprocessing(A, cfg, x0=x0))

    assert res.converged == g["converged"], (
        f"{case}: converged={res.converged}, reference {g['converged']}")
    if check_iters:
        ref_iters = g["iterations"]
        our_iters = res.iter_count + res.gmres_restart_count
        assert abs(our_iters - ref_iters) <= 1, (
            f"{case}: {our_iters} iters vs reference {ref_iters}")

    golden = np.asarray(g["norms"][:-1])
    ours = np.asarray(res.residual_norms[:len(golden)])
    if limit is not None:
        golden, ours = golden[:limit], ours[:limit]
    np.testing.assert_allclose(ours, golden, rtol=rtol, atol=1e-13,
                               err_msg=f"{case}: history mismatch")
    # explicit final residual agrees with the convergence scale (GMRES's
    # implicit |g| can undershoot the explicit residual by a small factor
    # near the f64 noise floor — the reference shows the same gap)
    if g["converged"]:
        assert res.final_residual_norm < 10.0 * res.stopping_criteria


def test_reference_outer_iters_init_quirk():
    """Reference defect, documented: with PRECOND_OUTER_ITERS>1 its init call
    aliases input and output (`apply_preconditioner(..., residual, residual,
    ...)`, bicgstab.hpp:155-162), and the outer loop's final input-restore
    (kernels.hpp:407-409) then OVERWRITES the preconditioned result — the
    solve starts from an unpreconditioned r0hat/p0.  Simulating exactly that
    recurrence reproduces the golden to machine precision; our (correct)
    composed init converges strictly faster."""
    import numpy.linalg as la
    g = GOLDENS["fdm16_bi_sgs_outer2"]
    A = bis.generators.from_source(g["matrix"])
    dense = A.to_dense()
    D = np.diag(dense)
    n = A.n_rows

    def sgs2(v):  # true 2x composition (per-iteration applies are fine)
        for _ in range(2):
            t = la.solve(np.tril(dense), v)
            v = la.solve(np.triu(dense), t * D)
        return v

    b = np.ones(n)
    x = np.full(n, 0.1)
    r = b - dense @ x
    r0hat = r.copy()          # the defect: init preconditioning destroyed
    rho = r @ r
    y = sgs2(r0hat)
    v = dense @ y
    alpha = rho / (r0hat @ v)
    s = r - alpha * v
    t = dense @ sgs2(s)
    omega = (t @ s) / (t @ t)
    r1 = s - omega * t
    np.testing.assert_allclose(np.linalg.norm(r1), g["norms"][1], rtol=1e-12)

    # our init preconditions r0hat properly and converges faster
    cfg = _config_for("fdm16_bi_sgs_outer2")
    res = bis.solve(bis.preprocessing(A, cfg))
    assert res.converged and res.iter_count < g["iterations"]


def test_goldens_are_fresh():
    """The golden file must cover every case this test suite pins."""
    for case, _, _, _ in CASES:
        assert case in GOLDENS, f"missing golden {case}; re-run "
        "scripts/gen_goldens.py"
