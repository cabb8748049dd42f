"""Geometric multigrid preconditioner (mg.py; -p mg).

No reference analog (the reference's menu tops out at ILU(0),
/root/reference/kernels.hpp:336-414): tested against first principles —
transfer adjointness (R = P^T), Galerkin coarse operator vs a dense
P^T A P, SPD-ness of the V-cycle as an operator, and the headline
property: grid-size-independent CG iteration counts.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from basic_iterative_solvers_tpu import (PrecondType, SolverConfig,
                                         SolverType, preprocessing_device,
                                         solve, solve_system)
from basic_iterative_solvers_tpu.mg import (build_mg_hierarchy, coarse_dims,
                                            galerkin_coarse_coeffs, mg_vcycle,
                                            prolong_flat, restrict_flat)
from basic_iterative_solvers_tpu.precond import apply_preconditioner
from basic_iterative_solvers_tpu.stencil_op import (from_source_operator,
                                                    make_stencil)


# ---------------------------------------------------------------------------
# Transfers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transfer", ["linear", "injection"])
@pytest.mark.parametrize("fdims", [(9, 9, 9), (8, 10, 7), (16, 16, 1)])
def test_transfer_adjoint(rng, transfer, fdims):
    """<R v, u>_coarse == <v, P u>_fine: restriction is exactly the
    prolongation's transpose (required for an SPD V-cycle)."""
    cdims = coarse_dims(fdims)
    nf = int(np.prod(fdims))
    nc = int(np.prod(cdims))
    v = jnp.asarray(rng.standard_normal(nf))
    u = jnp.asarray(rng.standard_normal(nc))
    lhs = float(restrict_flat(v, fdims, cdims, transfer) @ u)
    rhs = float(v @ prolong_flat(u, fdims, cdims, transfer))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_prolong_injection_places_coarse_points():
    """Injection prolongation scatters u[c] to fine point 2c exactly."""
    fdims, cdims = (5, 5, 1), (3, 3, 1)
    u = jnp.arange(1.0, 10.0)
    f = np.asarray(prolong_flat(u, fdims, cdims, "injection")).reshape(5, 5)
    assert f[0, 0] == 1.0 and f[0, 2] == 2.0 and f[2, 2] == 5.0
    assert f[1, 1] == 0.0 and f[0, 1] == 0.0


def test_prolong_linear_interpolates_midpoints():
    """Linear prolongation gives exact trilinear interpolation between
    coarse points (midpoint = average of neighbors)."""
    fdims, cdims = (5, 1, 1), (3, 1, 1)
    u = jnp.asarray([1.0, 3.0, 7.0])
    f = np.asarray(prolong_flat(u, fdims, cdims, "linear"))
    np.testing.assert_allclose(f, [1.0, 2.0, 3.0, 5.0, 7.0], atol=1e-14)


# ---------------------------------------------------------------------------
# Galerkin coarse operator
# ---------------------------------------------------------------------------

def _dense_from_stencil(A_dev):
    n = A_dev.n_rows
    from basic_iterative_solvers_tpu.ops.spmv import spmv
    cols = [np.asarray(spmv(A_dev, jnp.eye(n, dtype=jnp.float64)[:, j])) for j in range(n)]
    return np.stack(cols, axis=1)


def test_galerkin_matches_dense_ptap():
    """galerkin_coarse_coeffs == the interior rows of a dense P^T A P."""
    fdims = (9, 9, 1)
    cdims = coarse_dims(fdims)
    legs = [((0, 0, 0), 4.0), ((1, 0, 0), -1.0), ((-1, 0, 0), -1.0),
            ((0, 1, 0), -1.0), ((0, -1, 0), -1.0)]
    A = make_stencil(legs, *fdims, dtype=jnp.float64)
    Ad = _dense_from_stencil(A)
    nf, nc = int(np.prod(fdims)), int(np.prod(cdims))
    P = np.stack([np.asarray(prolong_flat(jnp.eye(nc, dtype=jnp.float64)[:, j],
                                          fdims, cdims, "linear"))
                  for j in range(nc)], axis=1)
    ptap = P.T @ Ad @ P
    coeffs = dict((tuple(l), c) for l, c
                  in galerkin_coarse_coeffs(legs, fdims, "linear"))
    Ac = make_stencil(list(coeffs.items()), *cdims, dtype=jnp.float64)
    Acd = _dense_from_stencil(Ac)
    # interior coarse rows see the exact Galerkin operator; boundary rows
    # are the documented open-boundary compromise
    nxc, nyc, _ = cdims
    for j in range(1, nyc - 1):
        for i in range(1, nxc - 1):
            r = i + nxc * j
            np.testing.assert_allclose(Acd[r], ptap[r], atol=1e-10)


# ---------------------------------------------------------------------------
# The V-cycle as an operator: SPD (valid CG preconditioner)
# ---------------------------------------------------------------------------

def _mg_setup(source, **cfg_kw):
    config = SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                          preconditioner=PrecondType.MULTIGRID,
                          dtype=np.float64, matrix_format="stencil", **cfg_kw)
    A_dev = from_source_operator(source, dtype=jnp.float64)
    return preprocessing_device(A_dev, config)


@pytest.mark.parametrize("source,n", [("fdm:12", 144), ("hpcg:8x8x8", 512)])
@pytest.mark.parametrize("transfer,coarse_op", [("linear", "auto"),
                                                ("injection", "auto")])
@pytest.mark.slow
def test_vcycle_spd(source, n, transfer, coarse_op):
    """M^{-1} assembled column-by-column is symmetric and definite with the
    same sign as A (fdm's 2-D Laplacian is NEGATIVE definite — CG then runs
    on the equivalent negated pair, so M^{-1} must match A's sign; an
    INDEFINITE M^{-1} is the failure mode a Chebyshev-interval
    under-estimate produces, which is why lmax is a Gershgorin bound)."""
    setup = _mg_setup(source, mg_transfer=transfer,
                      mg_coarse_op=coarse_op, mg_levels=2)
    cols = [np.asarray(apply_preconditioner(
        setup.M, jnp.eye(n, dtype=jnp.float64)[:, j])) for j in range(n)]
    Minv = np.stack(cols, axis=1)
    asym = np.abs(Minv - Minv.T).max() / np.abs(Minv).max()
    assert asym < 1e-12, f"V-cycle not symmetric: rel asym {asym:.2e}"
    w = np.linalg.eigvalsh(0.5 * (Minv + Minv.T))
    sign = float(np.sign(np.asarray(setup.M.A_D)[0]))
    wlo, whi = (w * sign).min(), (w * sign).max()
    assert wlo > 0, (f"V-cycle indefinite vs A's sign {sign:+.0f}: "
                     f"eig range [{wlo:.2e}, {whi:.2e}]")


def test_vcycle_reduces_low_and_high_modes():
    """One V-cycle contracts the error uniformly (smoother kills the top of
    the spectrum, the coarse grid the bottom) — error after one
    preconditioned Richardson step shrinks for both mode types."""
    setup = _mg_setup("fdm:16", mg_levels=2)
    A_dev = setup.A
    n = 256
    x = np.arange(16)
    low = np.sin(np.pi * (x[None, :] + 1) / 17.0) * \
        np.sin(np.pi * (x[:, None] + 1) / 17.0)
    high = low * ((-1.0) ** (x[None, :] + x[:, None]))
    from basic_iterative_solvers_tpu.ops.spmv import spmv
    for e in (low.ravel(), high.ravel()):
        e = jnp.asarray(e / np.linalg.norm(e))
        r = spmv(A_dev, e)
        e_new = e - apply_preconditioner(setup.M, r)
        assert float(jnp.linalg.norm(e_new)) < 0.35


# ---------------------------------------------------------------------------
# End-to-end: grid-independent CG iteration counts
# ---------------------------------------------------------------------------

def _iters(source, precond, **kw):
    res = solve_system(source, "cg", precond, dtype=np.float64,
                       harness="host", tolerance=1e-10,
                       **kw)
    assert res.converged
    return res.iter_count


@pytest.mark.slow
def test_mg_cg_converges_and_beats_jacobi():
    """At 24^3 the condition-number gap is visible: Jacobi-CG iteration
    count grows ~ h^-1 while MG stays flat (~10)."""
    it_mg = _iters("hpcg:24x24x24", "mg")
    it_j = _iters("hpcg:24x24x24", "j")
    assert it_mg <= it_j / 3, (it_mg, it_j)


def test_mg_iterations_grid_independent():
    """The multigrid headline: iteration count stays ~constant as the grid
    refines (Jacobi's grows like h^-1 in CG)."""
    it_small = _iters("hpcg:12x12x12", "mg")
    it_big = _iters("hpcg:24x24x24", "mg")
    assert it_big <= it_small + 3, (it_small, it_big)


def test_mg_injection_rediscretize_converges():
    it = _iters("hpcg:16x16x16", "mg", mg_transfer="injection")
    assert it <= 30


def test_mg_fused_harness_matches_host():
    r_h = solve_system("fdm:24", "cg", "mg", dtype=np.float64,
                       harness="host", tolerance=1e-10)
    r_f = solve_system("fdm:24", "cg", "mg", dtype=np.float64,
                       harness="fused", tolerance=1e-10)
    assert r_h.converged and r_f.converged
    assert abs(r_h.iter_count - r_f.iter_count) <= 1
    np.testing.assert_allclose(r_h.x_star, r_f.x_star, atol=1e-8)


def test_mg_anderson_potential_refused():
    """Dense-diagonal stencils (random potential) have no constant-
    coefficient hierarchy — clean error pointing at cheby."""
    with pytest.raises(ValueError, match="cheby"):
        solve_system("scamac:Anderson,Lx=8,Ly=8,Lz=8,t=1.0,ranpot=0.5,"
                     "seed=1", "cg", "mg",
                     dtype=np.float64, matrix_format="stencil")


def test_mg_host_csr_path_refused():
    """Explicit CSR sources (here: a band generator with random data) get
    the guidance error from the host setup path."""
    with pytest.raises(ValueError, match="stencil"):
        solve_system("band:100,2", "cg", "mg", dtype=np.float64)


def test_mg_galerkin_injection_combination_refused():
    with pytest.raises(ValueError, match="injection"):
        _mg_setup("fdm:12", mg_transfer="injection",
                  mg_coarse_op="galerkin")


def test_mg_auto_levels_and_estimate():
    setup = _mg_setup("hpcg:32x32x32")
    levels = setup.M.mg_data
    assert len(levels) >= 2
    assert levels[1].A.dims == (16, 16, 16)
    from basic_iterative_solvers_tpu.mg import estimated_vcycle_passes
    est = estimated_vcycle_passes(levels, 2, 16)
    assert est > 0


def test_mg_cli(capsys):
    from basic_iterative_solvers_tpu.cli import run
    rc = run(["fdm:16", "-cg", "-p", "mg", "--dtype", "float64",
              "--harness", "host", "--tol", "1e-8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "converged" in out.lower() or "Converged" in out
