"""Multicolor ordering tests (coloring.py + the gs_mode='colored' paths).

The SMAX coloring permutation modes (C/PC/PC_BAL,
/root/reference/utilities/smax_helpers.hpp:25-28) have no reference tests;
these pin (a) coloring properness, (b) the KEY equivalence: the masked
colored sweep in the original ordering == sequential Gauss-Seidel in the
color-sorted ordering, and (c) convergence of the colored GS/SGS solvers
and preconditioners.  Coloring changes the sweep order, so (c) are
convergence tests, not history-parity tests against the reference.
"""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.coloring import (
    ColorSpec, check_coloring, color_ids, colored_sweep, colors_to_perm,
    greedy_coloring, grid_color_spec, mod_color_spec, spec_for_device)
from basic_iterative_solvers_tpu.generators import banded, fdm_2d, stencil_27pt
from basic_iterative_solvers_tpu.device_matrix import from_csr
from basic_iterative_solvers_tpu.types import PrecondType, SolverType


def _random_sym_csr(n=40, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(-1, 1, (n, n)) * (rng.uniform(size=(n, n)) < density)
    dense = dense + dense.T
    np.fill_diagonal(dense, 2.0 * n)
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    return MatrixCSR.from_dense(dense)


# --- coloring properness ----------------------------------------------------

@pytest.mark.parametrize("balanced", [False, True])
def test_greedy_coloring_proper(balanced):
    A = _random_sym_csr()
    colors = greedy_coloring(A, balanced=balanced)
    assert check_coloring(A, colors)
    assert colors.min() == 0


def test_greedy_native_matches_fallback():
    import os
    A = _random_sym_csr(seed=3)
    import basic_iterative_solvers_tpu._native as _native
    native = greedy_coloring(A)
    lib, tried = _native._LIB, _native._TRIED
    _native._LIB, _native._TRIED = None, True
    try:
        fallback = greedy_coloring(A)
    finally:
        _native._LIB, _native._TRIED = lib, tried
    np.testing.assert_array_equal(native, fallback)


def test_balanced_coloring_balances():
    A = fdm_2d(12)
    cb = greedy_coloring(A, balanced=True)
    counts = np.bincount(cb)
    assert check_coloring(A, cb)
    # red-black on a bipartite grid: both colors near n/2
    assert counts.size == 2 and abs(int(counts[0]) - int(counts[1])) <= 1


def test_grid_spec_hpcg_8_colors_and_proper():
    A_csr = stencil_27pt(5, 4, 3)
    A_dev = bis.stencil_op.stencil_27pt_operator(5, 4, 3, dtype=np.float64)
    spec = spec_for_device(A_dev)
    assert spec.n_colors == 8
    ids = np.asarray(color_ids(spec, A_dev))
    assert check_coloring(A_csr, ids.astype(np.int32))


def test_parity_spec_fdm_2_colors_and_proper():
    A_csr = fdm_2d(9)
    A_dev = bis.stencil_op.fdm_2d_operator(9, dtype=np.float64)
    spec = spec_for_device(A_dev)
    assert spec.kind == "parity" and spec.n_colors == 2
    ids = np.asarray(color_ids(spec, A_dev))
    assert check_coloring(A_csr, ids.astype(np.int32))


def test_mod_spec_proper_on_dia():
    A_csr = banded(50, 3, seed=2)
    A_dev = bis.dia.banded_device(50, 3, seed=2, dtype=np.float64)
    spec = spec_for_device(A_dev)
    assert spec.kind == "mod" and spec.n_colors == 4  # smallest k ∤ {1,2,3}
    ids = np.asarray(color_ids(spec, A_dev))
    assert check_coloring(A_csr, ids.astype(np.int32))


def test_mod_spec_hpcg_dia_proper():
    A_csr = stencil_27pt(6, 5, 4)
    A_dev = bis.dia.stencil_27pt_device(6, 5, 4, dtype=np.float64)
    spec = spec_for_device(A_dev)
    ids = np.asarray(color_ids(spec, A_dev))
    assert check_coloring(A_csr, ids.astype(np.int32))


# --- THE equivalence: masked sweep == GS in the color-sorted ordering -------

def _gs_sweep_permuted(A, perm, y, x, reverse=False):
    """Sequential forward/backward GS sweep of (A, y) processed in the
    permuted row order `perm` (numpy oracle)."""
    dense = A.to_dense()
    x = x.copy()
    order = perm[::-1] if reverse else perm
    for i in order:
        s = dense[i] @ x - dense[i, i] * x[i]
        x[i] = (y[i] - s) / dense[i, i]
    return x


@pytest.mark.parametrize("reverse", [False, True])
def test_colored_sweep_equals_sequential_gs(reverse):
    A = _random_sym_csr(n=30, seed=1)
    colors = greedy_coloring(A)
    perm, _ = colors_to_perm(colors)
    n_colors = int(colors.max()) + 1
    rng = np.random.default_rng(7)
    y = rng.uniform(-1, 1, A.n_rows)
    x0 = rng.uniform(-1, 1, A.n_rows)

    A_dev = from_csr(A, np.float64, "auto", 96, 0.25)
    import jax.numpy as jnp
    got = colored_sweep(A_dev, jnp.asarray(1.0 / A.diagonal()),
                        jnp.asarray(y), jnp.asarray(x0), None,
                        jnp.asarray(colors), n_colors, reverse=reverse)
    want = _gs_sweep_permuted(A, perm, y, x0, reverse=reverse)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)


def test_colored_solve_from_zero_is_triangular_solve():
    """Sweep from x=None solves (L_c + D) x = y exactly, where L_c is the
    lower part in the color-sorted ordering."""
    A = _random_sym_csr(n=25, seed=4)
    colors = greedy_coloring(A)
    perm, inv = colors_to_perm(colors)
    n_colors = int(colors.max()) + 1
    y = np.random.default_rng(5).uniform(-1, 1, A.n_rows)

    A_dev = from_csr(A, np.float64, "auto", 96, 0.25)
    import jax.numpy as jnp
    got = np.asarray(colored_sweep(
        A_dev, jnp.asarray(1.0 / A.diagonal()), jnp.asarray(y), None,
        None, jnp.asarray(colors), n_colors))
    # oracle: permute, take tril, solve, unpermute
    dense_p = A.to_dense()[np.ix_(perm, perm)]
    want_p = np.linalg.solve(np.tril(dense_p), y[perm])
    np.testing.assert_allclose(got[perm], want_p, rtol=1e-11, atol=1e-12)


# --- colored solvers / preconditioners --------------------------------------

def _xstar_residual(source, res):
    A = bis.generators.from_source(source)
    return np.linalg.norm(A.spmv(res.x_star) - np.full(A.n_rows, 1.0))


@pytest.mark.parametrize("method", ["gs", "sgs"])
def test_colored_gs_solver_converges_device_path(method):
    res = bis.solve_system("fdm:12", method=method, dtype=np.float64,
                           harness="host", tolerance=1e-9, max_iters=900)
    assert res.converged
    assert _xstar_residual("fdm:12", res) < 1e-7


def test_colored_gs_solver_matches_levels_solution():
    """Colored and levels modes are different iterations but must agree on
    the solution they converge to."""
    kw = dict(method="gs", dtype=np.float64, tolerance=1e-11, max_iters=2000,
              harness="host")
    res_c = bis.solve_system("fdm:10", gs_mode="colored", **kw)
    res_l = bis.solve_system("fdm:10", gs_mode="levels", **kw)
    assert res_c.converged and res_l.converged
    np.testing.assert_allclose(res_c.x_star, res_l.x_star, atol=1e-8)


def test_colored_gs_solver_hpcg_stencil():
    # 27-point stencil (8 colors), matrix-free stencil format
    res = bis.solve_system("hpcg:10x10x10", method="sgs",
                           matrix_format="stencil", dtype=np.float64,
                           harness="host", tolerance=1e-8, max_iters=400)
    assert res.converged
    A = bis.generators.from_source("hpcg:10x10x10")
    assert np.linalg.norm(A.spmv(res.x_star)
                          - np.full(A.n_rows, 1.0)) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("precond", ["gs", "bgs", "sgs"])
def test_colored_preconditioners_device_path(precond):
    res = bis.solve_system("hpcg:8x8x8", method="bi", preconditioner=precond,
                           dtype=np.float64, harness="host", tolerance=1e-10)
    assert res.converged
    assert _xstar_residual("hpcg:8x8x8", res) < 1e-8


@pytest.mark.slow
def test_pcg_colored_sgs_device_path():
    """CG requires an SPD preconditioner: colored SGS is (U_c+D)⁻¹D(L_c+D)⁻¹
    with U_c = L_cᵀ for symmetric A — symmetric, so PCG converges."""
    res = bis.solve_system("hpcg:8x8x8", method="cg", preconditioner="sgs",
                           dtype=np.float64, harness="host", tolerance=1e-10)
    assert res.converged
    assert _xstar_residual("hpcg:8x8x8", res) < 1e-8
    # fewer iterations than unpreconditioned CG
    res0 = bis.solve_system("hpcg:8x8x8", method="cg", dtype=np.float64,
                            harness="host", tolerance=1e-10)
    assert res.iter_count < res0.iter_count


@pytest.mark.slow
def test_colored_precond_host_csr_path():
    """gs_mode='colored' on the host-CSR path greedy-colors the graph."""
    A = _random_sym_csr(n=60, seed=9)
    cfg = bis.SolverConfig(method=SolverType.CONJUGATE_GRADIENT,
                           preconditioner=PrecondType.SYMMETRIC_GAUSS_SEIDEL,
                           dtype=np.float64, gs_mode="colored",
                           tolerance=1e-10)
    setup = bis.preprocessing(A, cfg)
    assert setup.M.n_colors > 1
    res = bis.solve(setup)
    assert res.converged


def test_fused_colored_matches_host():
    kw = dict(method="sgs", dtype=np.float64, tolerance=1e-9, max_iters=500)
    res_h = bis.solve_system("fdm:10", harness="host", **kw)
    res_f = bis.solve_system("fdm:10", harness="fused", **kw)
    assert res_h.converged and res_f.converged
    assert res_h.iter_count == res_f.iter_count
    np.testing.assert_allclose(res_f.x_star, res_h.x_star, atol=1e-10)


# --- explicit color permutation (perm_mode='color') -------------------------

def test_perm_color_collapses_levels():
    """After the color permutation the strict-lower level count equals the
    color count, so the exact trisolve scan is #colors steps."""
    from basic_iterative_solvers_tpu.factor import level_sets_lower, split_LU
    from basic_iterative_solvers_tpu.permute import (compute_permutation,
                                                     permute_csr)
    A = stencil_27pt(6, 6, 6)
    perm, inv = compute_permutation(A, "color")
    Ap = permute_csr(A, perm, inv)
    _, L_strict, _, _ = split_LU(Ap)
    n_levels = int(level_sets_lower(L_strict).max()) + 1
    colors = greedy_coloring(A)
    assert n_levels == int(colors.max()) + 1
    assert n_levels <= 8


@pytest.mark.parametrize("mode", ["color", "color_bal"])
def test_perm_color_ilu0_end_to_end(mode):
    """-perm color + -p ilu0: ILU(0) factorized in the colored ordering,
    exact level solves collapse to #colors steps, solve converges."""
    A = stencil_27pt(5, 5, 5)
    cfg = bis.SolverConfig(method=SolverType.BICGSTAB,
                           preconditioner=PrecondType.ILU0,
                           perm_mode=mode, dtype=np.float64,
                           tolerance=1e-10)
    setup = bis.preprocessing(A, cfg)
    res = bis.solve(setup)
    assert res.converged
    x = res.x_star  # already mapped back to the natural ordering
    assert np.linalg.norm(A.spmv(x) - np.full(A.n_rows, 1.0)) < 1e-8


def test_cli_gs_mode_flag(capsys):
    from basic_iterative_solvers_tpu.cli import run
    rc = run(["fdm:8", "-gs", "--gs-mode", "colored", "--platform", "cpu",
              "--harness", "host", "--dtype", "float64", "--max-iters",
              "600", "--tol", "1e-8"])
    assert rc == 0
    out = capsys.readouterr()
    assert "converged" in out.out


# --- multicolor ILU(0) -------------------------------------------------------

def test_colored_ilu0_matches_permuted_oracle():
    """Colored-sweep application of the colored ILU(0) factors equals the
    sequential triangular solves in the color-permuted space."""
    import jax.numpy as jnp
    from basic_iterative_solvers_tpu.factor import factor_ilu0_colored
    from basic_iterative_solvers_tpu.coloring import colors_to_perm
    from basic_iterative_solvers_tpu.permute import permute_csr
    from basic_iterative_solvers_tpu.device_matrix import from_csr
    from basic_iterative_solvers_tpu.coloring import colored_sweep

    A = _random_sym_csr(n=40, seed=11)
    colors = greedy_coloring(A)
    n_colors = int(colors.max()) + 1
    L_s, U_s, U_D = factor_ilu0_colored(A, colors)
    y = np.random.default_rng(3).uniform(-1, 1, A.n_rows)

    # ours: masked sweeps in the ORIGINAL ordering
    ids = jnp.asarray(colors)
    t = colored_sweep(from_csr(L_s, np.float64), 1.0, jnp.asarray(y), None,
                      None, ids, n_colors)
    z = colored_sweep(from_csr(U_s, np.float64), jnp.asarray(1.0 / U_D),
                      t, None, None, ids, n_colors, reverse=True)

    # oracle: ILU(0) in the permuted space + sequential substitutions
    perm, inv = colors_to_perm(colors)
    Ap = permute_csr(A, perm, inv)
    from basic_iterative_solvers_tpu.factor import _ilu0_values
    dense = np.zeros((A.n_rows, A.n_rows))
    rows = np.repeat(np.arange(A.n_rows), Ap.row_nnz())
    dense[rows, Ap.col] = _ilu0_values(Ap, 1e-8, 1e-4)
    Lp = np.tril(dense, -1) + np.eye(A.n_rows)
    Up = np.triu(dense)
    zp = np.linalg.solve(Lp, y[perm])
    wp = np.linalg.solve(Up, zp)
    np.testing.assert_allclose(np.asarray(z)[perm], wp, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["cg", "bi"])
def test_colored_ilu0_preconditioner_converges(method):
    # a structured matrix keeps the color count small (8): the colored
    # sweeps unroll #colors SpMVs per apply, so high-chromatic random
    # graphs would be compile-hostile (use levels mode for those)
    A = stencil_27pt(7, 6, 5)
    res = bis.solve_system(A, method=method,
                           preconditioner="ilu0", gs_mode="colored",
                           dtype=np.float64, harness="host",
                           tolerance=1e-10)
    assert res.converged
    # beats unpreconditioned iteration count
    res0 = bis.solve_system(A, method=method, dtype=np.float64,
                            harness="host", tolerance=1e-10)
    assert res.iter_count <= res0.iter_count


def test_colored_ilu0_stencil_stays_dia():
    """On a stencil matrix the colored ILU(0) strict factors keep A's
    positional pattern, so they stay DIA in the original ordering."""
    from basic_iterative_solvers_tpu.device_matrix import DeviceDIA, from_csr
    from basic_iterative_solvers_tpu.factor import factor_ilu0_colored
    A = stencil_27pt(6, 5, 4)
    colors = greedy_coloring(A)
    L_s, U_s, U_D = factor_ilu0_colored(A, colors)
    assert isinstance(from_csr(L_s, np.float64), DeviceDIA)
    assert isinstance(from_csr(U_s, np.float64), DeviceDIA)
    assert np.all(np.abs(U_D) > 0)
