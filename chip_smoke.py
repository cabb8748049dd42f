"""Smoke test of the solver on one NVIDIA GPU (or, with --four, on four).

    python chip_smoke.py          # phases (a)-(f) on one GPU
    python chip_smoke.py --four   # phase (g) only, on four GPUs

Runs the solver's main path through the entry points a user calls, at the
reference's own benchmark size (HPCG 128³: 2,097,152 rows, 55.7M nnz) and
at the capacity size 384³ (56.6M rows), and checks every answer against a
plain fp64 reference.  Each phase prints its compile seconds, ms/iter,
iteration count and true fp64 residual ``residual_f64`` relative to
‖b − A·x0‖; any failed check raises, and the script exits non-zero.

Phases: (a) main path (solve_system, the CLI); (b) one solve per kernel
family at 128³; (c) 384³ CG and PCG+ILU(0), with peak device memory;
(d) operator checks against host references (stencil SpMV vs the CSR f64
product, SGS and ILU(0) applies vs scipy triangular solves); (e) the TF32
guard: f32 solves on the GPU and on the CPU of the same process must take
the same iterations; (f) per-iteration device walls from a profiler trace;
(g) --four: the GSPMD CG over a 4-device mesh against one device, one
hand-written shard_map CG step and the collective census.

The last line of standard output is one JSON object naming the device as
JAX reports it.  Without a GPU, or outside a checkout of this repository,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HPCG128 = "hpcg:128x128x128"
HPCG384 = "hpcg:384x384x384"
SBAND = "sband:500000,8,400"        # bench.py's general-sparsity matrix

# Stated tolerances, each with its reason.  Unless a phase says otherwise
# the right-hand side is manufactured, b = A·x_true with x_true uniform in
# [0, 1) from a fixed seed, so that ‖x‖ stays O(√n).
#: f32 solves: the recurrence stops at TOL_F32·r0; the true residual may
#: sit above the recurrence one by ~eps_f32·‖A‖·‖x‖/‖r0‖ (≈2e-7 here), so
#: the check allows 10×
TOL_F32, CHECK_F32 = 1e-6, 1e-5
#: the reference's own right-hand side (b = 1, x0 = 0.1) has ‖x*‖ ~ h⁻²·√n:
#: f32 attainable accuracy there is ≈ eps_f32·‖A‖·‖x*‖/r0 ≈ 3.4e-4·r0 at
#: 128³ (measured on the H100 for CG+Jacobi), whatever the tolerance
CHECK_REF_F32 = 1e-3
#: stationary methods (Jacobi, GS, SGS) converge linearly at ρ ≈ 1 − O(h²);
#: 1e-4 keeps them to a few thousand iterations at 128³
TOL_STAT, CHECK_STAT = 1e-4, 1e-3
#: a bf16 GMRES basis stores each Arnoldi vector to 8 mantissa bits, so
#: within a restart cycle the Arnoldi relation holds only to ~eps_bf16
#: (3.9e-3): the true residual can sit that factor of the cycle's starting
#: residual above the recurrence (6.8e-5·r0 at 64³ on the CPU, tol 1e-6)
CHECK_GMRES_BF16 = 1e-2
#: fp64 refinement target (bench.py's time-to-solution row)
TOL_REFINE = 1e-11
#: operator checks: 27 f32 terms × eps_f32 ≈ 3e-6
RTOL_OP = 1e-5
#: TF32 guard: f32 and f64 histories of the phase-(e) solves agree to
#: ~2e-6·‖r0‖ on the CPU, so two f32 runs that differ only in summation
#: order stay well inside 1e-4; a TF32 product (~3 digits) would not
RTOL_TF32_HIST = 1e-4
#: --four: GSPMD reorders the dot-product sums across devices; the solve
#: stops at 1e-5·r0, a decade above where f32 CG's recurrence starts to
#: depend on the summation order
TOL_MESH, CHECK_MESH, RTOL_MESH_HIST = 1e-5, 1e-4, 1e-3


def check_devices(devices, need: int = 1) -> None:
    """Refuse anything but `need` GPUs: a CPU fallback must never report
    as a device run."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {kind}")
    if len(devices) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found "
                         f"{len(devices)}")


def log(*a):
    print(*a, flush=True)


def _nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("chip_smoke: nvidia-smi not found")
    return subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


def _rel_resid(bis, setup, x_solve) -> tuple:
    """(‖b − A·x‖ / ‖b − A·x0‖) in fp64 through the repo's oracle."""
    import numpy as np
    assert setup.inv_perm is None and setup.scale_vec is None
    r = np.linalg.norm(bis.solvers.base.residual_f64(setup, x_solve))
    r0 = np.linalg.norm(bis.solvers.base.residual_f64(setup, setup.x0))
    return float(r / r0), float(r0)


def run_setup(bis, phase: str, label: str, setup, check: float) -> dict:
    """Solve twice (compile, then measure), check the true residual."""
    from basic_iterative_solvers_tpu.solvers import make_method
    method = make_method(setup)
    t0 = time.perf_counter()
    res = bis.solve(setup, method=method)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = bis.solve(setup, method=method)
    second = time.perf_counter() - t0
    rel, _r0 = _rel_resid(bis, setup, res.x_star)
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    log(f"[{phase}] {label}: compile {max(0.0, first - second):.1f} s, "
        f"{ms:.4f} ms/iter, {res.iter_count} iters, residual_f64 {rel:.3e} "
        f"(check <= {check:g})")
    if not rel <= check:
        raise AssertionError(f"{label}: residual_f64 {rel:.3e} > {check:g}")
    return {"res": res, "method": method, "ms": ms}


def _cfg(bis, method, precond="NONE", **kw):
    import numpy as np
    kw.setdefault("dtype", np.float32)
    kw.setdefault("harness", "fused")
    return bis.SolverConfig(method=getattr(bis.SolverType, method),
                            preconditioner=getattr(bis.PrecondType, precond),
                            **kw)


_RHS = {}


def manufactured_b(src):
    """b = A·x_true in fp64 on the device, x_true ~ U[0, 1) (seed 0)."""
    if src not in _RHS:
        import jax
        import jax.numpy as jnp
        from basic_iterative_solvers_tpu import stencil_op
        A64 = stencil_op.from_source_operator(src, dtype=jnp.float64)
        x_true = jax.random.uniform(jax.random.PRNGKey(0), (A64.n_rows,),
                                    jnp.float64)
        _RHS.clear()
        _RHS[src] = jax.jit(stencil_op.stencil_spmv_xla)(A64, x_true)
    return _RHS[src]


def _stencil_setup(bis, src, cfg, b="manufactured"):
    from basic_iterative_solvers_tpu import stencil_op
    A = stencil_op.from_source_operator(src, dtype=cfg.mat_dtype())
    if cfg.color_spec is None:
        cfg.color_spec = bis.generators.color_spec_for_source(src)
    if isinstance(b, str) and b == "manufactured":
        b = manufactured_b(src)
    return bis.preprocessing_device(A, cfg, b=b)


def _r0_of(res, tol):
    return res.stopping_criteria / tol


# ---------------------------------------------------------------------------
# (a) main path
# ---------------------------------------------------------------------------

def phase_a(bis):
    """solve_system and the CLI on the reference's own problem (b = 1,
    x0 = 0.1), then solve_system on the manufactured one."""
    import numpy as np
    from basic_iterative_solvers_tpu import cli
    A = bis.generators.from_source(HPCG128)

    def host_rel(x, b):
        x0 = np.full(A.n_rows, 0.1)
        return float(np.linalg.norm(b - A.spmv(x))
                     / np.linalg.norm(b - A.spmv(x0)))

    t0 = time.perf_counter()
    res = bis.solve_system(HPCG128, method="cg", preconditioner="j",
                           tolerance=TOL_F32)
    wall = time.perf_counter() - t0
    r0 = _r0_of(res, TOL_F32)
    rel = res.final_residual_norm / r0
    h_rel = host_rel(res.x_star, np.full(A.n_rows, 1.0))
    log(f"[a] solve_system cg+j {HPCG128}, reference b: {wall:.1f} s incl. "
        f"compile, {1e3 * res.solve_seconds / res.iter_count:.4f} ms/iter "
        f"incl. compile, {res.iter_count} iters, residual_f64 {rel:.3e}, "
        f"host CSR {h_rel:.3e} (check <= {CHECK_REF_F32:g})")
    assert res.converged and rel <= CHECK_REF_F32
    assert abs(h_rel - rel) <= 1e-2 * rel

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.run([HPCG128, "-cg", "-p", "j", "--tol", str(TOL_F32)])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    m_it = re.search(r"converged in: (\d+) iterations", out)
    m_r = re.search(r"\|\|A\*x_star - b\|\|_2 = ([0-9.eE+-]+)\.\s*$", out,
                    re.M)
    assert rc == 0 and m_it and m_r, out[-2000:]
    cli_rel = float(m_r.group(1)) / r0
    log(f"[a] cli.run cg+j {HPCG128}, reference b: {wall:.1f} s incl. "
        f"compile, {m_it.group(1)} iters, residual_f64 {cli_rel:.3e} "
        f"(check <= {CHECK_REF_F32:g}, iters ±1 of solve_system)")
    assert cli_rel <= CHECK_REF_F32
    assert abs(int(m_it.group(1)) - res.iter_count) <= 1

    b = np.asarray(manufactured_b(HPCG128))
    t0 = time.perf_counter()
    res = bis.solve_system(HPCG128, method="cg", preconditioner="j", b=b,
                           tolerance=TOL_F32)
    wall = time.perf_counter() - t0
    rel = res.final_residual_norm / _r0_of(res, TOL_F32)
    h_rel = host_rel(res.x_star, b)
    log(f"[a] solve_system cg+j {HPCG128}, manufactured b: {wall:.1f} s "
        f"incl. compile, {res.iter_count} iters, residual_f64 {rel:.3e}, "
        f"host CSR {h_rel:.3e} (check <= {CHECK_F32:g})")
    assert res.converged and rel <= CHECK_F32 and h_rel <= CHECK_F32
    return A


# ---------------------------------------------------------------------------
# (b) one solve per kernel family at 128³
# ---------------------------------------------------------------------------

def phase_b(bis):
    import numpy as np
    mi = dict(max_iters=60000)
    fams = [
        ("jacobi", _cfg(bis, "JACOBI", tolerance=TOL_STAT, **mi), CHECK_STAT),
        ("gs (superblock const)",
         _cfg(bis, "GAUSS_SEIDEL", tolerance=TOL_STAT, **mi), CHECK_STAT),
        ("sgs (superblock const)",
         _cfg(bis, "SYMMETRIC_GAUSS_SEIDEL", tolerance=TOL_STAT, **mi),
         CHECK_STAT),
        ("pcg+sgs", _cfg(bis, "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
                         tolerance=TOL_F32), CHECK_F32),
        ("pcg+ilu0 (translation tables)",
         _cfg(bis, "CONJUGATE_GRADIENT", "ILU0", tolerance=TOL_F32),
         CHECK_F32),
        ("gmres(50) bf16 basis",
         _cfg(bis, "GMRES", tolerance=TOL_F32, restart_length=50,
              orthog_mode="lowsync", gmres_basis_dtype="bfloat16",
              max_iters=2000), CHECK_GMRES_BF16),
        ("pbicgstab+sgs", _cfg(bis, "BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL",
                               tolerance=TOL_F32), CHECK_F32),
        ("pcg+mg", _cfg(bis, "CONJUGATE_GRADIENT", "MULTIGRID",
                        tolerance=TOL_F32), CHECK_F32),
        ("cg+mg f32 + 3 fp64 refinement outers",
         _cfg(bis, "CONJUGATE_GRADIENT", "MULTIGRID", tolerance=TOL_REFINE,
              refine_outer=3, max_iters=300), TOL_REFINE),
    ]
    for label, cfg, check in fams:
        setup = _stencil_setup(bis, HPCG128, cfg)
        if "superblock" in label:
            assert setup.gs_L_block is not None, "blocked GS not taken"
        if "ilu0" in label or "pcg+sgs" in label:
            assert setup.M.L_block is not None, "blocked trisolve not taken"
        run_setup(bis, "b", f"{label} {HPCG128}", setup, check)
        del setup

    A = bis.generators.from_source(SBAND)
    cfg = _cfg(bis, "CONJUGATE_GRADIENT", tolerance=TOL_F32,
               matrix_format="lane_ell", max_iters=5000)
    x_true = np.random.default_rng(0).uniform(size=A.n_rows)
    setup = bis.preprocessing(A, cfg, b=A.spmv(x_true))
    run_setup(bis, "b", f"cg lane-ELL {SBAND}", setup, CHECK_F32)


# ---------------------------------------------------------------------------
# (c) capacity size
# ---------------------------------------------------------------------------

def phase_c(bis):
    import jax
    for label, cfg in (
            ("cg", _cfg(bis, "CONJUGATE_GRADIENT", tolerance=TOL_F32)),
            ("pcg+ilu0 (translation tables)",
             _cfg(bis, "CONJUGATE_GRADIENT", "ILU0", tolerance=TOL_F32))):
        t0 = time.perf_counter()
        setup = _stencil_setup(bis, HPCG384, cfg)
        jax.block_until_ready(setup.b)
        log(f"[c] {label} {HPCG384}: setup {time.perf_counter() - t0:.1f} s")
        run_setup(bis, "c", f"{label} {HPCG384}", setup, CHECK_F32)
        del setup
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"[c] peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)")


# ---------------------------------------------------------------------------
# (d) operators against plain host references
# ---------------------------------------------------------------------------

def _scipy_csr(M):
    import scipy.sparse as sp
    return sp.csr_matrix((M.val, M.col, M.row_ptr),
                         shape=(M.n_rows, M.n_cols))


def phase_d(bis, A_host):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    from basic_iterative_solvers_tpu import stencil_op
    from basic_iterative_solvers_tpu.factor import factor_ilu0
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    from basic_iterative_solvers_tpu.ops.spmv import spmv
    from basic_iterative_solvers_tpu.precond import apply_preconditioner

    rng = np.random.default_rng(0)
    n = A_host.n_rows
    x = rng.standard_normal(n).astype(np.float32)
    A_dev = stencil_op.from_source_operator(HPCG128, dtype=jnp.float32)
    y = np.asarray(jax.jit(spmv)(A_dev, jnp.asarray(x)), dtype=np.float64)
    y_ref = A_host.spmv(x.astype(np.float64))
    rel = float(np.max(np.abs(y - y_ref)) / np.max(np.abs(y_ref)))
    log(f"[d] stencil SpMV f32 {HPCG128} vs host CSR f64: max rel "
        f"{rel:.3e} (check <= {RTOL_OP:g})")
    assert rel <= RTOL_OP

    # the colored ordering the device trisolves are exact for
    spec = bis.coloring.spec_for_device(A_dev)
    assert spec.kind == "grid", spec
    nx, ny, nz, sx, sy, sz = spec.params
    i = np.arange(n)
    gx, gy, gz = i % nx, (i // nx) % ny, i // (nx * ny)
    colors = gx % sx + sx * (gy % sy + sy * (gz % sz))
    order = np.argsort(colors, kind="stable")
    S = _scipy_csr(A_host)
    Ap = S[order][:, order].tocsr()
    yv = rng.standard_normal(n).astype(np.float32)
    y_p = yv.astype(np.float64)[order]

    L = sp.tril(Ap, 0, format="csr")
    U = sp.triu(Ap, 0, format="csr")
    z_p = spsolve_triangular(U, Ap.diagonal() * spsolve_triangular(
        L, y_p, lower=True), lower=False)
    ilu = factor_ilu0(MatrixCSR.from_scipy(Ap))
    Li, Ui = _scipy_csr(ilu[0]), _scipy_csr(ilu[3])
    zi_p = spsolve_triangular(Ui, spsolve_triangular(
        Li, y_p, lower=True, unit_diagonal=True), lower=False)
    for label, precond, z_ref_p in (("SGS", "SYMMETRIC_GAUSS_SEIDEL", z_p),
                                    ("ILU(0)", "ILU0", zi_p)):
        setup = _stencil_setup(bis, HPCG128, _cfg(
            bis, "CONJUGATE_GRADIENT", precond, tolerance=TOL_F32))
        assert setup.M.L_block is not None
        z = np.asarray(jax.jit(apply_preconditioner)(setup.M,
                                                     jnp.asarray(yv)))
        z_ref = np.empty(n)
        z_ref[order] = z_ref_p
        rel = float(np.max(np.abs(z - z_ref)) / np.max(np.abs(z_ref)))
        log(f"[d] {label} apply f32 {HPCG128} vs scipy "
            f"spsolve_triangular f64 on host factors: max rel {rel:.3e} "
            f"(check <= {RTOL_OP:g})")
        assert rel <= RTOL_OP
        del setup


# ---------------------------------------------------------------------------
# (e) TF32 guard: the same f32 solves on the GPU and on this process's CPU
# ---------------------------------------------------------------------------

def phase_e(bis):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from basic_iterative_solvers_tpu.ops.blas1 import dot
    # a direct probe first: 1 + 2^-11 is exact in f32 but not in TF32
    # (10 mantissa bits), and every partial sum of 1024 such terms is exact
    # in f32 whatever the order, so only a TF32 dot can miss 1024.5
    n = 1024
    x = jnp.full(n, 1.0 + 2.0 ** -11, jnp.float32)
    got = float(jax.jit(dot)(x, jnp.ones(n, jnp.float32)))
    want = n * (1.0 + 2.0 ** -11)
    log(f"[e] f32 dot probe on the GPU: {got!r} (exact f32 {want!r})")
    assert got == want, "an f32 dot ran below f32 precision (TF32?)"

    src = "hpcg:32x32x32"
    # the manufactured right-hand side: f32 and f64 histories of these
    # solves agree to ~2e-6 of ‖r0‖ on the CPU (the reference b = 1 makes
    # ‖x*‖ large, and the f32 CG history there moves with the summation
    # order alone)
    b = np.asarray(manufactured_b(src))
    cases = (
        ("cg", lambda: _cfg(bis, "CONJUGATE_GRADIENT", tolerance=TOL_F32)),
        ("gmres(20)", lambda: _cfg(bis, "GMRES", tolerance=TOL_F32,
                                   restart_length=20, orthog_mode="lowsync",
                                   max_iters=2000)),
        ("pcg+mg", lambda: _cfg(bis, "CONJUGATE_GRADIENT", "MULTIGRID",
                                tolerance=TOL_F32)),
    )
    cpu = jax.devices("cpu")[0]
    for label, mk in cases:
        res_g = bis.solve(_stencil_setup(bis, src, mk(), b=b))
        with jax.default_device(cpu):
            res_c = bis.solve(_stencil_setup(bis, src, mk(), b=b))
        hg = np.asarray(res_g.residual_norms, dtype=np.float64)
        hc = np.asarray(res_c.residual_norms, dtype=np.float64)
        m = min(hg.size, hc.size)
        dev = float(np.max(np.abs(hg[:m] - hc[:m])) / hc[0])
        log(f"[e] {label} f32 {src}: gpu {res_g.iter_count} iters, cpu "
            f"{res_c.iter_count} iters, history max rel dev {dev:.3e} "
            f"(check iters ±1, dev <= {RTOL_TF32_HIST:g})")
        assert abs(res_g.iter_count - res_c.iter_count) <= 1
        assert dev <= RTOL_TF32_HIST


# ---------------------------------------------------------------------------
# (f) per-iteration device walls from a profiler trace
# ---------------------------------------------------------------------------

def phase_f(bis):
    import glob
    import numpy as np
    from basic_iterative_solvers_tpu import cli
    from basic_iterative_solvers_tpu.utils import xprof
    setup = _stencil_setup(bis, HPCG128, _cfg(bis, "CONJUGATE_GRADIENT",
                                              tolerance=TOL_F32))
    out = run_setup(bis, "f", f"cg {HPCG128} (untraced)", setup, CHECK_F32)
    res = out["res"]
    walls = xprof.measure_iteration_times(out["method"],
                                          n_iters=res.iter_count)
    assert walls is not None and walls.size == res.iter_count, walls
    assert np.all(walls > 0)
    log(f"[f] xprof device walls cg {HPCG128}: {walls.size} iterations, "
        f"median {1e3 * np.median(walls):.4f} ms/iter (untraced host "
        f"wall {out['ms']:.4f} ms/iter)")
    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            rc = cli.run([HPCG128, "-cg", "--tol", "1e-4",
                          "--profile", d, "--iter-times"])
        text = buf.getvalue()
        assert rc == 0, text[-2000:]
        assert "[iter-times] measured device walls attached" in text, \
            text[-2000:]
        traces = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                           recursive=True)
        assert traces, "--profile wrote no trace"
        log(f"[f] cli --profile --iter-times: device walls attached, "
            f"trace {os.path.basename(traces[0])} "
            f"({os.path.getsize(traces[0])} bytes)")


# ---------------------------------------------------------------------------
# (g) four devices
# ---------------------------------------------------------------------------

HPCG256 = "hpcg:256x256x256"


def phase_g(bis):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from basic_iterative_solvers_tpu.dia import dia_split, stencil_27pt_device
    from basic_iterative_solvers_tpu.parallel import (make_mesh,
                                                      make_sharded_cg,
                                                      shard_setup)
    from basic_iterative_solvers_tpu.parallel.census import (
        fused_collective_census)
    mesh = make_mesh(4)

    def cfg():
        return _cfg(bis, "CONJUGATE_GRADIENT", "JACOBI", tolerance=TOL_MESH)

    out1 = run_setup(bis, "g", f"cg+j {HPCG256}, 1 device",
                     _stencil_setup(bis, HPCG256, cfg()), CHECK_MESH)
    setup4 = shard_setup(_stencil_setup(bis, HPCG256, cfg()), mesh)
    out4 = run_setup(bis, "g", f"cg+j {HPCG256}, GSPMD over 4 devices",
                     setup4, CHECK_MESH)
    r1, r4 = out1["res"], out4["res"]
    h1 = np.asarray(r1.residual_norms, dtype=np.float64)
    h4 = np.asarray(r4.residual_norms, dtype=np.float64)
    m = min(h1.size, h4.size)
    dev = float(np.max(np.abs(h1[:m] - h4[:m])) / h1[0])
    log(f"[g] 1<->4 parity: {r1.iter_count} vs {r4.iter_count} iters, "
        f"history max rel dev {dev:.3e} (check equal, <= "
        f"{RTOL_MESH_HIST:g})")
    assert r1.iter_count == r4.iter_count and dev <= RTOL_MESH_HIST

    cen = fused_collective_census(setup4, out4["method"])
    w = cen["in_while"]
    log(f"[g] census per iteration: all-reduce {w['all-reduce']}, "
        f"collective-permute {w['collective-permute']}, all-gather "
        f"{w['all-gather']}, all-to-all {w['all-to-all']}; full-vector "
        f"gathers {cen['full_gathers']}")
    assert w["all-reduce"] >= 1 and w["collective-permute"] >= 1
    assert w["all-gather"] == 0 and w["all-to-all"] == 0
    assert not cen["full_gathers"]

    nx = int(HPCG256.split(":")[1].split("x")[0])
    Ad = stencil_27pt_device(nx, nx, nx, dtype=jnp.float32)
    _, _, _, D_inv = dia_split(Ad)
    cg = make_sharded_cg(Ad, jnp.ones(Ad.n_rows, jnp.float32), mesh,
                         D_inv=D_inv)
    step = jax.jit(cg.step_fn())
    state = jax.block_until_ready(step(cg.init_state(cg.b * 0.0)))
    rn = float(state["residual_norm"])
    log(f"[g] make_sharded_cg one step {HPCG256}: ||r_1|| = {rn:.6e}")
    assert np.isfinite(rn) and rn > 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device phase (g)")
    args = ap.parse_args(argv)
    import jax
    import basic_iterative_solvers_tpu as bis
    import basic_iterative_solvers_tpu.solvers.base  # noqa: F401
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(bis.__file__)) != here:
        raise SystemExit(f"chip_smoke: the package was imported from "
                         f"{bis.__file__}, not from this checkout")
    need = 4 if args.four else 1
    devices = jax.devices()
    check_devices(devices, need)
    log(f"[device] {_nvidia_smi()}")
    log(f"[device] jax: {devices[0].device_kind} x{len(devices)}")
    log(f"[cache] compile cache: {jax.config.jax_compilation_cache_dir}")
    t0 = time.perf_counter()
    if args.four:
        phase_g(bis)
    else:
        A_host = phase_a(bis)
        phase_b(bis)
        phase_c(bis)
        phase_d(bis, A_host)
        del A_host
        phase_e(bis)
        phase_f(bis)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
