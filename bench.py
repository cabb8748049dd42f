"""Headline benchmark.

Replicates the reference's published benchmark setup (BASELINE.md): solve
with the HPCG 27-point stencil matrix (~2.1M rows), b = 2.0, x0 = 1.0, and
report **time per iteration** for every method row the reference publishes
(README.md:3-6 figures, single Sapphire Rapids socket):

    jacobi 22.3 | gs 46.5 | sgs 46.5 | cg 11.8 | gmres(50) 23.8 |
    bicgstab 24.0 | pcg 105.3 | pgmres 118.9 | pbicgstab 247.9   [ms/iter]

Default run = the FULL table (one JSON line per row, flushed as computed)
plus capacity / general-sparsity / time-to-solution rows.  The headline CG
row is measured FIRST (so a truncated run still carries it) and its line
plus a cumulative `bench_table` line are REPRINTED after every row — the
stdout tail therefore always ends with the full partial table followed by
the headline, whatever happens later.  A `--budget-secs` wall-clock budget
(counted from process start, probe time included) skips remaining optional
rows when they no longer fit.  `--method X` runs a single row.  The preconditioned rows use the exact
symmetric Gauss-Seidel preconditioner via multicolor sweeps (coloring.py) —
the apples-to-apples analog of the reference's sequential-SpTRSV GS-type
M⁻¹; `--precond s2st` selects the two-stage (Richardson) family instead.

Each line: {"metric": "...", "value": N, "unit": "ms_per_iter",
"vs_baseline": N, "device": {...}} with vs_baseline = reference_ms /
our_ms (>1 = faster) and the device as JAX reports it.  The benchmark
refuses to run anywhere but on a GPU; `--platform cpu` is an explicit
rehearsal of the pipeline whose rows carry no rates (value null).
Diagnostics go to stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINES_MS = {
    # method -> reference ms/iter on HPCG-128 (BASELINE.md table)
    "cg": 11.8,
    "jacobi": 22.3,
    "gs": 46.5,
    "sgs": 46.5,
    "gmres": 23.8,
    "bicgstab": 24.0,
    "pcg": 105.3,
    "pgmres": 118.9,
    "pbicgstab": 247.9,
}

METHOD_MAP = {
    "cg": ("CONJUGATE_GRADIENT", "NONE"),
    "jacobi": ("JACOBI", "NONE"),
    "gs": ("GAUSS_SEIDEL", "NONE"),
    "sgs": ("SYMMETRIC_GAUSS_SEIDEL", "NONE"),
    "gmres": ("GMRES", "NONE"),
    "bicgstab": ("BICGSTAB", "NONE"),
    "pcg": ("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL"),
    "pgmres": ("GMRES", "SYMMETRIC_GAUSS_SEIDEL"),
    "pbicgstab": ("BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL"),
}

PRECOND_CHOICES = {
    "sgs": "SYMMETRIC_GAUSS_SEIDEL",   # exact, multicolor sweeps
    "gs": "GAUSS_SEIDEL",
    "2st": "TWO_STAGE_GS",
    "s2st": "SYMMETRIC_TWO_STAGE_GS",  # Richardson (pure SpMV chains)
    "j": "JACOBI",
    "ilu0": "ILU0",
    "cheby": "CHEBYSHEV",              # polynomial (communication-free)
    "mg": "MULTIGRID",                 # geometric V-cycle (stencil sources)
}

#: default measured iterations per method.  Not yet sized for the GPU:
#: these counts predate any measurement of the card's per-dispatch cost.
DEFAULT_ITERS = {
    "cg": 2500, "jacobi": 2500, "bicgstab": 1500, "gmres": 1500,
    "gs": 1200, "sgs": 1200, "pcg": 1200, "pgmres": 800, "pbicgstab": 800,
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _record(metric: str, ms: float, unit: str, base: float) -> dict:
    """One output row; a CPU rehearsal reports no rate."""
    dev = device_info()
    if dev["platform"] == "cpu":
        return {"metric": metric, "value": None, "unit": unit,
                "vs_baseline": None, "device": dev,
                "note": "cpu rehearsal: no rates"}
    return {"metric": metric, "value": ms, "unit": unit,
            "vs_baseline": base / ms, "device": dev}


def build_matrix(bis, source: str, fmt: str, mat_dt):
    """Build the benchmark operator on device (no O(nnz) host passes)."""
    import jax
    is_gen = bis.dia._GEN_RE.match(source) is not None
    t0 = time.perf_counter()
    if is_gen:
        if fmt == "auto":
            fmt = ("stencil"
                   if bis.stencil_op._GEN_RE.match(source) else "dia")
        if fmt == "stencil":
            A = bis.stencil_op.from_source_operator(source, dtype=mat_dt)
            jax.block_until_ready(A.coeffs)
            nnz = "(matrix-free)"
        else:
            A = bis.dia.from_source_device(source, dtype=mat_dt)
            jax.block_until_ready(A.data)
            nnz = int(jax.jit(lambda d: (d != 0).sum())(A.data))
    else:
        A = bis.generators.from_source(source)
        nnz = A.nnz
    log(f"matrix {source}: {A.n_rows} rows, {nnz} nnz "
        f"({time.perf_counter() - t0:.1f}s to build)")
    return A, is_gen


def run_one(bis, method_key: str, args, A, is_gen) -> dict:
    """Measure one method row; returns the JSON record."""
    import jax
    import jax.numpy as jnp

    method_name, precond_name = METHOD_MAP[method_key]
    if args.precond and precond_name != "NONE":
        precond_name = PRECOND_CHOICES[args.precond]
    dtype = np.dtype(args.dtype)
    iters = args.iters or DEFAULT_ITERS[method_key]

    cfg = bis.SolverConfig(
        method=getattr(bis.SolverType, method_name),
        preconditioner=getattr(bis.PrecondType, precond_name),
        dtype=dtype, matrix_dtype=args.matrix_dtype, harness="fused",
        max_iters=iters, tolerance=0.0,   # run exactly `iters` iterations
        restart_length=args.restart_length,
        orthog_mode=args.orthog,
        gmres_basis_dtype=(None if args.gmres_basis == "none"
                           else args.gmres_basis),
        precond_inner_iters=args.precond_inner_iters,
        color_spec=bis.generators.color_spec_for_source(args.matrix),
        # Rate rows run tolerance=0 for a fixed iteration budget; strong
        # preconditioners (mg — and sgs under BiCGSTAB's ρ/ω quotients)
        # converge past the attainable floor well inside it.  Stall the
        # recurrence scalars instead of timing NaN junk: the per-iteration
        # work stays representative and the row's final ||r|| stays an
        # honest explicit residual.  Cost: a handful of scalar selects.
        breakdown_stall=True)

    A_dev_inject = None
    blocked_gs = (precond_name in ("GAUSS_SEIDEL", "BACKWARDS_GAUSS_SEIDEL",
                                   "SYMMETRIC_GAUSS_SEIDEL")
                  and cfg.color_spec is not None
                  and cfg.color_spec.kind == "grid")
    host_ilu0 = precond_name == "ILU0"
    if ((blocked_gs or host_ilu0) and is_gen
            and isinstance(A, bis.stencil_op.DeviceStencil)):
        # constant-coefficient stencil sources build the GS-family blocked
        # pair ANALYTICALLY and the exact ILU(0) pair via TRANSLATION
        # TABLES on the device path (ops/block_trisolve.py) — no host
        # CSR, no O(nnz) setup at all.  Only fall through to the host-CSR
        # route when the stencil builder is ineligible.
        from basic_iterative_solvers_tpu.coloring import spec_for_device
        from basic_iterative_solvers_tpu.ops.block_trisolve import (
            stencil_blocked_eligible, stencil_ilu0_eligible)
        import dataclasses as _dc
        # ILU(0) has its own (looser) predicate: the translation-table
        # builder also runs the split-parity layout (any nx — e.g. 384³),
        # where the const-GS pair needs the fused one.
        elig_fn = stencil_ilu0_eligible if host_ilu0 else stencil_blocked_eligible
        try:
            eligible = elig_fn(A, spec_for_device(A))
        except ValueError:
            eligible = False
        if eligible:
            cfg = _dc.replace(cfg, gs_mode="colored")
            what = ("translation-table exact ILU(0)" if host_ilu0
                    else "analytic const-mode blocked pair")
            blocked_gs = host_ilu0 = False
            log(f"[{method_key}] {precond_name}: {what} "
                "(device path, zero host-CSR setup)")
    if (host_ilu0 or blocked_gs) and is_gen and A.n_rows > 2**24:
        # the host-CSR fallback at capacity sizes (384³ = 56.6M rows,
        # ~18 GB CSR) takes many minutes on the throttled host — never
        # inside a bench budget.  The device builders above are the only
        # sane route at this size; if they refused, skip the row.
        raise RuntimeError(
            f"{precond_name} at {A.n_rows} rows needs the device builder "
            "(host-CSR setup would blow the bench budget)")
    if host_ilu0 or blocked_gs:
        # These preconditioners factor/pack on the host CSR; multicolor
        # mode keeps the triangular applies parallel at scale, and a grid
        # color spec upgrades them to the SUPERBLOCK blocked trisolves
        # (factors stream ONCE per solve instead of once per color —
        # ops/block_trisolve.py).  The solve-time operator stays
        # MATRIX-FREE (stencil injection) — only the factors materialize.
        import dataclasses as _dc
        cfg = _dc.replace(cfg, gs_mode="colored")
        if is_gen:
            t0 = time.perf_counter()
            A = bis.generators.from_source(args.matrix)
            is_gen = False
            if bis.stencil_op._GEN_RE.match(args.matrix):
                A_dev_inject = bis.stencil_op.from_source_operator(
                    args.matrix, dtype=cfg.mat_dtype())
            log(f"[{method_key}] host CSR for {precond_name}: "
                f"{time.perf_counter() - t0:.1f}s "
                f"(solve operator: "
                f"{'matrix-free stencil' if A_dev_inject is not None else 'from_csr'})")

    t0 = time.perf_counter()
    # Reference figure setup: b = 2.0, x0 = 1.0 (BASELINE.md).
    n_rows = A.n_rows
    if is_gen:
        setup = bis.preprocessing_device(
            A, cfg, b=jnp.full(n_rows, 2.0, dtype=dtype),
            x0=jnp.full(n_rows, 1.0, dtype=dtype))
    else:
        setup = bis.preprocessing(A, cfg,
                                  b=np.full(n_rows, 2.0),
                                  x0=np.full(n_rows, 1.0),
                                  A_dev=A_dev_inject)
    log(f"[{method_key}] preprocessing: {time.perf_counter() - t0:.1f}s "
        f"(device format: {type(setup.A).__name__}, "
        f"precond: {precond_name}, n_colors: {setup.M.n_colors})")

    # Run twice with the same method instance: the first call compiles the
    # fused while-loop; later calls reuse the cached executable.
    from basic_iterative_solvers_tpu.solvers import make_method
    method = make_method(setup)
    t0 = time.perf_counter()
    res = bis.solve(setup, method=method)
    log(f"[{method_key}] warmup solve: {time.perf_counter() - t0:.1f}s "
        f"({res.iter_count} iters, incl. compile)")
    best = float("inf")
    for rep in range(args.repeats):
        res = bis.solve(setup, method=method)
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        log(f"[{method_key}] measured[{rep}]: {res.solve_seconds:.3f}s, "
            f"{res.iter_count} iters, {ms:.3f} ms/iter")
        best = min(best, ms)
    log(f"[{method_key}] best: {best:.3f} ms/iter, final ||r|| = "
        f"{res.final_residual_norm:.3e}")

    from basic_iterative_solvers_tpu.utils.report import roofline_report
    roofline_report(setup, res)

    matrix_tag = args.matrix.replace(":", "_")
    return _record(f"{method_key}_ms_per_iter_{matrix_tag}", best,
                   "ms_per_iter", BASELINES_MS[method_key])


def run_general_row(bis, args, source="sband:500000,8,400",
                    iters=400) -> dict:
    import time as _t
    t0 = _t.perf_counter()
    A = bis.generators.from_source(source)
    log(f"[cg@sband] built {source}: {A.n_rows} rows, {A.nnz} nnz "
        f"({_t.perf_counter() - t0:.1f}s, host generator)")
    dtype = np.dtype(args.dtype)
    times = {}
    for fmt in ("lane_ell", "ell"):
        fmt_iters = iters
        cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                               dtype=dtype, harness="fused",
                               max_iters=fmt_iters,
                               tolerance=0.0, matrix_format=fmt)
        setup = bis.preprocessing(A, cfg, b=np.full(A.n_rows, 2.0),
                                  x0=np.full(A.n_rows, 1.0))
        from basic_iterative_solvers_tpu.solvers import make_method
        method = make_method(setup)
        res = bis.solve(setup, method=method)   # warmup/compile
        best = float("inf")
        for _ in range(args.repeats):
            res = bis.solve(setup, method=method)
            best = min(best, 1e3 * res.solve_seconds / max(1, res.iter_count))
        times[fmt] = best
        log(f"[cg@sband] {fmt} ({type(setup.A).__name__}): "
            f"{best:.3f} ms/iter, final ||r|| = {res.final_residual_norm:.3e}")
    # baseline = the plain ELL gather path on the same device
    return _record("cg_ms_per_iter_"
                   + source.replace(":", "_").replace(",", "x")
                   + "_lane_ell", times["lane_ell"], "ms_per_iter",
                   times["ell"])


def run_mg_tts(bis, args, A) -> dict:
    """Time-to-solution row: CG + multigrid V-cycle + fp64 refinement to
    1e-11 * ||b - A x0||.

    Why 1e-11 and not the reference's TOL=1e-14: the fp64 TRUE-residual
    attainable floor eps_f64*||A||*||x*|| sits at ~2.7e-12 * r0 for this
    problem (measured: refinement outers contract 5-6 decades each, then
    stall pinned at 9.8e-9 absolute = 2.7e-12 relative at 128^3, and at
    eps*52*||x|| across sizes) — NO solver in ANY precision can place the
    explicitly-computed residual below it.  The reference's convergence
    figure reaches 1e-15*r0 only on the CG RECURRENCE residual
    (cg.hpp:162-166 samples the recurrence r, which keeps shrinking below
    the true-residual floor).  1e-11*r0 is ~4x above the floor: reachable
    by BOTH sides with honestly-computed residuals.  vs_baseline = the
    reference's BEST total solve time to that accuracy (plain CG on the
    figure: 100 iters / 1.12 s to 1e-15 recurrence ~= true residual until
    the floor; pro-rated to 1e-11 as 1.12 * 11/15 = 0.82 s — CG gains
    decades ~linearly in iterations; its preconditioned rows all LOSE on
    total time) over ours."""
    import jax.numpy as jnp
    dtype = np.dtype(args.dtype)
    cfg = bis.SolverConfig(
        method=bis.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bis.PrecondType.MULTIGRID,
        dtype=dtype, matrix_dtype=args.matrix_dtype, harness="fused",
        max_iters=300, tolerance=1e-11, refine_outer=8)
    n = A.n_rows
    setup = bis.preprocessing_device(
        A, cfg, b=jnp.full(n, 2.0, dtype=dtype),
        x0=jnp.full(n, 1.0, dtype=dtype))
    res = bis.solve(setup)   # warmup: compiles the fused inner solver
    log(f"[cg+mg tts] warmup: {res.solve_seconds:.3f}s total, "
        f"{res.iter_count} inner iters / {res.refine_outer_count} outers, "
        f"converged={res.converged}, ||r||={res.final_residual_norm:.3e}")
    log("[cg+mg tts] outer ||r|| trajectory: "
        + " ".join(f"{v:.3e}" for v in res.residual_norms))
    best = float("inf")
    for rep in range(args.repeats):
        res = bis.solve(setup)
        log(f"[cg+mg tts] measured[{rep}]: {res.solve_seconds:.3f}s, "
            f"{res.iter_count} inner iters / {res.refine_outer_count} "
            f"outers, ||r||={res.final_residual_norm:.3e}")
        best = min(best, res.solve_seconds)
    if not res.converged:
        raise RuntimeError(
            f"cg+mg+refine did not reach 1e-11*r0 "
            f"(||r||={res.final_residual_norm:.3e} vs "
            f"{res.stopping_criteria:.3e})")
    matrix_tag = args.matrix.replace(":", "_")
    return _record(f"cg_mg_refine_seconds_{matrix_tag}", best,
                   "seconds_to_1e-11_r0", 0.82)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="hpcg:128x128x128")
    ap.add_argument("--method", default="all",
                    choices=["all"] + sorted(METHOD_MAP))
    ap.add_argument("--iters", type=int, default=0,
                    help="measured iterations (0 = per-method default)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--matrix-dtype", default=None,
                    help="matrix data storage dtype (e.g. bfloat16); "
                         "default = --dtype")
    ap.add_argument("--format", default="auto",
                    choices=("auto", "dia", "stencil"),
                    help="device operator format for generator sources: "
                         "'stencil' = matrix-free constant-stencil kernel "
                         "(fastest for the generated benchmark matrices), "
                         "'dia' = explicit diagonal storage")
    ap.add_argument("--precond", default=None,
                    choices=sorted(PRECOND_CHOICES),
                    help="override the preconditioner for p* rows "
                         "(default: exact multicolor SGS)")
    ap.add_argument("--restart-length", type=int, default=50)
    ap.add_argument("--precond-inner-iters", type=int, default=1)
    ap.add_argument("--orthog", default="lowsync",
                    choices=("mgs", "cgs2", "lowsync"),
                    help="GMRES orthogonalization (lowsync = Gram-corrected "
                         "CGS2, two basis passes/iter; cgs2 = four)")
    ap.add_argument("--gmres-basis", default="bfloat16",
                    choices=("none", "bfloat16", "float32"),
                    help="GMRES basis storage dtype (bfloat16 halves the "
                         "basis stream; measured convergence-equivalent on "
                         "the benchmark matrices; 'none' = solve dtype)")
    ap.add_argument("--no-capacity-row", action="store_true",
                    help="skip the hpcg:256x256x256 capacity CG row")
    ap.add_argument("--no-general-row", action="store_true",
                    help="skip the general-sparsity (scattered-band, "
                         "lane-ELL kernel) CG row")
    ap.add_argument("--budget-secs", type=float,
                    default=float(os.environ.get(
                        "BIS_BENCH_BUDGET_SECS", "2400")),
                    help="wall-clock budget counted from process start "
                         "(build time included).  Optional rows "
                         "that no longer fit are skipped with a logged "
                         "note; the cumulative table + headline are "
                         "reprinted after every row so the output is "
                         "complete whenever the budget (or an external "
                         "timeout) cuts the run short.  0 = unlimited")
    ap.add_argument("--platform", default=None, choices=("cpu",),
                    help="'cpu' = rehearse the pipeline on the CPU; rows "
                         "then carry no rates")
    args = ap.parse_args()
    t_start = time.monotonic()
    deadline = (t_start + args.budget_secs) if args.budget_secs > 0 else None

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import basic_iterative_solvers_tpu as bis

    dev = device_info()
    log(f"device: {dev}")
    if dev["platform"] != "gpu" and args.platform != "cpu":
        raise SystemExit(f"bench.py measures on a GPU; JAX found "
                         f"{dev['platform']} (use --platform cpu to "
                         "rehearse without rates)")
    mat_dt = bis.SolverConfig(matrix_dtype=args.matrix_dtype,
                              dtype=np.dtype(args.dtype)).mat_dtype()

    if args.method != "all":
        A, is_gen = build_matrix(bis, args.matrix, args.format, mat_dt)
        print(json.dumps(run_one(bis, args.method, args, A, is_gen)),
              flush=True)
        return

    # Full table: every reference README row on the same matrix.  The
    # headline CG row runs FIRST; after EVERY row the cumulative
    # `bench_table` line and the headline line are REPRINTED so the
    # stdout tail always ends with a complete partial table followed by
    # the headline — the driver parses the FINAL line as the round's
    # metric, and an external timeout mid-row still leaves the previous
    # row's complete (table, headline) pair as the tail.
    all_records = []
    headline = None

    def flush_tail():
        print(json.dumps({"metric": "bench_table",
                          "value": len(all_records), "unit": "rows",
                          "rows": all_records},
                         separators=(",", ":")), flush=True)
        if headline is not None:
            print(json.dumps(headline), flush=True)

    def remaining():
        return float("inf") if deadline is None else deadline - time.monotonic()

    def fits(est_secs: float, label: str) -> bool:
        if remaining() >= est_secs:
            return True
        log(f"[budget] skipping {label}: ~{est_secs:.0f}s estimated, "
            f"{max(0.0, remaining()):.0f}s left of {args.budget_secs:.0f}s")
        return False

    def row(label, est_secs, fn, *fargs, rename=None):
        """Run one optional row inside the budget; emit row + tail."""
        if not fits(est_secs, label):
            return
        try:
            rec = fn(*fargs)
            if rename:
                rec = rename(rec)
            all_records.append(rec)
            print(json.dumps(rec), flush=True)
        except Exception as e:  # keep the table going; record the failure
            log(f"[{label}] FAILED: {e}")
            all_records.append({"metric": f"{label}_FAILED", "value": None,
                                "unit": "ms_per_iter", "vs_baseline": None})
        flush_tail()

    A, is_gen = build_matrix(bis, args.matrix, args.format, mat_dt)

    # headline first — unconditionally (this is THE number of record)
    headline = run_one(bis, "cg", args, A, is_gen)
    all_records.append(headline)
    print(json.dumps(headline), flush=True)
    flush_tail()

    for key in ["jacobi", "gs", "sgs", "gmres", "bicgstab",
                "pcg", "pgmres", "pbicgstab"]:
        row(key, 45.0, run_one, bis, key, args, A, is_gen)

    def _rename(prefix):
        def f(rec):
            assert rec["metric"].startswith("pcg_")
            rec["metric"] = prefix + rec["metric"][len("pcg_"):]
            return rec
        return f

    import copy

    def with_precond(p, **over):
        a2 = copy.copy(args)
        a2.precond = p
        for k, v in over.items():
            setattr(a2, k, v)
        return a2

    # exact-ILU(0) flagship row: CG + multicolor incomplete-LU through the
    # superblock blocked trisolve (the reference can only apply ILU(0)
    # serially; baseline = its 105.3 ms preconditioned-CG row)
    if args.precond is None:
        row("pcg_ilu0", 60.0, run_one, bis, "pcg", with_precond("ilu0"),
            A, is_gen, rename=_rename("pcg_ilu0_"))

    # multigrid rows (stencil-capable generator sources only): pcg_mg =
    # per-iteration rate of CG + V-cycle vs the reference's PCG row;
    # cg_mg_refine = TOTAL time-to-solution to 1e-11*r0 (the deepest
    # TRUE-residual accuracy reachable in fp64 with margin; see
    # run_mg_tts) — the metric multigrid exists for (grid-independent
    # iteration counts make it the fastest path to high accuracy)
    if args.precond is None and bis.stencil_op.stencil_buildable(args.matrix):
        row("pcg_mg", 60.0, run_one, bis, "pcg", with_precond("mg"),
            A, is_gen, rename=_rename("pcg_mg_"))
        row("cg_mg_refine", 90.0, run_mg_tts, bis, args, A)

    # capacity rows: 56.6M-row CG on one chip — 27x the reference's
    # benchmark size (it never showed anything beyond 2.1M rows) — and
    # EXACT incomplete-LU preconditioned CG at that size / 1.5G nnz,
    # possible only because the translation-table builder
    # (ops/block_trisolve.build_superblock_ilu0_pair_stencil) factors a
    # tiny prototype on host and gathers the factor planes on device.
    # The 384^3 operator is built ONCE and shared by both rows.
    if not args.no_capacity_row and args.matrix == "hpcg:128x128x128":
        A384 = None
        if fits(150.0, "cg@384 (build+row)"):
            try:
                A384, _ = build_matrix(bis, "hpcg:384x384x384",
                                       args.format, mat_dt)
            except Exception as e:
                log(f"[384^3 build] FAILED: {e}")
        if A384 is not None:
            a2 = copy.copy(args)
            a2.matrix, a2.iters = "hpcg:384x384x384", 150
            row("cg@384", 90.0, run_one, bis, "cg", a2, A384, True)
            if args.precond is None:
                a3 = copy.copy(a2)
                a3.iters, a3.precond = 100, "ilu0"
                row("pcg_ilu0@384", 180.0, run_one, bis, "pcg", a3,
                    A384, True, rename=_rename("pcg_ilu0_"))
            del A384

    # general-sparsity row: CG on a scattered-band matrix (~800 distinct
    # diagonals at 1.9% fill — DIA-ineligible, the reference's arbitrary-CSR
    # native_spmv case) in the windowed lane-ELL format (ops/lane_ell.py);
    # vs_baseline compares against the SAME solve in plain ELL.
    if not args.no_general_row:
        row("cg@sband", 150.0, run_general_row, bis, args)

    log(f"[budget] done: {time.monotonic() - t_start:.0f}s of "
        f"{args.budget_secs:.0f}s used, {len(all_records)} rows")
    flush_tail()


if __name__ == "__main__":
    main()
