"""Command-line driver.

Mirrors the reference CLI (/root/reference/utilities/utilities.hpp:12-108
and main.cpp:17-100):

    python -m basic_iterative_solvers_tpu <matrix> <method-flag> [options]

    <matrix>        .mtx path or generator spec (hpcg:NxNxN, fdm:N,
                    scamac:Anderson,Lx=..,..., band:N,B)
    method flags    -j | -gs | -sgs | -cg | -gm | -bi
    -p <type>       preconditioner: j gs bgs sgs 2st s2st ilu0 cheby mg
                    (cheby = Chebyshev polynomial, communication-free;
                    --cheby-degree K --cheby-ratio R tune it;
                    mg = geometric-multigrid V-cycle over the stencil
                    hierarchy — grid-independent CG iteration counts;
                    --mg-levels L --mg-smooth K --mg-coarse K
                    --mg-transfer linear|injection tune it)
    -rl <int>       GMRES restart length (default 10)
    -scale <0|1>    symmetric diagonal equilibration
    -perm <mode>    matrix reordering: none|bfs|rcm|color|color_bal
                    (SMAX PERM_MODE analog; color* = greedy coloring)
    --gs-mode m     exact GS sweeps: auto|levels|colored (coloring.py)
    --kernel-timers per-kernel TIME attribution + hierarchical timer table
                    (reference TIME(timers->spmv, ...); forces host harness)

Extras (the reference's CMake-time knobs, collapsed to runtime):
    --dtype float32|float64   (default: f32 on an accelerator, f64 on CPU)
    --matrix-dtype bfloat16   matrix-data storage dtype (default: --dtype)
    --harness host|fused      (default fused on an accelerator, host on CPU)
    --format auto|dia|lane_ell|ell|stencil
    --orthog mgs|cgs2|lowsync   GMRES orthogonalization scheme
    --cg-flavor classic|pipelined  pipelined = the alpha/beta reductions
                                overlap the SpMV (multi-chip latency mode)
    --cg-rr N       pipelined-CG residual-replacement backstop period
                    (default 25; 0 disables replacement entirely —
                    attainable accuracy then stalls ~2-3 decades above
                    classic's)
    --cg-rr-theta T pipelined-CG flying-restart trigger: replace when the
                    recurrence norm drops below T x its max since the
                    last replacement (default 0.03)
    --refine K      mixed-precision iterative refinement: up to K outer
                    float64 correction steps around the configured
                    (f32/bf16) solver — reference-grade fp64 convergence
                    at perf-mode streaming rates
    --refine-inner-tol T   inner relative reduction per outer (default 1e-6)
    --gmres-basis DT            GMRES basis storage dtype (e.g. bfloat16)
    --iter-times                measured per-iteration DEVICE walls for the
                                fused harness (xprof trace segmentation —
                                the reference's time_per_iteration[])
    --dump-matrix PATH          write the solve-ordering matrix as .mtx
                                (the reference's OUTPUT_SPARSITY toggle,
                                CMakeLists.txt:33 — dead there, live here)
    --max-iters N --tol T --inner K --outer K
"""
from __future__ import annotations

import sys

import numpy as np

from .config import SolverConfig
from .types import PRECOND_CLI_NAMES, SOLVER_CLI_FLAGS, PrecondType
from .utils.timers import Timers


def parse_cli(argv, bench_mode: bool = False) -> tuple:
    """`bench_mode` mirrors the reference parser's benchmark-harness
    variant (/root/reference/utilities/utilities.hpp:12-108): the method
    flag is NOT consumed from argv (a harness embedding this parser
    supplies the method itself), so argv is `<matrix> [options...]`.
    Parity surface only — the in-tree bench.py uses its own argparse."""
    min_args = 1 if bench_mode else 2
    if len(argv) < min_args:
        print("ERROR: parse_cli: Not enough arguments given. A call should "
              "contain:\n  python -m basic_iterative_solvers_tpu "
              "<matrix> <method> [extra_features]", file=sys.stderr)
        raise SystemExit(2)
    matrix_source = argv[0]
    if bench_mode:
        opts = dict(preconditioner=PrecondType.NONE)
        extras = {}
        args = list(argv[1:])
    else:
        method_flag = argv[1]
        if method_flag not in SOLVER_CLI_FLAGS:
            print("ERROR: parse_cli: Please choose an available solver:"
                  "\n-j (Jacobi)\n-gs (Gauss-Seidel)"
                  "\n-sgs (Symmetric Gauss-Seidel)"
                  "\n-gm ([Preconditioned] GMRES)"
                  "\n-cg ([Preconditioned] Conjugate Gradient)"
                  "\n-bi ([Preconditioned] BiCGSTAB)", file=sys.stderr)
            raise SystemExit(2)
        opts = dict(method=SOLVER_CLI_FLAGS[method_flag],
                    preconditioner=PrecondType.NONE)
        extras = {}
        args = list(argv[2:])
    idx = 0
    while idx < len(args):
        arg = args[idx]

        def need_value():
            nonlocal idx
            if idx + 1 >= len(args):
                print(f"ERROR: parse_cli: option {arg} needs a value",
                      file=sys.stderr)
                raise SystemExit(2)
            idx += 1
            return args[idx]

        if arg == "-p":
            val = need_value()
            if val not in PRECOND_CLI_NAMES:
                print("ERROR: assign_cli_inputs: Please choose an available "
                      "preconditioner type:\n-p j (Jacobi)\n-p gs "
                      "(Gauss-Seidel)\n-p bgs (Backwards Gauss-Seidel)"
                      "\n-p sgs (Symmetric Gauss-Seidel)"
                      "\n-p 2st (2 Stage Gauss-Seidel)"
                      "\n-p s2st (Symmetric 2 Stage Gauss-Seidel)"
                      "\n-p ilu0 (Incomplete LU with 0 fill-in)"
                      "\n-p cheby (Chebyshev polynomial)"
                      "\n-p mg (Geometric multigrid V-cycle)",
                      file=sys.stderr)
                raise SystemExit(2)
            opts["preconditioner"] = PRECOND_CLI_NAMES[val]
        elif arg == "-rl":
            opts["restart_length"] = int(need_value())
        elif arg == "-scale":
            opts["num_scale"] = bool(int(need_value()))
        elif arg == "-perm":
            opts["perm_mode"] = need_value()
        elif arg == "--gs-mode":
            extras["gs_mode"] = need_value()
        elif arg == "--orthog":
            extras["orthog_mode"] = need_value()
        elif arg == "--cg-flavor":
            extras["cg_flavor"] = need_value()
        elif arg == "--cg-rr":
            extras["cg_rr_period"] = int(need_value())
        elif arg == "--cg-rr-theta":
            extras["cg_rr_theta"] = float(need_value())
        elif arg == "--cheby-degree":
            extras["cheby_degree"] = int(need_value())
        elif arg == "--cheby-ratio":
            extras["cheby_eig_ratio"] = float(need_value())
        elif arg == "--mg-levels":
            extras["mg_levels"] = int(need_value())
        elif arg == "--mg-smooth":
            extras["mg_smooth_degree"] = int(need_value())
        elif arg == "--mg-coarse":
            extras["mg_coarse_degree"] = int(need_value())
        elif arg == "--mg-transfer":
            extras["mg_transfer"] = need_value()
        elif arg == "--mg-coarse-op":
            extras["mg_coarse_op"] = need_value()
        elif arg == "--refine":
            extras["refine_outer"] = int(need_value())
        elif arg == "--refine-inner-tol":
            extras["refine_inner_tol"] = float(need_value())
        elif arg == "--gmres-basis":
            extras["gmres_basis_dtype"] = need_value()
        elif arg == "--dtype":
            extras["dtype"] = np.dtype(need_value())
        elif arg == "--matrix-dtype":
            extras["matrix_dtype"] = need_value()
        elif arg == "--harness":
            extras["harness"] = need_value()
        elif arg == "--format":
            extras["matrix_format"] = need_value()
        elif arg == "--max-iters":
            extras["max_iters"] = int(need_value())
        elif arg == "--tol":
            extras["tolerance"] = float(need_value())
        elif arg == "--inner":
            extras["precond_inner_iters"] = int(need_value())
        elif arg == "--outer":
            extras["precond_outer_iters"] = int(need_value())
        elif arg == "--platform":
            extras["platform"] = need_value()
        elif arg == "--profile":
            extras["profile_dir"] = need_value()
        elif arg == "--debug-checks":
            extras["debug_checks"] = True
        elif arg == "--kernel-timers":
            extras["kernel_timers"] = True
        elif arg == "--iter-times":
            extras["iter_times"] = True
        elif arg == "--dump-matrix":
            extras["dump_matrix"] = need_value()
        else:
            # reference behavior: warn, continue (utilities.hpp:103-106)
            print(f'ERROR: assign_cli_inputs: Argument "{arg}" not '
                  "recognized.", file=sys.stderr)
        idx += 1
    # --kernel-timers: the host harness attributes via eager stopwatch
    # splits (utils/ktimers.py); the fused harness is ONE device dispatch,
    # so attribution comes from a traced re-run's device op walls bucketed
    # per phase (utils/xprof.py print_phase_table) — no override needed.
    return matrix_source, opts, extras


def run(argv=None) -> int:
    """Phase-structured pipeline: parse → read/generate → preprocess → solve
    → postprocess (reference main.cpp:17-100)."""
    import jax

    argv = sys.argv[1:] if argv is None else argv
    matrix_source, opts, extras = parse_cli(argv)

    # --platform must act before the first backend query.
    platform = extras.pop("platform", None)
    if platform:
        jax.config.update("jax_platforms", platform)

    not_cpu = jax.default_backend() != "cpu"
    if "dtype" not in extras:
        extras["dtype"] = np.dtype(np.float32 if not_cpu else np.float64)
    if "harness" not in extras:
        extras["harness"] = "fused" if not_cpu else "host"
    profile_dir = extras.pop("profile_dir", None)
    iter_times = extras.pop("iter_times", False)
    dump_matrix = extras.pop("dump_matrix", None)
    config = SolverConfig(**opts, **extras)
    if config.color_spec is None:
        # structural coloring for generator sources → blocked multicolor
        # trisolves where eligible (ops/block_trisolve.py)
        from .generators import color_spec_for_source
        config.color_spec = color_spec_for_source(matrix_source)

    from . import generators
    from .solvers import preprocessing, preprocessing_device, solve
    from .utils.report import roofline_report, summary_output

    # Generator specs build on-device (no O(nnz) host passes) whenever the
    # method/preconditioner don't need the host CSR (exact triangular
    # solves, reordering); file sources and those cases use the host path.
    from .dia import from_source_device
    from .precond import (COLORED_PRECONDS, DEVICE_NATIVE_PRECONDS,
                          resolve_gs_mode)
    from .types import SolverType as _ST
    # -p mg lives on the matrix-free stencil path; pick it automatically
    # for stencil-capable generator sources so plain `hpcg:... -cg -p mg`
    # works (an explicit --format wins).
    if (config.preconditioner == PrecondType.MULTIGRID
            and config.matrix_format == "auto"):
        from .stencil_op import stencil_buildable
        if stencil_buildable(matrix_source):
            config.matrix_format = "stencil"
    colored = resolve_gs_mode(config, device_native=True) == "colored"
    # exact ILU(0) goes device-native for constant-stencil sources under a
    # grid coloring (translation-table factors, zero host-CSR setup —
    # ops/block_trisolve.build_superblock_ilu0_pair_stencil); it needs the
    # matrix-free stencil operator, so auto-pick that format like -p mg
    ilu0_stencil = False
    if (config.preconditioner == PrecondType.ILU0 and colored
            and config.perm_mode == "none"
            and config.matrix_format in ("auto", "stencil")
            and generators.device_buildable(matrix_source)):
        from .stencil_op import stencil_buildable
        if stencil_buildable(matrix_source):
            from .coloring import spec_for_device
            from .ops.block_trisolve import stencil_ilu0_eligible
            from .stencil_op import from_source_operator as _fso
            try:
                _op = _fso(matrix_source, dtype=config.mat_dtype())
                ilu0_stencil = stencil_ilu0_eligible(_op,
                                                     spec_for_device(_op))
            except ValueError:
                pass
    if ilu0_stencil and config.matrix_format == "auto":
        config.matrix_format = "stencil"
    device_path = (
        generators.device_buildable(matrix_source)
        and (config.preconditioner in DEVICE_NATIVE_PRECONDS
             or (config.preconditioner in COLORED_PRECONDS and colored)
             or ilu0_stencil)
        and (config.method not in (_ST.GAUSS_SEIDEL,
                                   _ST.SYMMETRIC_GAUSS_SEIDEL) or colored)
        and config.perm_mode == "none"
        and not (config.num_scale and config.matrix_format == "stencil")
        and config.matrix_format in ("auto", "dia", "stencil"))

    if config.matrix_format == "stencil" and not device_path:
        # the matrix-free format only exists on the device-native path;
        # fall back to DIA with a note instead of a confusing failure later
        print("NOTE: --format stencil requires a generator source and a "
              "device-native method/preconditioner; falling back to DIA.",
              file=sys.stderr)
        import dataclasses as _dc
        config = _dc.replace(config, matrix_format="auto")

    timers = Timers()
    with timers.time("total"):
        if device_path:
            with timers.time("read_matrix"):
                if config.matrix_format == "stencil":
                    from .stencil_op import from_source_operator
                    A_dev = from_source_operator(matrix_source,
                                                 dtype=config.mat_dtype())
                else:
                    A_dev = from_source_device(matrix_source,
                                               dtype=config.mat_dtype())
            with timers.time("preprocessing"):
                setup = preprocessing_device(A_dev, config, timers=timers)
        else:
            with timers.time("read_matrix"):
                A = generators.from_source(matrix_source)
            with timers.time("preprocessing"):
                setup = preprocessing(A, config, timers=timers)
        if dump_matrix:
            # OUTPUT_SPARSITY analog (/root/reference/CMakeLists.txt:33;
            # the macro is defined but dead in the reference — here the
            # toggle actually writes the solve-ordering matrix as .mtx
            # for external sparsity inspection).  Device-built operators
            # dump from the host oracle when one exists.
            from .io.mmio import write_mtx
            if getattr(setup, "A_host", None) is not None:
                write_mtx(dump_matrix, setup.A_host,
                          comment=f"solve-ordering matrix for "
                                  f"{matrix_source}")
            else:
                write_mtx(dump_matrix,
                          generators.from_source(matrix_source),
                          comment=f"generator matrix {matrix_source} "
                                  "(natural ordering)")
            print(f"wrote {dump_matrix}", file=sys.stderr)
        # Mid-run milestone dumps at relative residuals 1e-3/1e-6 (host
        # harness; reference solver_harness.hpp:27-37).
        def milestone(iter_count, residual_norm):
            print(f"[milestone] iter {iter_count}: ||r|| = "
                  f"{residual_norm:.6e}", file=sys.stderr)
            print(timers.report(), file=sys.stderr)

        from .solvers import make_method
        method = make_method(setup)
        with timers.time("solve"):
            if profile_dir:
                # xprof device trace around the solve — the hardware-counter
                # analog of the reference's LIKWID markers (SURVEY.md §5);
                # inspect with tensorboard/xprof.
                with jax.profiler.trace(profile_dir):
                    result = solve(setup, method=method, timers=timers,
                                   progress=milestone)
                print(f"[profile] trace written to {profile_dir}",
                      file=sys.stderr)
            else:
                result = solve(setup, method=method, timers=timers,
                               progress=milestone)
        roofline_secs = None
        if iter_times:
            # measured per-iteration DEVICE walls: re-run the compiled
            # fused loop under a trace and segment the op timeline
            # (utils/xprof.py — the reference's time_per_iteration[],
            # solver.hpp:166-171, without host-dispatch pollution)
            if config.harness == "fused":
                from .utils.xprof import attach_iteration_times
                if attach_iteration_times(result, method):
                    print("[iter-times] measured device walls attached",
                          file=sys.stderr)
                    import numpy as _np
                    walls = _np.asarray(result.time_per_iteration)
                    walls = walls[walls > 0]
                    if walls.size:
                        roofline_secs = float(_np.median(walls))
                else:
                    print("[iter-times] no device trace available on this "
                          "backend; times unchanged", file=sys.stderr)
            else:
                print("[iter-times] host harness already records wall "
                      "times per iteration", file=sys.stderr)
        with timers.time("postprocessing"):
            summary_output(result)
            roofline_report(setup, result, secs_per_iter=roofline_secs)
    if config.kernel_timers:
        if config.harness == "fused":
            # per-phase DEVICE attribution for the single-dispatch loop:
            # traced re-run of the compiled executable, op walls bucketed
            # by kernel name (reference table: utilities.hpp:154-324)
            from .utils.xprof import measure_phase_table, print_phase_table
            got = measure_phase_table(method)
            if got is None:
                print("[kernel-timers] no device trace on this backend; "
                      "use --harness host for stopwatch attribution",
                      file=sys.stderr)
            else:
                print_phase_table(*got, n_iters=result.iter_count or None)
        else:
            from .utils.report import print_kernel_report
            print_kernel_report(timers, result)
    else:
        print(timers.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
