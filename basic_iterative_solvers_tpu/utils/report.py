"""Result reporting.

Output-shape analog of the reference postprocessing
(reference postprocessing.hpp:8-68): per-sample residual-norm table
with per-iteration times, then a convergence summary naming solver,
preconditioner, iteration count, stopping criterion and final residual.
Plus the roofline accounting that replaces LIKWID hardware counters.
"""
from __future__ import annotations

import sys

import numpy as np

from ..types import PrecondType, SolverType, to_string


def print_residuals(result, out=None) -> None:
    """Residual Norms / Time for iteration table
    (reference print_residuals, postprocessing.hpp:8-30)."""
    out = sys.stdout if out is None else out  # resolve at call time
    norms = result.residual_norms
    times = result.time_per_iteration
    k = result.res_check_len
    print(f"\n{'':15}Residual Norms{'':27}Time for iteration", file=out)
    print("+" + "-" * 42 + "+" + " " * 8 + "+" + "-" * 25 + "+", file=out)
    for i, rn in enumerate(norms):
        line = f"||A*x_{i * k} - b||_2 = {rn:.16e}"
        if i > 0 and i < len(times):
            line += f"{times[i]:>25.6f}[s]"
        print(line, file=out)
    if getattr(result, "uniform_iteration_times", False):
        print("(fused harness: per-iteration times are the solve-average — "
              "the whole solve is one device dispatch)", file=out)


def summary_output(result, out=None) -> None:
    """Convergence summary (reference summary_output,
    postprocessing.hpp:33-68)."""
    out = sys.stdout if out is None else out  # resolve at call time
    print_residuals(result, out)
    iter_count = result.iter_count
    if result.method == SolverType.GMRES:
        # restarts count as iterations in the summary (postprocessing.hpp:39-40)
        iter_count += result.gmres_restart_count
    name = to_string(result.method)
    if result.method == SolverType.GMRES:
        name += f"({result.restart_length})"
    line = f"\nSolver: {name}"
    if result.preconditioner not in (None, PrecondType.NONE):
        line += f" with preconditioner: {to_string(result.preconditioner)}"
    if result.converged:
        line += f" converged in: {iter_count} iterations."
    else:
        line += f" did not converge after {iter_count} iterations."
    print(line, file=out)
    print('With the stopping criteria "tol * ||Ax_0 - b||_2" is: '
          f"{result.stopping_criteria:.16e}", file=out)
    print("The residual of the final iteration is: ||A*x_star - b||_2 = "
          f"{result.final_residual_norm:.16e}.", file=out)


#: Published peaks per accelerator, keyed by `jax.Device.device_kind`.
#: A device kind missing here is an error, never a default: a roofline
#: divided by another machine's peak is meaningless.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "l2_bytes": 50 * 1024 * 1024,
        "source": "NVIDIA H100 Tensor Core GPU datasheet, SXM5: "
                  "3.35 TB/s HBM3, 50 MB L2",
    },
}


def device_peaks(device_kind: str) -> dict:
    """The DEVICE_PEAKS entry for `device_kind`; KeyError when unknown."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            "to utils/report.py DEVICE_PEAKS with its source") from None


def iteration_traffic_bytes(setup) -> int:
    """Estimated HBM bytes moved per solver iteration: SpMV streams plus
    every vector pass of the method recurrence and its preconditioner.

    The reference's LIKWID markers count only the three sparse kernels
    (kernels.hpp:25-40); a bandwidth-bound solver's true per-iteration
    traffic includes all the BLAS-1 passes too, so the roofline is computed
    against the total.  Pass counts are static estimates from the method
    recurrences (methods/{cg,jacobi,gmres,bicgstab}.hpp)."""
    from ..device_matrix import device_matrix_nnz_bytes
    from ..precond import estimated_precond_passes

    config = setup.config
    itemsize = np.dtype(setup.dtype).itemsize
    vec = setup.b.size * itemsize              # one full vector pass
    spmv = device_matrix_nnz_bytes(setup.A) + 2 * vec   # read x, write y

    # (n_spmv, n_vector_passes, n_precond_applies) per iteration
    shapes = {
        SolverType.JACOBI: (1, 5, 0),          # x_new, normalize, sample dot
        SolverType.GAUSS_SEIDEL: (2, 4, 0),    # U_strict·x + level solve
        SolverType.SYMMETRIC_GAUSS_SEIDEL: (4, 8, 0),
        SolverType.CONJUGATE_GRADIENT: (1, 10, 1),   # 3 dots + 3 axpys
        SolverType.BICGSTAB: (2, 16, 2),
        SolverType.GMRES: (1, 4, 1),           # + basis streaming below
    }
    n_spmv, n_vec, n_prec = shapes[config.method]
    if (getattr(setup, "gs_L_block", None) is not None
            and config.method in (SolverType.GAUSS_SEIDEL,
                                  SolverType.SYMMETRIC_GAUSS_SEIDEL)):
        # blocked residual-form sweep: ONE residual SpMV (the carried
        # residual feeds both the sweep and the sampled norm) + the
        # blocked trisolve passes (const mode → window/vector passes only)
        from ..precond import Preconditioner, estimated_precond_passes
        from ..types import PrecondType
        sym = config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL
        Mb = Preconditioner(
            ptype=(PrecondType.SYMMETRIC_GAUSS_SEIDEL if sym
                   else PrecondType.GAUSS_SEIDEL),
            outer_iters=1, inner_iters=1,
            L_block=setup.gs_L_block, U_block=setup.gs_U_block)
        return int(spmv + (4 + estimated_precond_passes(Mb)) * vec)
    if setup.n_colors > 0 and config.method in (
            SolverType.GAUSS_SEIDEL, SolverType.SYMMETRIC_GAUSS_SEIDEL):
        # colored sweeps: one SpMV + one masked update per color per sweep
        steps = setup.n_colors
        sweeps = 2 if config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL else 1
        n_spmv = sweeps * steps + 1                   # +1 explicit sample
        n_vec = 3 * sweeps * steps + 2
    total = n_spmv * spmv + n_vec * vec
    if config.method == SolverType.GMRES:
        # basis streaming: passes over the ~(j+1)-row active basis per
        # iteration — lowsync 2, cgs2 4, mgs 2 (dot + axpy per row);
        # average j over a restart cycle = m/2.  Basis rows may be stored
        # narrower than the solve dtype (gmres_basis_dtype).
        m = config.restart_length
        passes = {"lowsync": 2, "cgs2": 4, "mgs": 2}[config.orthog_mode]
        bd = config.gmres_basis_dtype
        bvec = vec if bd is None else setup.b.size * 2 \
            if str(bd) in ("bfloat16", "bf16") else \
            setup.b.size * np.dtype(bd).itemsize
        total += passes * (m / 2 + 1) * bvec
    total += n_prec * estimated_precond_passes(setup.M) * vec
    return int(total)


def roofline_report(setup, result, out=None,
                    secs_per_iter: float = None) -> None:
    """Per-solve achieved-bandwidth estimate vs the device's published HBM
    peak — the analog of the reference's LIKWID counters (SURVEY.md §5).
    Counts TOTAL per-iteration traffic (SpMV + every vector pass) and
    prints the achieved fraction.  The peak comes from DEVICE_PEAKS by the
    device kind; a CPU run prints no rate.  `secs_per_iter` overrides the
    solve-wall average (--iter-times passes the traced device-wall median
    there)."""
    import jax
    out = sys.stderr if out is None else out  # resolve at call time
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("[roofline] not measured: cpu run", file=out)
        return
    peaks = device_peaks(dev.device_kind)
    hbm_gbps = peaks["hbm_gbps"]
    iters = max(1, result.iter_count)
    secs = (result.solve_seconds / iters if secs_per_iter is None
            else secs_per_iter)
    traffic = iteration_traffic_bytes(setup)
    floor_ms = traffic / (hbm_gbps * 1e9) * 1e3
    achieved_gbps = traffic / max(secs, 1e-12) / 1e9
    pct = 100.0 * achieved_gbps / hbm_gbps
    vec = setup.b.size * np.dtype(setup.dtype).itemsize
    l2 = peaks["l2_bytes"]
    note = (f"; one vector {vec / 1e6:.1f} MB vs {l2 / 2**20:.0f} MB L2 — "
            + ("vectors can stay L2-resident, rates above the HBM peak "
               "are possible" if 4 * vec <= l2 else "HBM-bound"))
    print(f"[roofline] {dev.device_kind}: {iters} iters, "
          f"{secs * 1e3:.4f} ms/iter; est. traffic {traffic / 1e6:.1f} "
          f"MB/iter -> {achieved_gbps:.0f} GB/s achieved = {pct:.0f}% of "
          f"the {hbm_gbps:.0f} GB/s published HBM peak (floor "
          f"{floor_ms:.4f} ms/iter){note}", file=out)


def print_kernel_report(timers, result=None, out=None) -> None:
    """Hierarchical per-kernel timer table — the reference's print_timers
    (/root/reference/utilities/utilities.hpp:154-324): phase rows indented
    with their kernel children (spmv/precond/sptrsv/dot/norm/sum and the
    GMRES orthog/least_sq/update_g sections).  Kernel rows appear when the
    host harness ran with kernel_timers (utils/ktimers.py)."""
    out = sys.stderr if out is None else out
    names = set(timers.names())

    def g(n):
        return timers[n].check() if n in names else None

    rows = [(0, "total"), (1, "read_matrix"), (1, "preprocessing")]
    rows += [(2, n) for n in timers.names()
             if n.startswith("preprocessing_")]
    rows += [(1, "solve"),
             (2, "spmv"), (2, "precond"), (3, "sptrsv"),
             (2, "orthog"), (2, "least_sq"), (2, "update_g"),
             (2, "dot"), (2, "norm"), (2, "sum"),
             (1, "postprocessing")]
    width = 44
    lines = ["+" + "-" * (width + 14) + "+"]
    for depth, name in rows:
        v = g(name)
        if v is None:
            continue
        label = "| " * depth + name
        lines.append(f"| {label:<{width}} {v:10.6f} s |")
    lines.append("+" + "-" * (width + 14) + "+")
    print("\n".join(lines), file=out)
