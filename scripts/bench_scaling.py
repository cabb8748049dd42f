#!/usr/bin/env python3
"""Weak-scaling benchmark: row-sharded CG over an N-device mesh.

Targets the BASELINE.md north star (≥70% nnz/s weak-scaling efficiency from
one device upward).  Each device owns a fixed per-device problem slab (HPCG
stencil planes), so the global problem grows with the mesh; reported
efficiency = (time at 1 device) / (time at N devices) for the per-device-
constant workload.

On a multi-GPU host this measures halo-exchange overlap over the GPUs'
links.  With --cpu it runs on 8 virtual CPU devices
(--xla_force_host_platform_device_count) and checks the sharded path's
function only: its rows carry no rates.  Without --cpu it refuses to run
anywhere but on GPUs.

    python scripts/bench_scaling.py [--devices 1 2 4] [--per-device-nz 16]
                                    [--nx 128] [--iters 50] [--mode gspmd]
"""
import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Virtual devices must be configured before JAX initializes.
if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--per-device-nz", type=int, default=16,
                    help="z-planes of the HPCG grid per device")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--mode", choices=("gspmd", "shard_map"),
                    default="gspmd",
                    help="gspmd = XLA-partitioned fused solve; "
                         "shard_map = the hand-written ShardedCG")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU with 8 virtual devices")
    ap.add_argument("--flavor", choices=("classic", "pipelined"),
                    default="classic",
                    help="CG recurrence: pipelined = single fused "
                         "reduction point/iter (latency-bound mesh mode)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.parallel import (make_mesh,
                                                      make_sharded_cg,
                                                      shard_setup)

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu" and not args.cpu:
        raise SystemExit(f"bench_scaling measures on GPUs; JAX found "
                         f"{dev0.platform} (use --cpu to rehearse)")
    n_avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]
    log(f"device={dev0.device_kind} devices={n_avail} counts={counts}")

    results = []
    for nd in counts:
        nz = args.per_device_nz * nd

        def build_dia():
            return bis.dia.stencil_27pt_device(args.nx, args.nx, nz,
                                               dtype=np.float32)

        mesh = make_mesh(nd)
        cfg = bis.SolverConfig(
            method=bis.SolverType.CONJUGATE_GRADIENT,
            preconditioner=bis.PrecondType.JACOBI, dtype=np.float32,
            harness="fused", max_iters=args.iters, tolerance=0.0,
            cg_flavor=args.flavor)
        if args.mode == "gspmd":
            A = build_dia()
            setup = shard_setup(bis.preprocessing_device(A, cfg), mesh)
            from basic_iterative_solvers_tpu.solvers import make_method
            method = make_method(setup)
            bis.solve(setup, method=method)          # compile
            t0 = time.perf_counter()
            res = bis.solve(setup, method=method)
            dt = res.solve_seconds / max(1, res.iter_count)
        else:
            from basic_iterative_solvers_tpu.dia import dia_split
            A = build_dia()
            _, _, _, D_inv = dia_split(A)
            b = jnp.full(A.n_rows, 1.0, dtype=jnp.float32)
            cg = make_sharded_cg(A, b, mesh, D_inv=D_inv)
            state = cg.init_state(cg.b * 0.0)
            step = jax.jit(cg.step_fn())
            state = jax.block_until_ready(step(state))  # compile
            t0 = time.perf_counter()
            for _ in range(args.iters):
                state = step(state)
            jax.block_until_ready(state)
            dt = (time.perf_counter() - t0) / args.iters
        n_rows = args.nx * args.nx * nz
        # true nonzeros, comparable with the BASELINE.md nnz/s north star
        nnz_rate = 27.0 * n_rows / dt
        results.append((nd, n_rows, dt, nnz_rate))
        log(f"devices={nd} rows={n_rows} {dt*1e3:.3f} ms/iter "
            f"{nnz_rate/1e9:.2f} Gnnz/s")

    base = results[0]
    metric = f"cg_weak_scaling_{args.mode}"
    if args.flavor != "classic":
        metric += f"_{args.flavor}"
    cpu = dev0.platform == "cpu"
    print(json.dumps({
        "metric": metric,
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": n_avail},
        "per_device_rows": args.nx * args.nx * args.per_device_nz,
        "points": [{"devices": nd, "rows": rows,
                    "ms_per_iter": None if cpu else dt * 1e3,
                    "gnnz_per_s": None if cpu else rate / 1e9,
                    "efficiency": None if cpu else base[2] / dt}
                   for (nd, rows, dt, rate) in results]}))


if __name__ == "__main__":
    main()
