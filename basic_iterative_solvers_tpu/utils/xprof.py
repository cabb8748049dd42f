"""Measured per-iteration device walls from a profiler trace.

The reference records `time_per_iteration[]` with a running stopwatch split
around each host-driven iteration (reference solver.hpp:166-171, printed
per sample in postprocessing.hpp:8-30).  The fused harness is ONE device
dispatch, so host walls can't see iteration boundaries.

This module recovers measured per-iteration times by running the compiled
fused loop once under `jax.profiler.trace` and segmenting the device op
timeline on its periodic structure: every op inside the `lax.while_loop`
body executes exactly once per iteration, so successive start times of any
body op mark iteration boundaries.  The marker op is chosen automatically
(the most frequent op name on the device timeline).  The trace is read
with `jax.profiler.ProfileData` from the `*.xplane.pb` file: the first
accelerator plane (`/device:GPU:0`), its "XLA Ops" line when the trace has
one, else the union of its "Stream #…" lines (one event per kernel).
Tracing adds overhead to the traced run (it is NOT used for the headline
ms/iter numbers — those come from untraced walls); the per-iteration SHAPE
(e.g. GMRES's within-cycle growth) is what this recovers.
"""
from __future__ import annotations

import collections
import glob
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

#: (name, start_ns, duration_ns) of one device op
Op = Tuple[str, float, float]


def device_ops(profile) -> List[Op]:
    """Device op events of the first accelerator plane of a
    `jax.profiler.ProfileData`, sorted by start; [] when there is none."""
    for plane in profile.planes:
        name = plane.name
        if not name.startswith("/device:") or "CPU" in name:
            continue
        lines = list(plane.lines)
        chosen = [ln for ln in lines if ln.name == "XLA Ops"]
        if not chosen:
            chosen = [ln for ln in lines if ln.name.startswith("Stream")]
        ops = [(e.name, float(e.start_ns), float(e.duration_ns))
               for ln in chosen for e in ln.events]
        if ops:
            ops.sort(key=lambda o: o[1])
            return ops
    return []


def _load_device_ops(logdir: str) -> List[Op]:
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not files:
        return []
    return device_ops(ProfileData.from_file(files[-1]))


def iteration_times_from_ops(ops: List[Op], n_iters: Optional[int] = None):
    """Per-iteration device walls (seconds) from sorted device ops, or None
    when the timeline has no periodic marker.

    When `n_iters` is given, only marker ops occurring exactly that many
    times qualify (guards against fusions duplicated by unrolling)."""
    if not ops:
        return None
    # copies (the while-loop predicate's device-to-host copy among them)
    # are not body ops of a fixed count; never pick one as the marker
    counts = collections.Counter(o[0] for o in ops
                                 if not o[0].lower().startswith("memcpy"))
    if not counts:
        return None
    if n_iters is not None:
        cands = [n for n, c in counts.items() if c == n_iters]
    else:
        top = max(counts.values())
        if top < 3:
            return None
        cands = [n for n, c in counts.items() if c == top]
    if not cands:
        return None
    # earliest-starting qualifying op = the body's first marker
    first_start = {}
    for name, t, _d in ops:
        if name in cands and name not in first_start:
            first_start[name] = t
    marker = min(cands, key=lambda n: first_start[n])
    starts = np.array([t for name, t, _d in ops if name == marker])
    if starts.size < 2:
        return None
    # iteration k = [start_k, start_{k+1}); the last iteration extends to
    # the end of the final event in the window
    end = max(t + d for _n, t, d in ops)
    return np.diff(np.append(starts, end)) * 1e-9


def iteration_times_from_trace(logdir: str,
                               n_iters: Optional[int] = None):
    """iteration_times_from_ops over the newest trace under `logdir`."""
    return iteration_times_from_ops(_load_device_ops(logdir), n_iters)


def measure_iteration_times(method, n_iters: Optional[int] = None,
                            logdir: Optional[str] = None):
    """Re-run a method's compiled fused loop under a profiler trace and
    return measured per-iteration device walls (seconds), or None.

    The method must have solved once in fused mode (so the runner and its
    executable exist); the traced run reuses them — no recompilation.
    """
    import jax
    runner = getattr(method, "_fused_runner", None)
    if runner is None:
        return None
    state0 = jax.block_until_ready(runner._init_jit())
    ctx = (tempfile.TemporaryDirectory() if logdir is None else None)
    d = ctx.name if ctx is not None else logdir
    try:
        with jax.profiler.trace(d):
            jax.block_until_ready(runner._run_jit(state0))
        times = iteration_times_from_trace(d, n_iters=n_iters)
    finally:
        if ctx is not None:
            ctx.cleanup()
    return times


def attach_iteration_times(result, method):
    """Fill result.time_per_iteration with measured device walls (the
    reference's genuinely-measured series, solver.hpp:166-171); returns
    True on success.  Only meaningful for res_check_len == 1 fused runs
    (one history sample per iteration)."""
    if result.res_check_len != 1:
        # the history has one row per res_check_len iterations — the
        # per-iteration slot mapping below would misattribute the walls
        return False
    times = measure_iteration_times(method, n_iters=result.iter_count)
    if times is None or times.size == 0:
        return False
    # history layout: [initial norm, one entry per iteration with an extra
    # entry after each completed restart cycle, final explicit]; map the
    # measured walls onto the per-ITERATION slots (restart rows stay 0)
    tpi = np.zeros_like(result.time_per_iteration)
    idx = np.arange(1, times.size + 1)
    slots = idx.copy()
    if result.gmres_restart_count > 0 and result.restart_length > 0:
        slots = idx + (idx - 1) // result.restart_length
    keep = slots < tpi.size - 1
    tpi[slots[keep]] = times[keep]
    result.time_per_iteration = tpi
    result.uniform_iteration_times = False
    return True


# ---------------------------------------------------------------------------
# Per-phase device-time attribution (reference print_timers analog for the
# fused harness, reference utilities/utilities.hpp:154-324)
# ---------------------------------------------------------------------------

#: op-name → phase buckets, by the kernel or HLO op name prefix.
PHASE_BUCKETS = (
    ("spmv", ("spmv_",)),
    ("sptrsv", ("sptrsv_",)),
    ("orthog", ("orthog_",)),
    ("layout_glue", ("reshape", "copy", "transpose", "bitcast", "pad",
                     "slice", "concatenate", "broadcast")),
    ("blas1", ("fusion", "loop_", "input_", "multiply", "add", "subtract",
               "divide", "dot", "gemv", "reduce", "rsqrt", "sqrt", "select",
               "compare", "maximum", "convert", "iota", "scatter",
               "dynamic")),
)


def bucket_of(op_name: str) -> str:
    for bucket, prefixes in PHASE_BUCKETS:
        for p in prefixes:
            if op_name.startswith(p):
                return bucket
    return "other"


def phase_table_from_trace(logdir: str):
    """Aggregate device op walls by phase bucket.

    Returns (table, meta): table maps bucket → seconds (device wall summed
    over ops), meta has 'device_wall' (first-op start → last-op end) and
    'n_ops'.  None when the trace has no usable device timeline."""
    ops = _load_device_ops(logdir)
    if not ops:
        return None
    table = collections.defaultdict(float)
    per_op = collections.defaultdict(float)
    t0 = min(t for _n, t, _d in ops)
    t1 = max(t + d for _n, t, d in ops)
    for name, _t, d in ops:
        if name.startswith("while"):        # the loop wrapper op overlaps
            continue                        # every body op — skip it
        table[bucket_of(name)] += d * 1e-9
        per_op[name] += d * 1e-9
    meta = {"device_wall": (t1 - t0) * 1e-9, "n_ops": len(ops),
            "per_op": dict(sorted(per_op.items(), key=lambda kv: -kv[1]))}
    return dict(table), meta


def measure_phase_table(method, logdir: Optional[str] = None):
    """Traced re-run of a method's compiled fused loop → per-phase device
    seconds (see phase_table_from_trace); None without a device trace or
    a compiled runner."""
    import jax
    runner = getattr(method, "_fused_runner", None)
    if runner is None:
        return None
    state0 = jax.block_until_ready(runner._init_jit())
    ctx = (tempfile.TemporaryDirectory() if logdir is None else None)
    d = ctx.name if ctx is not None else logdir
    try:
        with jax.profiler.trace(d):
            jax.block_until_ready(runner._run_jit(state0))
        out = phase_table_from_trace(d)
    finally:
        if ctx is not None:
            ctx.cleanup()
    return out


def print_phase_table(table, meta, n_iters=None, out=None) -> None:
    """The reference's hierarchical timer table, filled from DEVICE walls
    (utilities.hpp:154-324 prints host stopwatch splits; the fused harness
    is one dispatch, so attribution comes from the trace)."""
    import sys
    out = sys.stderr if out is None else out
    width = 44
    dev = meta["device_wall"]
    rows = [(0, "solve (device wall)", dev)]
    order = ("spmv", "sptrsv", "orthog", "blas1", "layout_glue", "other")
    acct = 0.0
    for k in order:
        if k in table:
            rows.append((1, k, table[k]))
            acct += table[k]
    lines = ["+" + "-" * (width + 26) + "+"]
    for depth, name, v in rows:
        label = "| " * depth + name
        per_it = f" ({v / n_iters * 1e3:8.4f} ms/iter)" if n_iters else ""
        lines.append(f"| {label:<{width}} {v:10.6f} s{per_it:>20} |")
    lines.append("+" + "-" * (width + 26) + "+")
    lines.append(f"| accounted: {acct:.6f} s of {dev:.6f} s device wall"
                 f" ({100 * acct / max(dev, 1e-12):.0f}%; ops overlap)")
    print("\n".join(lines), file=out)
