"""Per-iteration device walls from profiler traces (utils/xprof.py).

The on-device behaviour is checked by chip_smoke.py phase (f); CI pins the
trace parsing on synthetic device planes and on a device plane recorded
from a GPU trace (tests/data/gpu_cg_trace_events.json), the history-slot
mapping, and the graceful no-device fallback on CPU.
"""
import json
import pathlib
from types import SimpleNamespace as NS

import numpy as np

from basic_iterative_solvers_tpu.utils import xprof

DATA = pathlib.Path(__file__).parent / "data"


def _profile(device_lines, plane="/device:GPU:0"):
    """A stand-in for jax.profiler.ProfileData: {line name: [(name,
    start_ns, duration_ns), ...]} on one device plane plus a host plane."""
    lines = [NS(name=ln, events=[NS(name=n, start_ns=t, duration_ns=d)
                                 for n, t, d in evs])
             for ln, evs in device_lines.items()]
    host = NS(name="/host:CPU", lines=[NS(name="python", events=[
        NS(name="PjitFunction(run)", start_ns=0.0, duration_ns=1e9)])])
    return NS(planes=[host, NS(name=plane, lines=lines)])


def _synthetic_ops(starts, dur=50e3):
    ev = []
    for t in starts:
        # one marker op + one secondary op per iteration, plus the
        # while-loop predicate's device-to-host copy
        ev.append(("body_fusion", t, dur))
        ev.append(("reduce_fusion", t + dur, 20e3))
        ev.append(("MemcpyD2H", t + dur + 20e3, 1e3))
    # a once-only op must never be picked as the marker
    ev.append(("epilogue", starts[-1] + 500e3, 10e3))
    return ev


def test_iteration_times_from_synthetic_trace():
    starts = [1000e3, 1100e3, 1250e3, 1500e3]     # growing iterations (ns)
    ops = xprof.device_ops(_profile({"XLA Ops": _synthetic_ops(starts)}))
    times = xprof.iteration_times_from_ops(ops)
    assert times is not None and times.size == 4
    # gaps between marker starts, in seconds; last iteration runs to the
    # final event end (epilogue at 2000+10 µs)
    np.testing.assert_allclose(times[:3] * 1e6, [100.0, 150.0, 250.0])
    np.testing.assert_allclose(times[3] * 1e6, 2010.0 - 1500.0)


def test_iteration_times_n_iters_filter():
    ops = xprof.device_ops(_profile({"XLA Ops":
                                     _synthetic_ops([0.0, 100e3, 200e3])}))
    assert xprof.iteration_times_from_ops(ops, n_iters=3) is not None
    assert xprof.iteration_times_from_ops(ops, n_iters=7) is None


def test_gpu_stream_lines_are_merged():
    """GPU traces carry no "XLA Ops" line: the kernels of every "Stream #"
    line of the device plane form the timeline."""
    ev = _synthetic_ops([0.0, 100e3, 200e3])
    prof = _profile({"Stream #13(Compute)": ev[0::2],
                     "Stream #14(Compute)": ev[1::2]})
    ops = xprof.device_ops(prof)
    assert [o[1] for o in ops] == sorted(o[1] for o in ev)
    np.testing.assert_allclose(
        xprof.iteration_times_from_ops(ops, n_iters=3)[:2] * 1e6,
        [100.0, 100.0])


def test_recorded_gpu_trace():
    """A fused CG solve's device plane as a GPU trace records it: kernels
    on a "Stream #" line, memcpy events between them."""
    d = json.loads((DATA / "gpu_cg_trace_events.json").read_text())
    ops = xprof.device_ops(_profile({d["line"]: d["events"]},
                                    plane=d["plane"]))
    assert len(ops) == len(d["events"])
    times = xprof.iteration_times_from_ops(ops, n_iters=d["n_iters"])
    assert times is not None and times.size == d["n_iters"]
    assert np.all(times > 0) and np.all(times < 1e-3)
    # the marker is a body kernel, never a copy: with the memcpy events
    # dropped the same walls come out
    kernels = [o for o in ops if not o[0].lower().startswith("memcpy")]
    np.testing.assert_allclose(
        xprof.iteration_times_from_ops(kernels, n_iters=d["n_iters"])[:-1],
        times[:-1])


def test_graceful_without_device_trace(tmp_path):
    assert xprof.device_ops(_profile({})) == []
    assert xprof.iteration_times_from_ops([]) is None
    assert xprof.iteration_times_from_trace(str(tmp_path)) is None
    assert xprof.iteration_times_from_trace(str(tmp_path / "nope")) is None


def test_attach_slot_mapping_with_restarts(monkeypatch):
    """GMRES histories interleave restart rows; measured walls must land
    on the per-iteration slots only."""
    from basic_iterative_solvers_tpu.solvers.base import SolveResult
    times = np.array([1e-3, 2e-3, 3e-3, 4e-3, 5e-3])
    monkeypatch.setattr(xprof, "measure_iteration_times",
                        lambda method, n_iters=None: times)
    # 5 iterations with restart_length=2 -> history rows:
    # [r0, it1, it2, RESTART, it3, it4, RESTART, it5, final]
    res = SolveResult(
        x_star=np.zeros(3), iter_count=5, converged=True,
        stopping_criteria=0.0, residual_norms=np.zeros(9),
        time_per_iteration=np.zeros(9), final_residual_norm=0.0,
        gmres_restart_count=2, restart_length=2)
    assert xprof.attach_iteration_times(res, method=object())
    tpi = res.time_per_iteration
    np.testing.assert_allclose(tpi[[1, 2, 4, 5, 7]], times)
    assert tpi[3] == 0.0 and tpi[6] == 0.0     # restart rows untouched
    assert not res.uniform_iteration_times


def test_cpu_attach_returns_false():
    """On backends whose traces carry no device op line, the API degrades
    to False (the host harness's walls remain in place)."""
    import basic_iterative_solvers_tpu as bis
    from basic_iterative_solvers_tpu.solvers import make_method
    A = bis.generators.from_source("fdm:8")
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           dtype=np.float64, harness="fused",
                           tolerance=0.0, max_iters=5)
    setup = bis.preprocessing(A, cfg)
    method = make_method(setup)
    res = bis.solve(setup, method=method)
    assert xprof.attach_iteration_times(res, method) in (True, False)
