"""Accelerator-facing pieces that CPU CI can pin without a device.

* the published-peaks table the roofline divides by (utils/report.py);
* the collective census on XLA:GPU's asynchronous `-start` forms;
* the compile-cache location (package import);
* precision=HIGHEST on every f32 contraction of the solve paths, so that
  no product runs in TF32 on a GPU;
* chip_smoke.py's refusal to report anything but a GPU run.

The on-device checks themselves live in chip_smoke.py; the one test here
that runs it is marked `gpu` and skips without an NVIDIA device.
"""
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.parallel.census import hlo_collective_census
from basic_iterative_solvers_tpu.utils import report

ROOT = pathlib.Path(__file__).resolve().parent.parent


# -- peaks table --------------------------------------------------------------

def test_device_peaks_h100():
    p = report.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_gbps"] == 3350.0
    assert p["l2_bytes"] == 50 * 1024 * 1024
    assert p["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_device_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        report.device_peaks(kind)


def test_roofline_reports_no_rate_on_cpu():
    A = bis.generators.from_source("fdm:8")
    setup = bis.preprocessing(A, bis.SolverConfig(dtype=np.float64))
    res = bis.solve(setup)
    out = io.StringIO()
    report.roofline_report(setup, res, out=out)
    assert out.getvalue().strip() == "[roofline] not measured: cpu run"


# -- census on XLA:GPU's async collectives ------------------------------------

_GPU_HLO = """\
HloModule fused_cg

%sum (a: f32[], b: f32[]) -> f32[] {
  ROOT %add = f32[] add(f32[] %a, f32[] %b)
}

%body (p: (s32[], f32[2048])) -> (s32[], f32[2048]) {
  %ars = f32[] all-reduce-start(f32[] %d), replica_groups={{0,1,2,3}}, to_apply=%sum
  %ard = f32[] all-reduce-done(f32[] %ars)
  %cps = (f32[1,2048]{1,0}, f32[1,2048]{1,0}, u32[], u32[]) collective-permute-start(f32[1,2048]{1,0} %x), source_target_pairs={{0,1},{1,2},{2,3}}
  %cpd = f32[1,2048]{1,0} collective-permute-done((f32[1,2048]{1,0}, f32[1,2048]{1,0}, u32[], u32[]) %cps)
  %cps2 = (f32[1,2048]{1,0}, f32[1,2048]{1,0}, u32[], u32[]) collective-permute-start(f32[1,2048]{1,0} %y), source_target_pairs={{1,0},{2,1},{3,2}}
  %cpd2 = f32[1,2048]{1,0} collective-permute-done((f32[1,2048]{1,0}, f32[1,2048]{1,0}, u32[], u32[]) %cps2)
}

%cond (p: (s32[], f32[2048])) -> pred[] {
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

ENTRY %main (x: f32[2048]) -> f32[2048] {
  %ags = (f32[2048]{0}, f32[8192]{0}) all-gather-start(f32[2048]{0} %x), dimensions={0}
  %agd = f32[8192]{0} all-gather-done((f32[2048]{0}, f32[8192]{0}) %ags)
  %w = (s32[], f32[2048]) while((s32[], f32[2048]) %t), condition=%cond, body=%body
}
"""


def test_census_counts_async_start_forms():
    c = hlo_collective_census(_GPU_HLO, full_vector_len=8192)
    assert c["in_while"]["all-reduce"] == 1           # -done not counted
    assert c["in_while"]["collective-permute"] == 2
    assert c["in_while"]["all-gather"] == 0
    assert c["all-gather"] == 1 and c["all-reduce"] == 1
    # the async all-gather's tuple result (operand, gathered) is sized by
    # its largest member: the full vector, outside the loop
    assert c["full_gathers"] == [("all-gather", "setup", 2048 + 8192)]


# -- compile cache ------------------------------------------------------------

def _cache_dir_in_subprocess(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax, basic_iterative_solvers_tpu as b; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(b.compile_cache_dir())")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    return out[-2], out[-1]


def test_compile_cache_in_checkout_by_default():
    cfg, helper = _cache_dir_in_subprocess(None)
    assert cfg == helper == str(ROOT / ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "cache")
    cfg, helper = _cache_dir_in_subprocess(d)
    assert cfg == helper == d


# -- no TF32: every f32 contraction pins its precision ------------------------

def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_generals(inner)


def _assert_all_highest(closed, min_count=1):
    dots = list(_dot_generals(closed.jaxpr))
    assert len(dots) >= min_count
    for eqn in dots:
        assert "HIGHEST" in str(eqn.params["precision"]), eqn


def test_dot_nd_pins_precision():
    from basic_iterative_solvers_tpu.ops.blas1 import _dot_nd
    x = jnp.ones(64, jnp.float32)
    _assert_all_highest(jax.make_jaxpr(_dot_nd)(x, x))


@pytest.mark.parametrize("orthog", ["lowsync", "cgs2", "mgs"])
def test_gmres_iteration_pins_precision(orthog):
    from basic_iterative_solvers_tpu.solvers import make_method
    A = bis.generators.from_source("fdm:8")
    cfg = bis.SolverConfig(method=bis.SolverType.GMRES, dtype=np.float32,
                           restart_length=10, orthog_mode=orthog,
                           harness="fused")
    method = make_method(bis.preprocessing(A, cfg))
    state = method.init_state()
    _assert_all_highest(jax.make_jaxpr(method.iterate)(state), min_count=2)
    _assert_all_highest(jax.make_jaxpr(method.explicit_x)(state))


def test_mg_transfers_pin_precision():
    from basic_iterative_solvers_tpu import stencil_op
    from basic_iterative_solvers_tpu.precond import apply_preconditioner
    # 16³ coarsens to 8³: one restriction and one prolongation, three
    # one-axis contractions each
    A = stencil_op.from_source_operator("hpcg:16x16x16", dtype=jnp.float32)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           preconditioner=bis.PrecondType.MULTIGRID,
                           dtype=np.float32, harness="fused")
    setup = bis.preprocessing_device(A, cfg)
    _assert_all_highest(
        jax.make_jaxpr(apply_preconditioner)(setup.M, setup.b), min_count=6)


# -- chip_smoke refuses anything but a GPU ------------------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_refuses_cpu_devices():
    cs = _chip_smoke()
    with pytest.raises(SystemExit, match="needs a GPU, JAX found cpu"):
        cs.check_devices(jax.devices())
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.check_devices([])
    gpu = NS(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    cs.check_devices([gpu])
    with pytest.raises(SystemExit, match="needs 4 GPUs, found 1"):
        cs.check_devices([gpu], need=4)
    cs.check_devices([gpu] * 4, need=4)


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Run as a program on CPU (and as a lone copy outside the checkout),
    the script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, str(script)], cwd=str(cwd), env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.fixture
def nvidia_gpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (no nvidia-smi)")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(nvidia_gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
