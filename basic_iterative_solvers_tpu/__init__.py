"""basic_iterative_solvers_tpu — a sparse iterative-solver framework in
JAX with the capabilities of DanecLacey/basic_iterative_solvers.

Solves Ax = b for large sparse A with Jacobi, (symmetric) Gauss-Seidel,
preconditioned CG, restarted preconditioned GMRES(m) and preconditioned
BiCGSTAB, with none/Jacobi/GS/backward-GS/symmetric-GS/two-stage-GS/
symmetric-two-stage-GS/ILU(0) preconditioning:

* setup (I/O, COO→CSR, L/U split, ILU(0), level sets, sharding plan) on the
  host (NumPy + optional C++ fast paths in csrc/);
* solve-time compute in pure JAX: DIA/ELL device formats, gather-free
  stencil SpMV, level-scheduled triangular scans, fused lax.while_loop
  harness, GSPMD multi-device scale-out.
"""
import os as _os

import jax as _jax

# Reference parity mode is float64 (the reference is fp64 throughout);
# float32 stays the default performance dtype on an accelerator via
# SolverConfig.dtype.
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Persistent XLA compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else `.jax_cache` in the checkout that holds this package."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# A set JAX_COMPILATION_CACHE_DIR is read by JAX itself; nothing else is
# set then.  Otherwise the cache lives at a fixed path in the checkout.
if ("JAX_COMPILATION_CACHE_DIR" not in _os.environ
        and _jax.config.jax_compilation_cache_dir is None):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from .config import Args, SolverConfig  # noqa: E402,F401
from .types import PrecondType, SolverType, to_string  # noqa: E402,F401
from .matrix import MatrixCOO, MatrixCSR, convert_coo_to_csr  # noqa: E402,F401
from .io import read_mtx, write_mtx  # noqa: E402,F401
from . import generators  # noqa: E402,F401
from .factor import factor_LU, split_LU, peel_diag, extract_scale  # noqa: E402,F401
from .device_matrix import DeviceDIA, DeviceELL, from_csr  # noqa: E402,F401
from . import dia  # noqa: E402,F401
from . import permute  # noqa: E402,F401
from . import stencil_op  # noqa: E402,F401
from .stencil_op import DeviceStencil  # noqa: E402,F401
from .precond import (Preconditioner, setup_preconditioner,  # noqa: E402,F401
                      setup_preconditioner_dia, apply_preconditioner)
from .solvers import (SolverSetup, SolveResult, preprocessing,  # noqa: E402,F401
                      preprocessing_device, solve)

__version__ = "0.1.0"


def solve_system(matrix_source, method="cg", preconditioner=None,
                 b=None, x0=None, **config_kwargs) -> "SolveResult":
    """One-call convenience API: the CLI pipeline, in process.

    `matrix_source` is a .mtx path, a generator spec ("hpcg:64x64x64",
    "scamac:Anderson,Lx=20,...", "fdm:16", "band:100,2"), a MatrixCSR, a
    scipy.sparse matrix/array, a dense 2-D ndarray, or a device matrix
    (DeviceDIA/DeviceStencil).  `method` and `preconditioner`
    accept the CLI short names ("cg", "gm", "bi", "j", "gs", "sgs" /
    "j", "gs", "bgs", "sgs", "2st", "s2st", "ilu0") or the enums.
    Remaining kwargs go to SolverConfig.  Uses the device-native setup path
    whenever the inputs allow it (same rules as the CLI).
    """
    import numpy as _np

    from .matrix import MatrixCSR as _CSR
    from .types import (PRECOND_CLI_NAMES, SOLVER_CLI_FLAGS, PrecondType as _PT,
                        SolverType as _ST)

    if isinstance(method, str):
        method = SOLVER_CLI_FLAGS.get("-" + method.lstrip("-"), None) or \
            _ST(method)
    if preconditioner is None:
        preconditioner = _PT.NONE
    elif isinstance(preconditioner, str):
        preconditioner = PRECOND_CLI_NAMES.get(preconditioner) or \
            _PT(preconditioner)

    not_cpu = _jax.default_backend() != "cpu"
    if "dtype" not in config_kwargs:
        config_kwargs["dtype"] = _np.float32 if not_cpu else _np.float64
    if "harness" not in config_kwargs:
        config_kwargs["harness"] = "fused" if not_cpu else "host"
    config = SolverConfig(method=method, preconditioner=preconditioner,
                          **config_kwargs)

    from .precond import (COLORED_PRECONDS, DEVICE_NATIVE_PRECONDS,
                          resolve_gs_mode)
    A = matrix_source
    if isinstance(A, (DeviceDIA, DeviceStencil)):
        return solve(preprocessing_device(A, config, b=b, x0=x0))
    if isinstance(A, str):
        from .dia import from_source_device
        if config.color_spec is None:
            config.color_spec = generators.color_spec_for_source(A)
        if (preconditioner == _PT.MULTIGRID
                and config.matrix_format == "auto"
                and stencil_op.stencil_buildable(A)):
            # -p mg lives on the matrix-free stencil path (same as the CLI)
            config.matrix_format = "stencil"
        colored = resolve_gs_mode(config, device_native=True) == "colored"
        # exact ILU(0) device path for constant-stencil sources under a
        # grid coloring: translation-table factors (same rule as the CLI)
        ilu0_stencil = False
        if (preconditioner == _PT.ILU0 and colored
                and config.perm_mode == "none"
                and config.matrix_format in ("auto", "stencil")
                and generators.device_buildable(A)
                and stencil_op.stencil_buildable(A)):
            from .coloring import spec_for_device
            from .ops.block_trisolve import stencil_ilu0_eligible
            try:
                _op = stencil_op.from_source_operator(
                    A, dtype=config.mat_dtype())
                ilu0_stencil = stencil_ilu0_eligible(_op,
                                                     spec_for_device(_op))
            except ValueError:
                pass
        if ilu0_stencil and config.matrix_format == "auto":
            config.matrix_format = "stencil"
        # device_buildable, not a bare _GEN_RE match: non-Anderson SCAMAC
        # models (Hubbard, SpinChainXXZ, ...) have no device builder and
        # must take the host CSR pipeline
        device_ok = (generators.device_buildable(A)
                     and (preconditioner in DEVICE_NATIVE_PRECONDS
                          or (preconditioner in COLORED_PRECONDS and colored)
                          or ilu0_stencil)
                     and (method not in (_ST.GAUSS_SEIDEL,
                                         _ST.SYMMETRIC_GAUSS_SEIDEL)
                          or colored)
                     and config.perm_mode == "none"
                     and not (config.num_scale
                              and config.matrix_format == "stencil")
                     and config.matrix_format in ("auto", "dia", "stencil"))
        if device_ok:
            if config.matrix_format == "stencil":
                # matrix-free operator (same rule as the CLI --format stencil)
                A_dev = stencil_op.from_source_operator(
                    A, dtype=config.mat_dtype())
            else:
                A_dev = from_source_device(A, dtype=config.mat_dtype())
            return solve(preprocessing_device(A_dev, config, b=b, x0=x0))
        if config.matrix_format == "stencil":
            raise ValueError(
                "matrix_format='stencil' needs a generator source and a "
                "device-native method/preconditioner (like the CLI, which "
                "falls back to DIA); use matrix_format='auto' here")
        A = generators.from_source(A)
    if not isinstance(A, _CSR):
        # migration adapters: scipy.sparse (duck-typed on .tocsr) and
        # dense 2-D ndarrays
        if hasattr(A, "tocsr"):
            A = _CSR.from_scipy(A)
        elif isinstance(A, _np.ndarray) and A.ndim == 2:
            A = _CSR.from_dense(A)
        else:
            raise TypeError(
                f"unsupported matrix source: {type(matrix_source)}")
    return solve(preprocessing(A, config, b=b, x0=x0))
