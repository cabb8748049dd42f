"""Enums and public type vocabulary.

Re-design of the reference's enum layer
(/root/reference/common.hpp:38-111): same solver/preconditioner vocabulary,
same human-readable names, expressed as Python enums so they can be used both
host-side (dispatch at trace time) and in config dataclasses.
"""
from __future__ import annotations

import enum


class SolverType(enum.Enum):
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss-seidel"
    SYMMETRIC_GAUSS_SEIDEL = "symmetric-gauss-seidel"
    GMRES = "gmres"
    CONJUGATE_GRADIENT = "conjugate-gradient"
    BICGSTAB = "bicgstab"


class PrecondType(enum.Enum):
    NONE = "none"
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss-seidel"
    BACKWARDS_GAUSS_SEIDEL = "backwards-gauss-seidel"
    SYMMETRIC_GAUSS_SEIDEL = "symmetric-gauss-seidel"
    TWO_STAGE_GS = "two-stage gauss-seidel"
    SYMMETRIC_TWO_STAGE_GS = "symmetric two-stage gauss-seidel"
    ILU0 = "incomplete LU(0)"
    # Addition with no reference analog: Chebyshev polynomial in
    # the Jacobi-scaled operator — a communication-free M⁻¹ (pure SpMV
    # chain, zero reductions per apply; the optimal-weight version of the
    # reference's two-stage Richardson, kernels.hpp:312-333).
    CHEBYSHEV = "chebyshev polynomial"
    # Addition with no reference analog: geometric-multigrid V-cycle
    # over the constant-coefficient stencil hierarchy (mg.py) — the
    # grid-size-independent-iteration-count preconditioner the reference's
    # menu (kernels.hpp:336-414, topping out at ILU(0)) cannot express.
    MULTIGRID = "geometric multigrid"


#: CLI flag → solver type, mirroring reference parse_cli
#: (/root/reference/utilities/utilities.hpp:30-51).
SOLVER_CLI_FLAGS = {
    "-j": SolverType.JACOBI,
    "-gs": SolverType.GAUSS_SEIDEL,
    "-sgs": SolverType.SYMMETRIC_GAUSS_SEIDEL,
    "-cg": SolverType.CONJUGATE_GRADIENT,
    "-gm": SolverType.GMRES,
    "-bi": SolverType.BICGSTAB,
}

#: '-p' argument → preconditioner type, mirroring reference parse_cli
#: (/root/reference/utilities/utilities.hpp:66-95).
PRECOND_CLI_NAMES = {
    "j": PrecondType.JACOBI,
    "gs": PrecondType.GAUSS_SEIDEL,
    "bgs": PrecondType.BACKWARDS_GAUSS_SEIDEL,
    "sgs": PrecondType.SYMMETRIC_GAUSS_SEIDEL,
    "2st": PrecondType.TWO_STAGE_GS,
    "s2st": PrecondType.SYMMETRIC_TWO_STAGE_GS,
    "ilu0": PrecondType.ILU0,
    "cheby": PrecondType.CHEBYSHEV,
    "mg": PrecondType.MULTIGRID,
    "none": PrecondType.NONE,
}


def to_string(x) -> str:
    """Human-readable name, matching the reference's to_string specializations
    (/root/reference/common.hpp:62-103)."""
    return x.value
