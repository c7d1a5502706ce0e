"""qpth_tpu_torch — the PyTorch/CUDA port of qpth_tpu for NVIDIA Hopper.

A batched differentiable QP layer (the OptNet solver) whose hot loop runs
in hand-written CUDA kernels on an H100. ``qpth_tpu`` (JAX) stays the
reference; this package imports neither JAX nor ``qpth_tpu``.

Ported so far: dense inequality-constrained QPs (neq = 0), the forward
solve and the implicit-KKT backward, in the float32 default configuration
(and float64 with ``solve_method="inverse"``, ``resid_every`` > 1). Entry
points run on CUDA unless called with ``device="cpu"``.
"""

from .config import (KKTSolver, QPSolution, QPSolutionLow, QPSolvers,
                     SolverConfig, SolveStats)
from .convert import factors_from_numpy
from .ops.kkt import KKTFactors
from .qp import QPFunction, prefactor_qp, solve_qp, solve_qp_full

__all__ = [
    "KKTFactors",
    "KKTSolver",
    "QPFunction",
    "QPSolution",
    "QPSolutionLow",
    "QPSolvers",
    "SolveStats",
    "SolverConfig",
    "factors_from_numpy",
    "prefactor_qp",
    "solve_qp",
    "solve_qp_full",
]
