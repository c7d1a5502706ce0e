"""qpth_tpu_torch — the PyTorch/CUDA port of qpth_tpu for NVIDIA Hopper.

A batched differentiable QP layer (the OptNet solver) whose hot loop runs
in hand-written CUDA kernels on an H100. ``qpth_tpu`` (JAX) stays the
reference; this package imports neither JAX nor ``qpth_tpu``.

Ported so far: the dense QP layer with inequality and equality
constraints, the forward solve and the implicit-KKT backward, in the
float32 and the float64 default configurations (inverse and substitution
mode, tracked and untracked residuals, warm starts), and the closed-form
solver for nineq = 0; the diagonal structured tier (``solve_qp_diag``,
``solve_qp_diag_full``, the opt-in fused step); the banded and general
structured tiers (``solve_qp_banded``, ``solve_qp_banded_full``,
``GeneralG``); ``SpQPFunction`` on every tier; the OptNet layers as
``torch.nn.Module``s (``qpth_tpu_torch.nn``); the hybrid blocked path past
the kernels' fit (``use_pallas="hybrid"``, and "auto" past it on CUDA);
and the unbatched solver ``solve_single``. Entry points run on CUDA unless
called with ``device="cpu"``.
"""

from .config import (KKTSolver, QPSolution, QPSolutionLow, QPSolvers,
                     SolverConfig, SolveStats)
from . import nn
from .bandqp import solve_qp_banded, solve_qp_banded_full
from .convert import factors_from_numpy, optnet_params_from_numpy
from .core.banded import GeneralG
from .core.single import solve_single
from .diagqp import solve_qp_diag, solve_qp_diag_full
from .ops.kkt import KKTFactors
from .qp import (QPFunction, prefactor_qp, solve_qp, solve_qp_eq,
                 solve_qp_full)
from .sparse import SpQPFunction

__all__ = [
    "GeneralG",
    "KKTFactors",
    "KKTSolver",
    "QPFunction",
    "QPSolution",
    "QPSolutionLow",
    "QPSolvers",
    "SolveStats",
    "SolverConfig",
    "SpQPFunction",
    "factors_from_numpy",
    "nn",
    "optnet_params_from_numpy",
    "prefactor_qp",
    "solve_qp",
    "solve_qp_banded",
    "solve_qp_banded_full",
    "solve_qp_diag",
    "solve_qp_diag_full",
    "solve_qp_eq",
    "solve_qp_full",
    "solve_single",
]
