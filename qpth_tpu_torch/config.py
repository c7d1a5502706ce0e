"""Solver configuration and statistics.

Counterpart of ``qpth_tpu/config.py``. ``SolverConfig`` keeps the JAX
package's fields and defaults, with ``process_group`` (a
``torch.distributed`` process group, or None) in place of ``axis_name``
(the shard_map axis): the group over which a batch-sharded solve finishes
its batch reductions. ``use_pallas`` picks the KKT backend, not the device:
the device of the tensors picks kernel or plain version (CUDA tensors
launch the kernels, CPU tensors take their plain PyTorch versions), so the
JAX package's library-only values have no counterpart here:

* ``"auto"``, ``True``, ``"lanes"``: the kernels backend (factor-inverse
  kernel A, the fused steps);
* ``"blocked"``: the Cholesky-factor backend (kernel C's factor, kernel D's
  substitutions; the JAX package's ``pallas_blocked_backend``);
* ``"hybrid"``: the blocked hybrid backend (kernel A on the diagonal blocks,
  batched GEMMs for the rest) at every size; ``"auto"``, ``True`` and
  ``"lanes"`` take it too on CUDA where nineq is past kernel A's fit, and
  inverse mode keeps Q as its blocked factor where nz is;
* ``"hybrid_xla"``: the hybrid backend with inverse-mode cached products
  (kernel A on the diagonal blocks), the single-process form of the
  tensor-parallel path (``parallel.intra.solve_qp_tp``); the JAX package's
  value keeps every ``pallas_call`` out of it so GSPMD can partition it;
* ``False``, ``"xla"``: ``NotImplementedError`` (no library-only path).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import torch


class KKTSolver(enum.Enum):
    """Which KKT linear-system strategy the IPM uses (see the JAX
    package)."""

    #: Pre-factor once, re-factor only the iteration-varying Schur block.
    CHOL_PARTIAL = "chol_partial"
    #: Build and factor the full saddle system fresh every solve.
    FULL = "full"
    #: Regularized saddle system + iterative refinement.
    IR = "ir"


class QPSolvers(enum.Enum):
    """Forward-solver choice (upstream qpth's ``QPSolvers``)."""

    PDIPM_BATCHED = 1
    #: Per-instance float64 CPU oracle solve.
    CPU_ORACLE = 2
    #: Alias kept for API familiarity with upstream qpth.
    CVXPY = 2


#: The string values of ``SolverConfig.use_pallas`` (the JAX package's).
USE_PALLAS_VALUES = ("auto", "lanes", "blocked", "xla", "hybrid",
                     "hybrid_xla")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration. Field meanings and defaults follow
    ``qpth_tpu.SolverConfig``; see its docstrings for the long form."""

    #: Residual convergence target.
    eps: float = 1e-12
    #: Max IPM iterations.
    max_iter: int = 20
    #: Stop after this many consecutive iterations with no improvement.
    not_improved_lim: int = 3
    #: Relative margin for "improved"; None = 1e-3 below float64 (per-lane
    #: latched window), 0.0 at float64 (upstream qpth's global window).
    improve_margin: float | None = None
    #: -1 silence warnings, 0 warnings only, 1 per-iteration prints.
    verbose: int = 0
    #: KKT linear-algebra path.
    kkt_solver: KKTSolver = KKTSolver.CHOL_PARTIAL
    #: Forward solver.
    solver: QPSolvers = QPSolvers.PDIPM_BATCHED
    #: Raise if Q is not SPD (checked eagerly).
    check_Q_spd: bool = True
    #: Divergence guard: stop when min(mu) exceeds this.
    mu_divergence: float = 1e32
    #: Backward-pass clamp on (lams, slacks) before forming d = lam/s.
    grad_clamp: float = 1e-8
    #: Cotangent reduction for parameters passed without a batch dim.
    broadcast_grad_reduction: str = "sum"
    #: Regularization epsilon (IR path; fail-soft init shift).
    ir_eps: float = 1e-7
    #: Refinement steps for the IR path.
    ir_iters: int = 1
    #: Keep the pre-factorization for the backward (else recompute it).
    save_factors_for_backward: bool = True
    #: KKT backend: "auto" / True / "lanes" (kernels backend), "blocked"
    #: (Cholesky-factor backend); see the module docstring for the rest.
    use_pallas: bool | str = "auto"
    #: "subst" | "inverse" | "auto" (inverse below float64, subst at f64).
    solve_method: str = "auto"
    #: Lower clip for warm-start (s, z).
    warm_start_min: float = 1e-3
    #: Fused diagonal-tier step: one ``diag_step`` kernel per iteration
    #: (shared A, fit permitting) instead of the composed factor + solves.
    fused_diag_step: bool = False
    #: Exact residual recompute period; None = 1 at float64, 7 below.
    resid_every: int | None = None
    #: Coefficient-tracked x; None = on wherever tracking is on.
    coeff_x: bool | None = None
    #: Mixed-precision refinement steps, or "auto" (eps-driven dial).
    refine_steps: int | str = "auto"
    #: Ruiz equilibration: "auto" = on below float64.
    equilibrate: bool | str = "auto"
    #: Ruiz iterations.
    ruiz_iters: int = 4
    #: Refinement complementarity clamp; None = 1e-10 (what the JAX
    #: package's float64-residual refinement takes at every working dtype).
    refine_clamp: float | None = None
    #: Gondzio centrality correctors per iteration.
    n_correctors: int = 0
    #: Escalation of conditioning-limited lanes ("oracle" or None).
    escalate: str | None = None
    #: Residual-score threshold above which a lane escalates.
    escalate_tol: float = 1e-4
    #: ``torch.distributed`` process group of a batch-sharded solve: the
    #: loop's exit test, refinement's early exit, the INACC check and the
    #: batch-collapsed Ruiz norms reduce over it. None: one process.
    process_group: Optional[object] = None

    def __post_init__(self):
        up = self.use_pallas
        if not (isinstance(up, bool) or (isinstance(up, str)
                                         and up in USE_PALLAS_VALUES)):
            raise ValueError(f"use_pallas: {up!r} (expected a bool or one "
                             f"of {USE_PALLAS_VALUES})")
        if self.broadcast_grad_reduction not in ("sum", "mean"):
            raise ValueError("broadcast_grad_reduction must be 'sum' or 'mean'")
        if self.refine_steps != "auto" and not isinstance(
                self.refine_steps, int):
            raise ValueError("refine_steps must be an int or 'auto'")


def resolve_refine_steps(config: SolverConfig, dtype) -> tuple[int, bool]:
    """``SolverConfig.refine_steps`` -> ``(budget, early_exit)``: the
    eps-driven auto policy of ``qpth_tpu.config.resolve_refine_steps``."""
    rs = config.refine_steps
    if rs != "auto":
        return int(rs), False
    eps = config.eps
    if eps < 1e-11 or eps > 1e-6:
        return 0, False
    return (6 if eps >= 1e-7 else 12), True


class SolveStats(NamedTuple):
    """Solve diagnostics."""

    #: Number of IPM iterations executed (0-dim int tensor).
    iterations: torch.Tensor
    #: Best per-lane residual score achieved (B,).
    best_resids: torch.Tensor
    #: Final duality measure mu per lane (B,).
    mu: torch.Tensor
    #: Per-lane convergence flag: best_resids < eps.
    converged: torch.Tensor
    #: Per-lane escalation flag (``SolverConfig.escalate``): True where the
    #: lane's score exceeded ``escalate_tol`` and the CPU oracle was tried;
    #: None without escalation.
    escalated: Optional[torch.Tensor] = None


class QPSolutionLow(NamedTuple):
    """Low words of a double-word solution: where the CPU oracle re-solved
    a lane (``SolverConfig.escalate``), hi + lo in float64 is its float64
    answer, which one working-dtype word cannot hold; zero elsewhere."""

    z: torch.Tensor
    nu: torch.Tensor
    lam: torch.Tensor
    s: torch.Tensor


class QPSolution(NamedTuple):
    """Full primal-dual solution of a batch of QPs."""

    #: Primal solution (B, nz).
    z: torch.Tensor
    #: Equality duals (B, neq) — zero-width when neq == 0.
    nu: torch.Tensor
    #: Inequality duals (B, nineq).
    lam: torch.Tensor
    #: Slacks s = h - Gz (B, nineq).
    s: torch.Tensor
    stats: SolveStats
    #: Double-word low words (escalation only); None otherwise.
    lo: Optional[QPSolutionLow] = None
