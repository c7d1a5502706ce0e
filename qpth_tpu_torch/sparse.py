"""Fixed-pattern batched QP layer, ``SpQPFunction`` (counterpart of
``qpth_tpu/sparse.py``).

The COO index sets are fixed per instance and the values are per batch, as
in upstream qpth's ``SpQPFunction``. The pattern is analysed once, at
construction, with the reference's own planners, so the port picks the
same tier pattern for pattern:

1. **diag**: diagonal Q and square diagonal G (the sudoku layer's
   Q = eps*I, G = -I) run on the diagonal structured solver
   (:mod:`qpth_tpu_torch.diagqp`);
2. **banded**: block-tridiagonal Q with separable G (ROADMAP.md §1 item 17,
   not ported: raises);
3. **general**: other patterns whose RCM-reordered bandwidth is moderate
   (the block-tridiagonal general solver, ROADMAP.md §1 items 17 and 18,
   not ported: raises), except that below float64 an automatically chosen
   general pattern with n < ``GENERAL_F32_MIN_N`` is densified, as in the
   reference;
4. **dense**: the values are scattered into dense operands and the dense
   QP layer runs.

Gradients reach the values through the scatters by autograd (duplicate
indices accumulate, and their gradients are gathered back).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import QPSolvers, SolverConfig
from .diagqp import solve_qp_diag, solve_qp_diag_full
from .qp import _device, _to, solve_qp, solve_qp_full


def _separable_g(gi) -> bool:
    """G is separable when every inequality row touches at most one
    variable (diagonal G, box stacks [I; -I], variable bounds)."""
    return not gi.shape[1] or np.unique(gi[0]).size == gi.shape[1]


def _in_band(qi, bs) -> bool:
    """Every entry of the pattern lies in the block-tridiagonal band of
    block size ``bs``."""
    return not qi.shape[1] or int(np.abs(qi[0] // bs - qi[1] // bs).max()) <= 1


def _densify(idx, vals, shape):
    """Scatter fixed-pattern COO values to dense: idx (2, nnz) on the
    values' device, vals (B, nnz) -> (B, *shape). Duplicates accumulate."""
    B = vals.shape[0]
    flat = idx[0] * shape[1] + idx[1]
    out = vals.new_zeros((B, shape[0] * shape[1]))
    return out.index_add(1, flat, vals).view(B, *shape)


def _diag_of(idx, vals, n):
    """Values of a diagonal pattern on the diagonal: (B, n)."""
    return vals.new_zeros((vals.shape[0], n)).index_add(1, idx[0], vals)


class SpQPFunction:
    """Batched QPs with shared sparsity patterns and per-batch values.

    ``SpQPFunction(Qi, Qsz, Gi, Gsz, Ai, Asz)(Qv, p, Gv, h, Av, b)`` where
    ``*i`` are (2, nnz) integer COO indices shared across the batch,
    ``*sz`` the dense shapes, and ``*v`` (B, nnz) values. ``structure``:
    "auto" (detect), "diag", "banded", "general" or "dense". Runs on
    ``device`` (CUDA unless asked for the CPU).
    """

    #: Auto-dispatch floor of the general tier below float64 (the
    #: reference's measured speed crossover): smaller patterns densify.
    GENERAL_F32_MIN_N = 512

    def __init__(self, Qi, Qsz, Gi, Gsz, Ai, Asz,
                 eps: float = 1e-12, verbose: int = 0,
                 notImprovedLim: int = 3, maxIter: int = 20,
                 config: Optional[SolverConfig] = None,
                 structure: str = "auto", device="cuda"):
        self.Qi, self.Qsz = np.asarray(Qi), tuple(Qsz)
        self.Gi, self.Gsz = np.asarray(Gi), tuple(Gsz)
        self.Ai, self.Asz = np.asarray(Ai), tuple(Asz)
        self.device = device
        if config is None:
            config = SolverConfig(
                eps=eps, verbose=verbose, not_improved_lim=notImprovedLim,
                max_iter=maxIter)
        self.config = config
        self.nineq, self.nz = self.Gsz
        self.neq = self.Asz[0]
        if structure not in ("auto", "diag", "banded", "general", "dense"):
            raise ValueError(structure)
        self.structure = structure
        # An automatically chosen general pattern may densify (see
        # _general_densifies); an explicit structure="general" never does.
        self._general_auto = False
        if structure == "auto":
            qi, gi = self.Qi, self.Gi
            pdipm = config.solver == QPSolvers.PDIPM_BATCHED
            g_diag = (pdipm and self.Gsz[0] == self.Gsz[1]
                      and bool((gi[0] == gi[1]).all()))
            diag_ok = g_diag and bool((qi[0] == qi[1]).all())
            if self.nineq == 0 or gi.shape[1] == 0:
                # No inequalities: the dense path's closed-form equality
                # solver takes it.
                self.structure = "dense"
            elif diag_ok:
                self.structure = "diag"
            elif (pdipm and _separable_g(gi)
                    and self._banded(qi, allow_diag=True)):
                self.structure = "banded"
            elif pdipm and self._general_perm(qi, gi) is not None:
                self.structure = "general"
                self._general_auto = True
            else:
                self.structure = "dense"
        elif structure == "banded":
            if not (_separable_g(self.Gi)
                    and self._banded(self.Qi, allow_diag=True)):
                raise ValueError(
                    "structure='banded' requires separable G (at most one "
                    "variable per inequality row) and a banded Q pattern "
                    "(bandwidth <= n/4, >= 3 blocks)")
        elif structure == "general":
            if self._general_perm(self.Qi, self.Gi) is None:
                raise ValueError(
                    "structure='general' requires the RCM bandwidth of "
                    "patt(Q) ∪ patt(G^T G) to be moderate (<= n/3 and "
                    "<= 128, >= 3 blocks) and no dense G rows")

    # ---- construction-time tier decisions (the reference's planners, in
    # numpy; the scatter maps they also build belong to the banded and
    # general solvers, ROADMAP.md §1 items 17 and 18) ----

    def _banded(self, qi, allow_diag: bool = False) -> bool:
        """Whether some block size makes Q block-tridiagonal with at least
        3 blocks; ``allow_diag`` accepts a diagonal Q (for separable G that
        is not square diagonal)."""
        n = self.Qsz[0]
        if self.Qsz[0] != self.Qsz[1] or qi.shape[1] == 0:
            return False
        w = int(np.abs(qi[0] - qi[1]).max())
        if w == 0 and not allow_diag:
            return False
        bs = max(w, 8 if n >= 64 else 2)
        return (-(-n // bs) >= 3 and bs <= 128 and w <= n // 4
                and _in_band(qi, bs))

    def _general_perm(self, qi, gi) -> Optional[np.ndarray]:
        """The reverse-Cuthill-McKee order of patt(Q) ∪ patt(G^T G) under
        which the general tier blocks the pattern, or None for patterns it
        cannot compress (they take the dense tier)."""
        n = self.Qsz[0]
        if self.Qsz[0] != self.Qsz[1] or qi.shape[1] == 0:
            return None
        try:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee
        except ImportError:         # pragma: no cover
            return None
        byrow = {}
        for r, c in zip(gi[0], gi[1]):
            byrow.setdefault(int(r), []).append(int(c))
        npairs = sum(len(cs) * len(cs) for cs in byrow.values())
        if npairs > max(128 * n, 8 * gi.shape[1]):
            return None
        pairs = np.asarray([(c1, c2) for cs in byrow.values()
                            for c1 in cs for c2 in cs],
                           qi.dtype).reshape(-1, 2)
        rk = np.concatenate([qi[0], qi[1], pairs[:, 0]])
        ck = np.concatenate([qi[1], qi[0], pairs[:, 1]])
        K = sp.csr_matrix((np.ones(rk.size), (rk, ck)), shape=(n, n))
        perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True),
                          np.int64)
        invp = np.empty(n, np.int64)
        invp[perm] = np.arange(n)
        coo = K.tocoo()
        w_rcm = int(np.abs(invp[coo.row] - invp[coo.col]).max())
        w_nat = int(np.abs(coo.row - coo.col).max())
        if w_nat <= w_rcm:          # RCM can worsen an already-good order
            perm = invp = np.arange(n)
            w = w_nat
        else:
            w = w_rcm
        bs = max(w, 8 if n >= 64 else 2)
        if -(-n // bs) < 3 or bs > 128 or w > n // 3:
            return None
        qi_p = np.stack([invp[qi[0]], invp[qi[1]]])
        return perm if _in_band(qi_p, bs) else None

    # ---- solves ----

    def _general_densifies(self, Qv) -> bool:
        """The general tier's auto-dispatch densify rule."""
        return (self._general_auto and Qv.element_size() < 8
                and self.Qsz[0] < self.GENERAL_F32_MIN_N)

    def _tier(self, Qv) -> str:
        """The tier this call runs on: "diag" or "dense"; the banded and
        general solvers raise."""
        if self.structure == "banded":
            raise NotImplementedError(
                "SpQPFunction structure='banded' (the block-tridiagonal "
                "solver) — ROADMAP.md §1 item 17")
        if self.structure == "general" and not self._general_densifies(Qv):
            raise NotImplementedError(
                "SpQPFunction structure='general' (the block-tridiagonal "
                "general-pattern solver) — ROADMAP.md §1 items 17 and 18")
        return "diag" if self.structure == "diag" else "dense"

    def _operands(self, Qv, p, Gv, h, Av, b):
        """Values on the device and the tier's operands: (q, p, g, h, A, b)
        for "diag", (Q, p, G, h, A, b) for "dense"."""
        dev = _device(self.device)
        Qv, p, Gv, h, Av, b = (_to(v, dev) for v in (Qv, p, Gv, h, Av, b))
        idx = {k: torch.as_tensor(getattr(self, k), dtype=torch.long,
                                  device=dev) for k in ("Qi", "Gi", "Ai")}
        A = (_densify(idx["Ai"], Av, self.Asz) if self.neq > 0 else None)
        b = b if self.neq > 0 else None
        if self._tier(Qv) == "diag":
            n = self.Qsz[0]
            return "diag", (_diag_of(idx["Qi"], Qv, n), p,
                            _diag_of(idx["Gi"], Gv, n), h, A, b), dev
        return "dense", (_densify(idx["Qi"], Qv, self.Qsz), p,
                         _densify(idx["Gi"], Gv, self.Gsz), h, A, b), dev

    def __call__(self, Qv, p, Gv, h, Av, b):
        """Solve; differentiable in (Qv, p, Gv, h, Av, b)."""
        tier, args, dev = self._operands(Qv, p, Gv, h, Av, b)
        if tier == "diag":
            return solve_qp_diag(*args, config=self.config, device=dev)
        return solve_qp(*args, config=self.config, device=dev)

    def solve_full(self, Qv, p, Gv, h, Av, b, init=None):
        """Forward-only solve returning the full primal-dual solution and
        ``SolveStats`` from whichever tier the pattern dispatched to.
        ``init``: optional warm start (x, s, z, y), e.g. the previous
        solve's (z, s, lam, nu). Not differentiable."""
        tier, args, dev = self._operands(Qv, p, Gv, h, Av, b)
        if tier == "diag":
            return solve_qp_diag_full(*args, config=self.config, init=init,
                                      device=dev)
        return solve_qp_full(*args, config=self.config, init=init,
                             device=dev)
