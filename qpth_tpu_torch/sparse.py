"""Fixed-pattern batched QP layer, ``SpQPFunction`` (counterpart of
``qpth_tpu/sparse.py``).

The COO index sets are fixed per instance and the values are per batch, as
in upstream qpth's ``SpQPFunction``. The pattern is analysed once, at
construction, with the reference's own planners, so the port picks the
same tier, block size and scatter maps pattern for pattern:

1. **diag**: diagonal Q and square diagonal G (the sudoku layer's
   Q = eps*I, G = -I) run on the diagonal structured solver
   (:mod:`qpth_tpu_torch.diagqp`);
2. **banded**: block-tridiagonal Q after static blocking with separable G
   (at most one variable per inequality row: diagonal G, box stacks
   [I; -I], variable bounds; the MPC-chain workload) run on the
   block-Thomas solver (:mod:`qpth_tpu_torch.bandqp`). Cross-block entries
   are symmetrized (half the value from each triangle lands in the shared
   subdiagonal slot); n is padded to a block multiple with decoupled dummy
   variables (q = 1, p = 0, no inequality rows);
3. **general**: other patterns whose reverse-Cuthill-McKee-reordered
   bandwidth of patt(Q) ∪ patt(G^T G) is moderate run the same solver in
   the permuted order, with G^T diag(d) G scattered into the band
   (:class:`qpth_tpu_torch.GeneralG`); below float64 an automatically
   chosen general pattern with n < ``GENERAL_F32_MIN_N`` is densified, as
   in the reference;
4. **dense**: the values are scattered into dense operands and the dense
   QP layer runs.

Gradients reach the values through the scatters, pads and permutations by
autograd (duplicate indices accumulate, and their gradients are gathered
back).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bandqp import solve_qp_banded, solve_qp_banded_full
from .config import QPSolvers, SolverConfig
from .core.banded import GeneralG
from .diagqp import solve_qp_diag, solve_qp_diag_full
from .qp import _device, _to, solve_qp, solve_qp_full


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
    #: An explicit ``structure="general"`` is always honoured.
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
            elif (pdipm and self._plan_separable_g(gi)
                    and self._plan_banded(qi, allow_diag=True)):
                # allow_diag: a diagonal Q with non-diagonal separable G
                # (box stacks) belongs here; the diag tier needs square
                # diagonal G.
                self.structure = "banded"
            elif pdipm and self._plan_general(qi, gi):
                self.structure = "general"
                self._general_auto = True
            else:
                self.structure = "dense"
        elif structure == "banded":
            if not (self._plan_separable_g(self.Gi)
                    and self._plan_banded(self.Qi, allow_diag=True)):
                raise ValueError(
                    "structure='banded' requires separable G (at most one "
                    "variable per inequality row) and a banded Q pattern "
                    "(bandwidth <= n/4, >= 3 blocks)")
        elif structure == "general":
            if not self._plan_general(self.Qi, self.Gi):
                raise ValueError(
                    "structure='general' requires the RCM bandwidth of "
                    "patt(Q) ∪ patt(G^T G) to be moderate (<= n/3 and "
                    "<= 128, >= 3 blocks) and no dense G rows")

    # ---- construction-time plans (the reference's planners, in numpy) ----

    def _plan_separable_g(self, gi) -> bool:
        """G is separable when every inequality row touches at most one
        variable. Stores the static row -> column map ``_g_ci``."""
        m = self.Gsz[0]
        if gi.shape[1] and np.unique(gi[0]).size != gi.shape[1]:
            return False  # a row with two entries (or duplicates)
        ci = np.zeros(m, dtype=gi.dtype)
        ci[gi[0]] = gi[1]
        self._g_ci = ci
        return True

    def _q_scatter_maps(self, qi, bs, nb) -> bool:
        """The COO -> (Qd, Qe) scatter maps for a blocking: diagonal-block
        entries scatter directly (``_qd_idx``, ``_qd_sel``); cross-block
        entries share one Qe slot per symmetric pair at half weight
        (``_qe_idx``, ``_qe_sel``). False if an entry lies outside the
        block-tridiagonal band."""
        br, bc = qi[0] // bs, qi[1] // bs
        if qi.shape[1] and np.abs(br - bc).max() > 1:
            return False
        on_diag = br == bc
        lower = br == bc + 1
        upper = br == bc - 1
        self._qd_sel = np.nonzero(on_diag)[0]
        self._qd_idx = (br[on_diag], qi[0][on_diag] % bs,
                        qi[1][on_diag] % bs)
        lo_sel = np.nonzero(lower)[0]
        up_sel = np.nonzero(upper)[0]
        self._qe_sel = np.concatenate([lo_sel, up_sel])
        self._qe_idx = (
            np.concatenate([bc[lower], br[upper]]),
            np.concatenate([qi[0][lower] % bs, qi[1][upper] % bs]),
            np.concatenate([qi[1][lower] % bs, qi[0][upper] % bs]),
        )
        return True

    def _plan_banded(self, qi, allow_diag: bool = False) -> bool:
        """Choose a block size bs that makes Q block-tridiagonal, store the
        scatter maps and the padding plan ``_band = (n, bs, nb, n_pad)``.
        False when the pattern is not usefully banded. ``allow_diag``
        accepts a diagonal Q (for separable G that is not square
        diagonal)."""
        n = self.Qsz[0]
        if self.Qsz[0] != self.Qsz[1] or qi.shape[1] == 0:
            return False
        w = int(np.abs(qi[0] - qi[1]).max())
        if w == 0 and not allow_diag:
            return False  # diagonal: the diag tier's
        bs = max(w, 8 if n >= 64 else 2)
        nb = -(-n // bs)
        if nb < 3 or bs > 128 or w > n // 4:
            return False
        if not self._q_scatter_maps(qi, bs, nb):
            return False    # cannot happen with bs >= w
        self._band = (n, bs, nb, nb * bs)
        return True

    def _plan_general(self, qi, gi) -> bool:
        """The general tier's plan: the reverse-Cuthill-McKee order of
        K = patt(Q) ∪ patt(G^T G) (kept only where it narrows the band),
        the blocking, Q's scatter maps in the permuted order, and
        ``_gen = (perm, invp, GeneralG)``. False for patterns it cannot
        compress (they take the dense tier)."""
        n = self.Qsz[0]
        m = self.Gsz[0]
        if self.Qsz[0] != self.Qsz[1] or qi.shape[1] == 0:
            return False
        try:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee
        except ImportError:         # pragma: no cover
            return False
        # Within-row column pairs of G (the pattern of G^T G), with a
        # budget so that a dense G row cannot explode the pair list.
        byrow = {}
        for r, c in zip(gi[0], gi[1]):
            byrow.setdefault(int(r), []).append(int(c))
        npairs = sum(len(cs) * len(cs) for cs in byrow.values())
        if npairs > max(128 * n, 8 * gi.shape[1]):
            return False
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
        nb = -(-n // bs)
        if nb < 3 or bs > 128 or w > n // 3:
            return False
        qi_p = np.stack([invp[qi[0]], invp[qi[1]]])
        if not self._q_scatter_maps(qi_p, bs, nb):
            return False            # cannot happen with bs >= w
        spec = GeneralG(m, nb * bs, bs, nb, gi[0], invp[gi[1]])
        self._gen = (perm, invp, spec)
        self._band = (n, bs, nb, nb * bs)
        return True

    # ---- solves ----

    def _general_densifies(self, Qv) -> bool:
        """The general tier's auto-dispatch densify rule."""
        return (self._general_auto and Qv.element_size() < 8
                and self.Qsz[0] < self.GENERAL_F32_MIN_N)

    def _tier(self, Qv) -> str:
        """The tier this call runs on: "diag", "banded", "general" or
        "dense"."""
        if self.structure == "general" and self._general_densifies(Qv):
            return "dense"
        return self.structure

    def _band_blocks(self, Qv):
        """Scatter pattern values into block-tridiagonal (Qd, Qe) with the
        stored maps; the padded tail gets the identity diagonal, so the
        dummy variables stay decoupled."""
        B, dev = Qv.shape[0], Qv.device
        n, bs, nb, n_pad = self._band

        def scatter(nblk, idx, vals):
            lin = (idx[0] * bs + idx[1]) * bs + idx[2]
            lin = torch.as_tensor(np.asarray(lin, np.int64), device=dev)
            out = vals.new_zeros((B, nblk * bs * bs))
            return out.index_add(1, lin, vals).view(B, nblk, bs, bs)

        sel = {k: torch.as_tensor(np.asarray(getattr(self, k), np.int64),
                                  device=dev) for k in ("_qd_sel", "_qe_sel")}
        Qd = scatter(nb, self._qd_idx, Qv[:, sel["_qd_sel"]])
        Qe = scatter(nb - 1, self._qe_idx, 0.5 * Qv[:, sel["_qe_sel"]])
        if n_pad > n:
            tail = np.arange(n, n_pad)
            qd_pad = np.zeros((nb, bs, bs), np.float64)
            qd_pad[tail // bs, tail % bs, tail % bs] = 1.0
            Qd = Qd + torch.as_tensor(qd_pad, dtype=Qv.dtype, device=dev)
        return Qd, Qe

    def _band_operands(self, Qv, p, Gv, h, A):
        """The banded solver's operands from the pattern values: (Qd, Qe),
        p in the solver's order and padded, the G values (row coefficients
        of a separable G, or the entry values of a general one), h, A
        likewise, and the keyword naming G's form."""
        B = Qv.shape[0]
        n, bs, nb, n_pad = self._band
        m = self.Gsz[0]
        Qd, Qe = self._band_blocks(Qv)
        p = p.unsqueeze(0) if p.dim() == 1 else p
        p = p.expand(B, n)
        h = h.unsqueeze(0) if h.dim() == 1 else h
        h = h.expand(B, m)
        if self.structure == "general":
            perm = torch.as_tensor(self._gen[0], device=Qv.device)
            p = p[:, perm]
            if A is not None:
                A = A[:, :, perm]
            g, gk = Gv, dict(g_spec=self._gen[2])
        else:
            rows = torch.as_tensor(np.asarray(self.Gi[0], np.int64),
                                   device=Qv.device)
            g = Gv.new_zeros((B, m)).index_add(1, rows, Gv)
            gk = dict(g_cols=self._g_ci)
        if n_pad > n:
            # Dummy tail variables: q = 1 (added in _band_blocks), p = 0,
            # no inequality rows, zero A columns.
            p = torch.nn.functional.pad(p, (0, n_pad - n))
            if A is not None:
                A = torch.nn.functional.pad(A, (0, n_pad - n))
        return (Qd, Qe, p, g, h, A), gk

    def _unband(self, z):
        """The solver's z back in the pattern's order and size."""
        if self.structure == "general":
            return z[:, torch.as_tensor(self._gen[1], device=z.device)]
        return z[:, :self._band[0]]

    def _operands(self, Qv, p, Gv, h, Av, b):
        """Values on the device, the tier, and the tier's operands:
        (q, p, g, h, A, b) for "diag", (Q, p, G, h, A, b) for "dense", the
        banded solver's operands with the G keyword for "banded" and
        "general"."""
        dev = _device(self.device)
        Qv, p, Gv, h, Av, b = (_to(v, dev) for v in (Qv, p, Gv, h, Av, b))
        idx = {k: torch.as_tensor(getattr(self, k), dtype=torch.long,
                                  device=dev) for k in ("Qi", "Gi", "Ai")}
        A = (_densify(idx["Ai"], Av, self.Asz) if self.neq > 0 else None)
        b = b if self.neq > 0 else None
        tier = self._tier(Qv)
        if tier == "diag":
            n = self.Qsz[0]
            return tier, (_diag_of(idx["Qi"], Qv, n), p,
                          _diag_of(idx["Gi"], Gv, n), h, A, b), {}, dev
        if tier in ("banded", "general"):
            ops, gk = self._band_operands(Qv, p, Gv, h, A)
            return tier, ops + (b,), gk, dev
        return tier, (_densify(idx["Qi"], Qv, self.Qsz), p,
                      _densify(idx["Gi"], Gv, self.Gsz), h, A, b), {}, dev

    def __call__(self, Qv, p, Gv, h, Av, b):
        """Solve; differentiable in (Qv, p, Gv, h, Av, b)."""
        tier, args, gk, dev = self._operands(Qv, p, Gv, h, Av, b)
        if tier == "diag":
            return solve_qp_diag(*args, config=self.config, device=dev)
        if tier in ("banded", "general"):
            return self._unband(solve_qp_banded(
                *args, config=self.config, device=dev, **gk))
        return solve_qp(*args, config=self.config, device=dev)

    def solve_full(self, Qv, p, Gv, h, Av, b, init=None):
        """Forward-only solve returning the full primal-dual solution and
        ``SolveStats`` from whichever tier the pattern dispatched to.
        ``init``: optional warm start (x, s, z, y) in the pattern's order,
        e.g. the previous solve's (z, s, lam, nu); the banded and general
        tiers permute and pad it here. Not differentiable."""
        tier, args, gk, dev = self._operands(Qv, p, Gv, h, Av, b)
        if tier == "diag":
            return solve_qp_diag_full(*args, config=self.config, init=init,
                                      device=dev)
        if tier in ("banded", "general"):
            if init is not None:
                n, _, _, n_pad = self._band
                x0, s0, z0, y0 = (_to(v, dev) for v in init)
                if tier == "general":
                    x0 = x0[:, torch.as_tensor(self._gen[0], device=dev)]
                if n_pad > n:
                    x0 = torch.nn.functional.pad(x0, (0, n_pad - n))
                init = (x0, s0, z0, y0)
            sol = solve_qp_banded_full(*args, config=self.config, init=init,
                                       device=dev, **gk)
            return sol._replace(z=self._unband(sol.z))
        return solve_qp_full(*args, config=self.config, init=init,
                             device=dev)
