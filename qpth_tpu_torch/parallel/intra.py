"""Intra-QP (tensor) parallelism over ``torch.distributed`` (counterpart of
``qpth_tpu/parallel/intra.py``): one huge QP, or a few, split over the
ranks of a process group by the rows of its (m, m) blocks.

The JAX package annotates shardings and lets GSPMD place the collectives.
Here each rank holds a band of rows and the collectives are explicit, only
``broadcast`` and ``all_reduce`` (the two that gloo runs on CUDA tensors as
well as NCCL):

* :func:`factor_solve_hybrid_tp`: the blocked right-looking Cholesky of
  ``ops/hybrid.py`` with each rank holding a band of block rows of T. For
  each block column k the owning rank factors the diagonal block with
  kernel A and broadcasts inv(L_kk); every rank forms its own rows of the
  panel, one ``all_reduce`` of a zeroed buffer assembles the panel column
  on every rank, and each rank applies the triangle-only trailing update to
  its own rows. The factor stays sharded (:class:`TPFactor`); the
  substitutions run block row by block row, one ``broadcast`` (forward) or
  ``all_reduce`` (backward) per step, and leave x on every rank.
* :func:`prefactor_qp_tp`: the one-time Schur products split over the
  ranks by rows of G (``G Q^-1 G^T``, ``S21``, ``R``) or its columns
  (``Q^-1 G^T``, ``W``), assembled on every rank: the same ``KKTFactors``
  as :func:`qpth_tpu_torch.prefactor_qp`, replicated.
* :func:`solve_qp_tp`: the forward IPM with ``use_pallas="hybrid_xla"``
  whose every factor and solve of T goes through the distributed functions,
  R held as row bands. Q^-1 (or Q's factor) and the other cached products
  stay replicated.

Every rank calls each function with the same (replicated) inputs but T,
which each passes as its own band of rows. Ranks hold
``m // (BLOCK * P)`` block rows each, so m must be divisible by
``BLOCK * P`` (``ops/hybrid.py``'s BLOCK = 64).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from .. import qp as qp_mod
from ..config import SolverConfig
from ..core import pdipm
from ..ops import hybrid
from ..ops import kkt as kkt_ops
from ..ops.linalg import (bmm, bmv, btmv, cho_solve, cholesky,
                          full_precision, spd_check_eager)
from ..utils import as_batched, normalize_constraints


def _rank_world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _src(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group`` (broadcast's ``src``)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def tp_band(m: int, group, block: int | None = None) -> tuple[int, int]:
    """This rank's rows [r0, r1) of an (m, m) matrix split by block rows;
    raises ``ValueError`` unless m is divisible by ``block * P``."""
    block = hybrid.BLOCK if block is None else block
    rank, P = _rank_world(group)
    if m % (block * P) != 0:
        raise ValueError(
            f"m={m} must be divisible by {block} * {P} (the block times the "
            "ranks) so block rows align with ranks")
    rows = m // P
    return rank * rows, (rank + 1) * rows


class TPFactor:
    """This rank's rows of the blocked factor of T: for each owned block row
    i (global index), ``Gs[i]`` = inv(L_ii) and ``Ls[i]`` = L[i, :i], the
    row's blocks left of the diagonal, (b, block, i * block)."""

    __slots__ = ("Gs", "Ls", "m", "block", "nbr", "group")

    def __init__(self, Gs, Ls, m, block, nbr, group):
        self.Gs, self.Ls, self.m, self.block = Gs, Ls, m, block
        self.nbr, self.group = nbr, group

    def nbytes(self) -> int:
        """Bytes of this rank's blocks."""
        return sum(t.numel() * t.element_size()
                   for t in list(self.Gs.values()) + list(self.Ls.values()))


def factor_hybrid_tp(T_rows, *, group, dinv=None,
                     block: int | None = None) -> TPFactor:
    """Blocked Cholesky of the batched SPD T (b, m, m) shifted by
    diag(dinv) (dinv (B, m), replicated, or None), from this rank's band of
    rows ``T_rows`` (b, m / P, m). Per block column: kernel A on the
    owner's diagonal block, one ``broadcast`` of its inverse factor, the
    panel rows of every rank assembled by one ``all_reduce``, then each
    rank's trailing update of its own rows, lower block triangle only."""
    block = hybrid.BLOCK if block is None else block
    rank, P = _rank_world(group)
    m = T_rows.shape[-1]
    r0, r1 = tp_band(m, group, block)
    if T_rows.shape[-2] != r1 - r0:
        raise ValueError(f"T_rows holds {T_rows.shape[-2]} rows; rank "
                         f"{rank} of {P} owns {r1 - r0} of m={m}")
    nb = m // block
    nbr = nb // P
    first = rank * nbr
    own = range(first, first + nbr)
    # S[i][k]: block (i, k), k <= i, of the owned rows; views of T_rows
    # until the trailing updates replace them.
    S = {i: [T_rows[:, (i - first) * block:(i - first + 1) * block,
                    k * block:(k + 1) * block] for k in range(i + 1)]
         for i in own}
    bG = max(T_rows.shape[0], dinv.shape[0] if dinv is not None else 0)
    Gs, Ls = {}, {i: [] for i in own}
    for k in range(nb):
        k0 = k * block
        owner = k // nbr
        if owner == rank:
            G = hybrid._factor_inv_block(
                S[k][k], dinv[:, k0:k0 + block] if dinv is not None
                else None)
            Gs[k] = G
        else:
            G = T_rows.new_empty((bG, block, block))
        dist.broadcast(G, src=_src(group, owner), group=group)
        if k == nb - 1:
            break
        GT = G.transpose(-1, -2)
        mine = [i for i in own if i > k]
        panel = T_rows.new_zeros((bG, m - k0 - block, block))
        for i in mine:
            Pi = bmm(S[i][k], GT)
            Ls[i].append(Pi)
            panel[:, (i - k - 1) * block:(i - k) * block] = Pi
        dist.all_reduce(panel, op=dist.ReduceOp.SUM, group=group)
        for i in mine:
            Pi = Ls[i][-1]
            for j in range(k + 1, i + 1):
                Pj = panel[:, (j - k - 1) * block:(j - k) * block]
                S[i][j] = torch.baddbmm(S[i][j], Pi, Pj.transpose(-1, -2),
                                        alpha=-1.0)
    Ls = {i: (torch.cat(v, dim=-1) if v
              else T_rows.new_zeros((bG, block, 0))) for i, v in Ls.items()}
    return TPFactor(Gs, Ls, m, block, nbr, group)


def solve_hybrid_tp(fac: TPFactor, v):
    """Solve (L L^T) x = v for batched vectors v (B, m), replicated, on the
    sharded factor; x comes back on every rank. Forward substitution block
    row by block row, the owner of each row broadcasting its y_j; backward
    substitution from the last block row, one ``all_reduce`` per step that
    carries x_j from its owner and every rank's part of
    sum_i L_{i,j-1}^T x_i."""
    group, kb, nbr = fac.group, fac.block, fac.nbr
    rank, _ = _rank_world(group)
    nb = fac.m // kb
    bF = next(iter(fac.Gs.values())).shape[0]
    Bv = max(v.shape[0], bF)
    ys = []
    for j in range(nb):
        owner = j // nbr
        if owner == rank:
            r = v[:, j * kb:(j + 1) * kb]
            if j > 0:
                r = r - bmv(fac.Ls[j], torch.cat(ys, dim=1))
            y = bmv(fac.Gs[j], r).expand(Bv, kb).contiguous()
        else:
            y = v.new_empty((Bv, kb))
        dist.broadcast(y, src=_src(group, owner), group=group)
        ys.append(y)
    xs = [None] * nb
    acc = v.new_zeros((Bv, kb))
    for j in range(nb - 1, -1, -1):
        pack = v.new_zeros((Bv, 2 * kb if j > 0 else kb))
        if j // nbr == rank:
            pack[:, :kb] = btmv(fac.Gs[j], ys[j] - acc)
        if j > 0:
            c = None
            for i in fac.Ls:
                if i < j:
                    continue
                xi = pack[:, :kb] if i == j else xs[i]
                t = btmv(fac.Ls[i][:, :, (j - 1) * kb:j * kb], xi)
                c = t if c is None else c + t
            if c is not None:
                pack[:, kb:] = c
        dist.all_reduce(pack, op=dist.ReduceOp.SUM, group=group)
        xs[j] = pack[:, :kb]
        acc = pack[:, kb:]
    return torch.cat(xs, dim=1)


def factor_solve_hybrid_tp(T_rows, v, *, group, dinv=None,
                           block: int | None = None):
    """Tensor-parallel per-iteration factorization with its first solve:
    ``(TPFactor, x)`` with (T + diag(dinv)) x = v, T given by this rank's
    band of rows ``T_rows`` (b, m / P, m), v (B, m) and dinv (B, m)
    replicated, x replicated. m must be divisible by ``block * P``."""
    fac = factor_hybrid_tp(T_rows, group=group, dinv=dinv, block=block)
    return fac, solve_hybrid_tp(fac, v)


def tp_backend(group) -> kkt_ops.KKTBackend:
    """The hybrid backend over the distributed factor: ``fac`` of T is this
    rank's :class:`TPFactor`, ``R`` in the factors its band of rows."""

    def factor_solve(R, d, v):
        return factor_solve_hybrid_tp(R, v, group=group, dinv=1.0 / d)

    return kkt_ops.KKTBackend(
        solve2=solve_hybrid_tp, factor_solve=factor_solve,
        factor_solve_rz=kkt_ops.rz_by_substitution(factor_solve))


def _gather(part, n: int, dim: int, r0: int, group):
    """The whole of a tensor split along ``dim`` (length n) whose slice
    [r0, r0 + part.shape[dim]) this rank computed: a zeroed buffer with the
    part in place, summed over the group (one ``all_reduce``)."""
    shape = list(part.shape)
    shape[dim] = n
    buf = part.new_zeros(shape)
    buf.narrow(dim, r0, part.shape[dim]).copy_(part)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def pre_factor_kkt_tp(Q, G, A=None, *, inverse: bool = True,
                      blocked: bool = False, group, r_band: bool = False):
    """``kkt_ops.pre_factor_kkt`` with its Schur products split over the
    ranks by the nineq rows of G: each rank forms Q^-1 G_r^T, the rows
    G_r Q^-1 G^T, S21's rows and W's columns of its band, and each product
    is assembled on every rank by one ``all_reduce``. Q's own factor or
    inverse and the neq-sized products are formed on every rank. With
    ``r_band`` R stays this rank's band of rows (the tensor-parallel IPM's
    layout; ``GiGT`` then None), else the factors come back whole on every
    rank."""
    rank, P = _rank_world(group)
    m = G.shape[-2]
    r0, r1 = rank * m // P, (rank + 1) * m // P
    factor = kkt_ops._chol_kernel if blocked else cholesky
    GT = G.transpose(-1, -2)
    GT_r = GT[..., r0:r1]
    facQ = invQ = L_Q = None
    if inverse:
        invQ, facQ = kkt_ops._q_rep(Q)
        solveQ = (functools.partial(hybrid.solve_hybrid_mat, facQ)
                  if facQ is not None else functools.partial(bmm, invQ))
    else:
        L_Q = factor(Q)
        solveQ = functools.partial(cho_solve, L_Q)
    invQ_GT = _gather(solveQ(GT_r), m, -1, r0, group)       # (b, nz, m)
    GiGT_r = kkt_ops._bmm_t(GT_r, invQ_GT)                  # (b, m_r, m)
    inv_kw = dict(invQ_GT=invQ_GT) if inverse else {}
    if A is None:
        if r_band:
            return kkt_ops.KKTFactors(L_Q=L_Q, R=GiGT_r, L_S11=None,
                                      S21=None, W=None, invQ=invQ,
                                      facQ=facQ, **inv_kw)
        GiGT = _gather(GiGT_r, m, -2, r0, group)
        return kkt_ops.KKTFactors(L_Q=L_Q, R=GiGT, L_S11=None, S21=None,
                                  W=None, invQ=invQ, facQ=facQ,
                                  GiGT=GiGT if inverse else None, **inv_kw)
    AT = A.transpose(-1, -2)
    invQ_AT = solveQ(AT)                                    # (b, nz, neq)
    S11 = kkt_ops._bmm_t(AT, invQ_AT)
    S21 = _gather(kkt_ops._bmm_t(GT_r, invQ_AT), m, -2, r0, group)
    S21T_r = S21[:, r0:r1].transpose(-1, -2)
    if inverse:
        invS11, L_S11 = kkt_ops._spd_inv(S11), None
        W_r = bmm(invS11, S21T_r)
    else:
        invS11, L_S11 = None, factor(S11)
        W_r = cho_solve(L_S11, S21T_r)
    W = _gather(W_r, m, -1, r0, group)                      # (b, neq, m)
    R_r = GiGT_r - bmm(S21[:, r0:r1], W)
    extra = dict(invQ_AT=invQ_AT, S11=S11) if inverse else {}
    if r_band:
        return kkt_ops.KKTFactors(L_Q=L_Q, R=R_r, L_S11=L_S11, S21=S21, W=W,
                                  invQ=invQ, facQ=facQ, invS11=invS11,
                                  **inv_kw, **extra)
    R = _gather(R_r, m, -2, r0, group)
    GiGT = _gather(GiGT_r, m, -2, r0, group) if inverse else None
    return kkt_ops.KKTFactors(L_Q=L_Q, R=R, L_S11=L_S11, S21=S21, W=W,
                              invQ=invQ, facQ=facQ, invS11=invS11,
                              GiGT=GiGT, **inv_kw, **extra)


def prefactor_qp_tp(Q, G, A=None, *, group,
                    config: SolverConfig = qp_mod.DEFAULT_CONFIG,
                    device="cuda"):
    """Tensor-parallel one-time KKT pre-factorization: the Schur products
    of :func:`qpth_tpu_torch.prefactor_qp` split over the ranks of
    ``group`` (:func:`pre_factor_kkt_tp`), equilibrated as there. Every
    rank passes the same (Q, G, A) and gets the same ``KKTFactors``, whole
    (torch has no global sharded tensor), which ``solve_qp`` /
    ``solve_qp_full`` take as ``factors=`` unchanged."""
    dev = qp_mod._device(device)
    A = qp_mod._to(A, dev)
    A, _ = normalize_constraints(A, A)
    Qb, _ = as_batched(qp_mod._to(Q, dev), 3)
    Gb, _ = as_batched(qp_mod._to(G, dev), 3)
    Ab, _ = as_batched(A, 3)
    with torch.no_grad(), full_precision():
        return qp_mod._build_factors(
            Qb, Gb, Ab, config,
            prefactor=functools.partial(pre_factor_kkt_tp, group=group))


def solve_qp_tp(Q, p, G, h, A=None, b=None, *, group,
                config: SolverConfig = qp_mod.DEFAULT_CONFIG, init=None,
                device="cuda"):
    """End-to-end tensor-parallel IPM solve for a few huge QPs: the
    prefactor's Schur products split over the ranks, R kept as each rank's
    band of rows, and every per-iteration factor and solve of
    T = R + diag(1/d) through :func:`factor_solve_hybrid_tp` /
    :func:`solve_hybrid_tp`, with ``use_pallas="hybrid_xla"``. Every rank
    passes the same inputs and gets the same ``QPSolution`` (original
    coordinates, honest stats). nineq must be divisible by ``BLOCK * P``.
    Forward only: to train a huge-QP layer, differentiate
    :func:`qpth_tpu_torch.solve_qp` with ``factors=prefactor_qp_tp(...)``.

    Substitution mode (the float64 default) runs too: Q and S11 keep their
    Cholesky factors, replicated, and only T's algebra is distributed."""
    cfg = dataclasses.replace(config, use_pallas="hybrid_xla",
                              process_group=None)
    Q, p, G, h, A, b = qp_mod._inputs(Q, p, G, h, A, b, device)
    if G is None:
        raise ValueError("solve_qp_tp needs inequality constraints")
    Qb, pb, Gb, hb, Ab, bb, _ = qp_mod._canonicalize(Q, p, G, h, A, b)
    tp_band(Gb.shape[-2], group)
    with torch.no_grad(), full_precision():
        if cfg.check_Q_spd:
            spd_check_eager(Qb)
        factors = qp_mod._build_factors(
            Qb, Gb, Ab, cfg, prefactor=functools.partial(
                pre_factor_kkt_tp, group=group, r_band=True))
        return pdipm.solve(Qb, pb, Gb, hb, Ab, bb, factors, cfg,
                           init=qp_mod._init_to(init, Qb.device),
                           backend=tp_backend(group))
