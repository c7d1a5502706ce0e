"""Hybrid blocked Cholesky past kernel A's fit (counterpart of
``qpth_tpu/ops/hybrid.py``).

Kernel A keeps one m x m tile of a QP in one thread block's shared memory,
so it factors m <= 237 in float32 and m <= 166 in float64
(``kernels.fits``). Past that, a batched SPD matrix T (B, m, m) is factored
by blocks of ``block`` columns, right-looking, as the JAX package does on
its TPU:

    for each block column j:
        G_j = inv(chol(D_j))       <- kernel A on the diagonal block
        P_j = T[i>j, j] G_j^T      <- batched GEMM (the panel)
        T[i>j, k>j] -= P_j P_j^T   <- batched GEMM, lower block triangle only

The factor is kept as ``HybridFactor`` (the diagonal blocks' inverse factors
G_j and the panels P_j = L[j+1:, j]); every solve on it is a blocked
substitution whose steps are batched matrix-vector or matrix-matrix
products. The panels, the trailing updates and the substitutions are
``torch.matmul`` in full float32 (the caller's ``ops/linalg.py::
full_precision``, the counterpart of ``precision=HIGHEST``); on CUDA they
run in cuBLAS, which is what the JAX package's XLA GEMMs are there. Only
the diagonal blocks reach a hand kernel: kernel A with the shift ``dinv``
as its own argument. On CPU tensors kernel A's plain version runs, so the
same functions are their own plain twin.

``block`` stays a function argument, as in the JAX package; its default is
``BLOCK``, chosen on the card (PERF.md §6).
"""

from __future__ import annotations

import torch

from .cuda import kernels
from .linalg import bmm, bmv, btmv

#: Default block width, from the block-size sweep of ``chip_smoke.py``
#: phase 10 at nz = nineq = 512 (PERF.md §6: 64 was the fastest of 64, 128
#: and 192 in float32 and of 64, 128 and 160 in float64, where kernel A's
#: dependent pivot steps outweigh the GEMMs' loss of size). It satisfies
#: ``kernels.fits(BLOCK, dtype)`` in both dtypes.
BLOCK = 64


def _factor_inv_block(D, dinv):
    """G = inv(chol(D + diag(dinv))) for the batch of diagonal blocks D
    (bD, kb, kb): kernel A, its plain version on the CPU. ``dinv`` (bd, kb)
    or None. D is a strided view of the block grid: one contiguous copy
    before the launch."""
    kb = D.shape[-1]
    if dinv is None:
        dinv = torch.zeros((D.shape[0], kb), dtype=D.dtype, device=D.device)
    dinv = dinv.expand(max(D.shape[0], dinv.shape[0]), kb).contiguous()
    return kernels.factor_inv(D.contiguous(), dinv)


class HybridFactor:
    """Blocked factor of a batch of SPD matrices: diagonal-block inverses
    ``Gs[j] = inv(L_jj)`` and sub-diagonal panels ``Ps[j] = L[j+1:, j]``
    (``Ps[-1]`` is None), for a matrix of order ``m`` cut at ``block``."""

    __slots__ = ("Gs", "Ps", "m", "block")

    def __init__(self, Gs, Ps, m, block):
        self.Gs, self.Ps, self.m, self.block = Gs, Ps, m, block


def _lower_block_grid(T, block):
    """The lower block triangle of T (b, m, m) as views: ``S[i][k]`` =
    block (i, k) for k <= i. The factorization never reads the strictly
    upper half."""
    m = T.shape[-1]
    starts = list(range(0, m, block))
    return [[T[:, i0:i0 + min(block, m - i0), k0:k0 + min(block, m - k0)]
             for k0 in starts[:bi + 1]]
            for bi, i0 in enumerate(starts)]


def _panel_update(S, G, j, nb):
    """Form block column j's panel (one GEMM per block row) and apply the
    trailing update to the lower block triangle. The grid's entries are
    replaced, never written into: the first block column's entries are
    views of the caller's T, which the IPM reuses every iteration. Each
    update is one fused GEMM, S[i][k] - P_i P_k^T (``torch.baddbmm``).
    Returns the panel P (b, m - start_{j+1}, kb_j)."""
    GT = G.transpose(-1, -2)
    prows = [bmm(S[i][j], GT) for i in range(j + 1, nb)]
    P = torch.cat(prows, dim=1) if len(prows) > 1 else prows[0]
    for i in range(j + 1, nb):
        Pi = prows[i - j - 1]
        for k in range(j + 1, i + 1):
            Pk = prows[k - j - 1]
            S[i][k] = torch.baddbmm(S[i][k], Pi, Pk.transpose(-1, -2),
                                    alpha=-1.0)
    return P


def factor_hybrid(T, block: int | None = None, dinv=None) -> HybridFactor:
    """Blocked Cholesky of batched SPD T (b, m, m), with ``dinv`` (B, m)
    the factor of T + diag(dinv): the shift goes to kernel A with each
    diagonal block, so the shifted matrix is never formed."""
    block = BLOCK if block is None else block
    m = T.shape[-1]
    S = _lower_block_grid(T, block)
    nb = len(S)
    Gs, Ps = [], []
    for j in range(nb):
        j0 = j * block
        kb = S[j][j].shape[-1]
        G = _factor_inv_block(
            S[j][j], dinv[:, j0:j0 + kb] if dinv is not None else None)
        Gs.append(G)
        Ps.append(_panel_update(S, G, j, nb) if j < nb - 1 else None)
    return HybridFactor(Gs, Ps, m, block)


def factor_solve_hybrid(T, v, block: int | None = None, dinv=None):
    """The blocked factor with its first solve: (HybridFactor, x) with
    (T + diag(dinv)) x = v."""
    fac = factor_hybrid(T, block=block, dinv=dinv)
    return fac, solve_hybrid(fac, v)


def _btmm(M, X):
    return bmm(M.transpose(-1, -2), X)


def _substitute(fac: HybridFactor, r, mv, tmv):
    """Solve (L L^T) x = r on the blocked factor, with ``mv`` / ``tmv`` the
    batched products M r and M^T r of the right-hand side's kind. Forward:
    y_j = G_j r_j, and each panel is applied to the whole remaining
    right-hand side; backward: x_j = G_j^T (y_j - P_j^T x_{k>j})."""
    ys = []
    for G, P in zip(fac.Gs, fac.Ps):
        kb = G.shape[-1]
        y = mv(G, r[:, :kb])
        ys.append(y)
        r = r[:, kb:]
        if P is not None:
            r = r - mv(P, y)
    nb = len(fac.Gs)
    xs = [None] * nb
    for j in range(nb - 1, -1, -1):
        r = ys[j]
        if fac.Ps[j] is not None:
            r = r - tmv(fac.Ps[j], torch.cat(xs[j + 1:], dim=1))
        xs[j] = tmv(fac.Gs[j], r)
    return torch.cat(xs, dim=1)


def solve_hybrid(fac: HybridFactor, v):
    """Solve (L L^T) x = v for batched vectors v (B, m) on the blocked
    factor; every step is a batched matrix-vector product."""
    return _substitute(fac, v, bmv, btmv)


def solve_hybrid_mat(fac: HybridFactor, V):
    """Multi-right-hand-side solve (L L^T) X = V for V (b, m, k): the
    substitution of :func:`solve_hybrid` with every step a batched GEMM.
    The prefactor builds Q^-1 G^T and Q^-1 A^T with it from Q's blocked
    factor, without forming Q^-1."""
    return _substitute(fac, V, bmm, _btmm)


def spd_inv_hybrid(M, block: int | None = None):
    """Explicit batched SPD inverse from the blocked factor: the blocked
    solve on the identity. The prefactor's S11^-1 takes it where neq is
    past kernel A's fit."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)[None]
    return solve_hybrid_mat(factor_hybrid(M, block=block), eye)
