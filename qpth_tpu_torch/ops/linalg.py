"""Broadcast-aware batched dense linear algebra (counterpart of
``qpth_tpu/ops/linalg.py``).

Matrices carry a minimal batch dim (1 when shared). When a matrix is
shared and the vectors are batched, a batched matvec becomes one
(B, n) x (n, m) matrix product.

The JAX package pins ``precision=HIGHEST`` on every matmul because the
IPM's conditioning cannot tolerate reduced-precision products. The
counterpart here is :func:`full_precision`, which turns TF32 off for the
duration of a solve.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    """Run every float32 product in full float32: TF32 off for cuBLAS and
    cuDNN, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bmm(a, b):
    """Batched matmul with leading-dim broadcasting, (bA,m,k)x(bB,k,n)."""
    return torch.matmul(a, b)


def bmv(M, v):
    """Batched matrix-vector: (bM, m, n) x (B, n) -> (max(bM,B), m)."""
    if M.shape[0] == 1 and v.shape[0] != 1:
        return v @ M[0].transpose(0, 1)
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def btmv(M, v):
    """Batched transposed matvec: M^T v, (bM, m, n) x (B, m) -> (B, n)."""
    if M.shape[0] == 1 and v.shape[0] != 1:
        return v @ M[0]
    return torch.matmul(M.transpose(-1, -2), v.unsqueeze(-1)).squeeze(-1)


def cholesky(a):
    """Batched lower Cholesky. A non-SPD lane comes back with NaN in its
    lower triangle (the JAX package's semantics) instead of raising."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def cho_solve(L, rhs):
    """Solve (L L^T) X = rhs for matrix rhs (B, n, k), L (bL, n, n). With a
    shared factor the B right-hand sides fold into the column dimension:
    one multi-RHS solve instead of B small ones."""
    if L.shape[0] == 1 and rhs.shape[0] != 1:
        B, n, k = rhs.shape
        flat = rhs.permute(1, 0, 2).reshape(n, B * k)
        out = torch.cholesky_solve(flat, L[0])
        return out.reshape(n, B, k).permute(1, 0, 2)
    return torch.cholesky_solve(rhs, L)


def cho_solve_vec(L, v):
    """Solve (L L^T) x = v for vector rhs (B, n)."""
    return cho_solve(L, v.unsqueeze(-1)).squeeze(-1)


def add_diag(M, d):
    """M + diag(d) batched: (bM, n, n) + (B, n) -> (max, n, n)."""
    return M + torch.diag_embed(d)


def spd_check_eager(Q) -> None:
    """Raise if any lane of Q is not SPD (upstream qpth's check)."""
    _, info = torch.linalg.cholesky_ex(Q)
    if bool((info != 0).any()):
        raise RuntimeError("Q is not SPD.")
