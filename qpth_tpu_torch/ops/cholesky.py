"""Batched Cholesky factor, substitutions and triangular inverse
(counterparts of ``qpth_tpu/ops/pallas/cholesky.py`` and of the factor and
solve kernels of ``qpth_tpu/ops/pallas/lanes.py``).

Every function here is one of three hand-written kernels on a CUDA tensor
(its plain PyTorch version on a CPU tensor; ``ops/cuda/kernels.py``):

* kernel C, ``kernels.chol``: Lt = chol(R + diag(dinv))^T, with or without
  the shift, with or without a first solve;
* kernel D, ``kernels.cho_solve``: two triangular substitutions;
* kernel E, ``kernels.trinv``: the inverse of the triangular factor.

Factors are in the JAX package's transposed layout: Lt = L^T (B, n, n),
upper triangular with exact zeros below the diagonal. All tensors are
batch-major; a factor or matrix of batch 1 serves every lane.
"""

from __future__ import annotations

import torch

from .cuda import kernels


def cholesky_t(A):
    """Lt = chol(A)^T for batched SPD A (B, n, n) (``cholesky_t_pallas``).
    A lane that is not SPD comes back with NaN."""
    return kernels.chol(A.contiguous())


def cholesky(A):
    """Standard-layout L = chol(A), lower (``cholesky_pallas``)."""
    return cholesky_t(A).transpose(-1, -2)


def factor_kkt_t(R, d):
    """Lt = chol(R + diag(1/d))^T for R (1 or B, n, n) and d (B, n) > 0
    (``factor_kkt_t_pallas``, which forms 1/d itself)."""
    return kernels.chol(R.contiguous(), (1.0 / d).contiguous())


def trinv(Lt):
    """inv(L) from Lt = L^T: lower triangular, row layout
    (``trinv_pallas``)."""
    return kernels.trinv(Lt.contiguous())


def spd_inverse(A):
    """A^-1 for batched SPD A as invL^T invL (``spd_inverse``): kernel C
    without a shift, kernel E, then the Gram product by ``torch.matmul``,
    which is outside the Pallas kernels in the JAX package too."""
    invL = trinv(cholesky_t(A))
    return torch.matmul(invL.transpose(-1, -2), invL)


def cho_solve_vec_t(Lt, v):
    """x solving (L L^T) x = v from Lt = L^T (1 or B, n, n), v (B, n)
    (``cho_solve_vec_t_pallas``)."""
    return kernels.cho_solve(Lt.contiguous(), v.contiguous())


def factor_kkt(R, dinv):
    """Lt = chol(R + diag(dinv))^T (``lanes.py::factor_kkt_lanes``). The
    lanes layout (m_p, m_p, B) with its 128-lane padding is a TPU fact; this
    computes the same function on batch-major R (1 or B, m, m) and dinv
    (B, m) and returns Lt (B, m, m)."""
    return kernels.chol(R.contiguous(), dinv.contiguous())


def factor_solve_kkt(R, dinv, rhs):
    """(Lt, x) with (R + diag(dinv)) x = rhs, the solve run on the factor
    while it is on chip (``lanes.py::factor_solve_kkt_lanes``; batch-major,
    as :func:`factor_kkt`)."""
    return kernels.chol(R.contiguous(), dinv.contiguous(), rhs.contiguous())


def cho_solve(Lt, rhs):
    """x solving (L L^T) x = rhs from :func:`factor_kkt`'s Lt
    (``lanes.py::cho_solve_lanes``; batch-major: Lt (B, m, m), rhs
    (B, m))."""
    return kernels.cho_solve(Lt.contiguous(), rhs.contiguous())
