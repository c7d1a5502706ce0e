"""Single-instance primal-dual interior-point QP solver (counterpart of
``qpth_tpu/core/single.py``).

The unbatched exposition of the Mehrotra predictor-corrector algorithm that
:mod:`qpth_tpu_torch.core.pdipm` runs in batch (upstream qpth's
``solvers/pdipm/single.py``). Solves

    min_z 1/2 z^T Q z + p^T z   s.t.  G z <= h,  A z = b

for one QP with unbatched shapes. KKT strategy: Cholesky of Q and of
S11 = A Q^-1 A^T once, Cholesky of T = R + diag(1/d) per iteration, all by
``torch.linalg`` (the JAX package uses ``jax.scipy`` here: no Pallas kernel,
so no hand kernel either). The JAX package's ``lax.while_loop`` becomes a
Python loop with one host read of the score per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SolverConfig
from ..ops.linalg import cholesky, full_precision


class SingleSolution(NamedTuple):
    z: torch.Tensor           #: primal solution (nz,)
    nu: torch.Tensor          #: equality duals (neq,); zero-width if neq == 0
    lam: torch.Tensor         #: inequality duals (nineq,)
    s: torch.Tensor           #: slacks (nineq,)
    iterations: torch.Tensor  #: scalar int32
    resid: torch.Tensor       #: final residual score (scalar)


def _cho_solve(L, v):
    """(L L^T)^-1 v for a vector or a matrix right-hand side."""
    if v.dim() == 1:
        return torch.cholesky_solve(v.unsqueeze(-1), L).squeeze(-1)
    return torch.cholesky_solve(v, L)


def _factors(Q, G, A):
    """One-time factorizations (upstream qpth single.py:137-172)."""
    L_Q = cholesky(Q)
    invQ_GT = _cho_solve(L_Q, G.T)                    # (nz, nineq)
    R = G @ invQ_GT                                   # G Q^-1 G^T
    if A is None:
        return L_Q, R, None, None, None
    invQ_AT = _cho_solve(L_Q, A.T)                    # (nz, neq)
    S11 = A @ invQ_AT
    L_S11 = cholesky(S11)
    S21 = G @ invQ_AT                                 # (nineq, neq)
    W = _cho_solve(L_S11, S21.T)                      # (neq, nineq)
    R = R - S21 @ W
    return L_Q, R, L_S11, S21, W


def _solve_kkt(L_Q, R, L_S11, S21, W, G, A, d, rx, rs, rz, ry):
    """The unbatched Schur solve (upstream qpth single.py:103-134)."""
    L_T = cholesky(R + torch.diag(1.0 / d))
    invQ_rx = _cho_solve(L_Q, rx)
    r2 = G @ invQ_rx + rs / d - rz
    if A is None:
        dz = _cho_solve(L_T, -r2)
        dy = None
        g1 = -rx - G.T @ dz
    else:
        r1 = A @ invQ_rx - ry
        u = _cho_solve(L_S11, -r1)
        dz = _cho_solve(L_T, -r2 - S21 @ u)
        dy = u - W @ dz
        g1 = -rx - G.T @ dz - A.T @ dy
    dx = _cho_solve(L_Q, g1)
    ds = (-rs - dz) / d
    return dx, ds, dz, dy


def _step(v, dv):
    """Max alpha with v + alpha dv >= 0."""
    inf = torch.full_like(v, float("inf"))
    return torch.where(dv < 0, -v / dv, inf).min()


def solve_single(Q, p, G, h, A=None, b=None,
                 config: SolverConfig = SolverConfig(),
                 device="cuda") -> SingleSolution:
    """Solve ONE QP (unbatched shapes) on ``device`` (CUDA unless the
    caller asks for the CPU; inputs are moved there). For batches use
    :func:`qpth_tpu_torch.solve_qp`."""
    from ..qp import _device, _to

    dev = _device(device)
    Q, p, G, h, A, b = (_to(v, dev) for v in (Q, p, G, h, A, b))
    with torch.no_grad(), full_precision():
        return _solve(Q, p, G, h, A, b, config)


def _solve(Q, p, G, h, A, b, config):
    nz = p.shape[-1]
    nineq = G.shape[-2]
    neq = A.shape[-2] if A is not None else 0
    dtype, device = p.dtype, p.device

    L_Q, R, L_S11, S21, W = _factors(Q, G, A)

    def kkt(d, rx, rs, rz, ry):
        return _solve_kkt(L_Q, R, L_S11, S21, W, G, A, d, rx, rs, rz, ry)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    # Init: d = 1, RHS (p, 0, -h, -b); shift s, z to >= 1 (upstream qpth
    # single.py:19-38).
    x, s, z, y = kkt(torch.ones((nineq,), dtype=dtype, device=device), p,
                     zeros(nineq), -h, -b if neq > 0 else None)

    def shift(v):
        return torch.where(v.min() < 0, v - v.min() + 1.0, v)

    s, z = shift(s), shift(z)
    y = y if y is not None else zeros(0)

    def residuals(x, s, z, y):
        rx = Q @ x + p + G.T @ z
        if neq > 0:
            rx = rx + A.T @ y
            ry = A @ x - b
            pri_y = torch.linalg.vector_norm(ry)
        else:
            ry = None
            pri_y = torch.zeros((), dtype=dtype, device=device)
        rz = G @ x + s - h
        mu = torch.abs(torch.dot(s, z)) / nineq
        score = (pri_y + torch.linalg.vector_norm(rz)
                 + torch.linalg.vector_norm(rx) + nineq * mu)
        return rx, rz, ry, mu, score

    *_, resid = residuals(x, s, z, y)
    it = 0
    while it < config.max_iter and float(resid) > config.eps:
        rx, rz, ry, mu, _ = residuals(x, s, z, y)
        d = z / s
        dx_a, ds_a, dz_a, dy_a = kkt(d, rx, z, rz, ry)
        alpha = torch.clamp(torch.minimum(_step(z, dz_a), _step(s, ds_a)),
                            max=1.0)
        t1 = torch.dot(s + alpha * ds_a, z + alpha * dz_a)
        sig = (t1 / torch.dot(s, z)) ** 3
        rs_c = (-mu * sig + ds_a * dz_a) / s
        dx_c, ds_c, dz_c, dy_c = kkt(d, zeros(nz), rs_c, zeros(nineq),
                                     zeros(neq) if neq > 0 else None)
        dx, ds, dz = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c
        alpha = torch.clamp(
            0.999 * torch.minimum(_step(z, dz), _step(s, ds)), max=1.0)
        x = x + alpha * dx
        s = s + alpha * ds
        z = z + alpha * dz
        if neq > 0:
            y = y + alpha * (dy_a + dy_c)
        *_, resid = residuals(x, s, z, y)
        it += 1
    return SingleSolution(
        z=x, nu=y, lam=z, s=s,
        iterations=torch.tensor(it, dtype=torch.int32, device=device),
        resid=resid)
