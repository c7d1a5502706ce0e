"""Differentiable diagonal-structure QP layer (counterpart of
``qpth_tpu/diagqp.py``): batched QPs

    min_x 1/2 x^T diag(q) x + p^T x   s.t.  diag(g) x <= h,  A x = b

with implicit-KKT gradients to (q, p, g, h, A, b). The gradient formulas
are the diagonal restriction of the dense ones: dQ = 1/2 (dx z^T + z dx^T)
has diagonal dx*z, and dG = dlam z^T + lam dx^T has diagonal
dlam*z + lam*dx. ``SpQPFunction`` dispatches here when its COO patterns
are diagonal (the sudoku layer's Q = eps*I, G = -I).
"""

from __future__ import annotations

import torch

from .config import QPSolution, SolverConfig
from .core import diag as diag_core
from .ops.linalg import full_precision
from .qp import DEFAULT_CONFIG, _device, _init_to, _to
from .utils import bger, normalize_constraints


def _canon_diag(q, p, g, h, A, b):
    """Vectors expanded to (B, n) (``expand``'s backward sums the cotangent
    of an unbatched one); A at minimal batch (1 when shared). Returns the
    canonical tensors and meta = (B, q_unb, p_unb, g_unb, h_unb, b_unb)."""
    A, b = normalize_constraints(A, b)
    vecs = (q, p, g, h)
    B = max(v.shape[0] if v.dim() == 2 else 1 for v in vecs)
    if b is not None:
        B = max(B, b.shape[0] if b.dim() == 2 else 1)
    unb = [v.dim() == 1 for v in vecs]

    def vec(v):
        v = v.unsqueeze(0) if v.dim() == 1 else v
        return v.expand(B, v.shape[-1])

    qb, pb, gb, hb = map(vec, vecs)
    if A is not None:
        Ab = A.unsqueeze(0) if A.dim() == 2 else A
        bb = vec(b)
        unb.append(b.dim() == 1)
    else:
        Ab = bb = None
        unb.append(False)
    return qb, pb, gb, hb, Ab, bb, (B, *unb)


class _DiagCore(torch.autograd.Function):
    """z* with the implicit-KKT backward (the JAX package's custom_vjp).
    The warm start carries no gradient."""

    @staticmethod
    def forward(ctx, qb, pb, gb, hb, Ab, bb, init, config, meta):
        with full_precision():
            sol = diag_core.solve_diag(qb, pb, gb, hb, Ab, bb, config,
                                       init=init)
        ctx.config, ctx.meta = config, meta
        ctx.save_for_backward(sol.z, sol.lam, sol.s, sol.nu, qb, gb, Ab)
        return sol.z

    @staticmethod
    def backward(ctx, dl_dz):
        with full_precision():
            grads = _backward(ctx, dl_dz)
        return grads + (None, None, None)


def _backward(ctx, dl_dz):
    """One structured KKT solve with RHS (dl/dz, 0, 0, 0); returns the
    cotangents of (qb, pb, gb, hb, Ab, bb)."""
    zhat, lam, s, nu, qb, gb, Ab = ctx.saved_tensors
    config = ctx.config
    B_global, q_unb, p_unb, g_unb, h_unb, b_unb = ctx.meta
    B, n = zhat.shape
    neq = Ab.shape[-2] if Ab is not None else 0

    c = config.grad_clamp
    d = torch.clamp(lam, min=c) / torch.clamp(s, min=c)
    H = qb + gb * gb * d
    use_kernels = diag_core.use_kernels_m(dl_dz.dtype, neq)
    fac = (diag_core._m_factor(Ab, 1.0 / H, use_kernels)
           if neq > 0 else None)
    dx, _, dlam, dnu = diag_core.solve_kkt_diag(
        qb, gb, Ab, d, H, fac, dl_dz, None, None, None, B, n, dl_dz.dtype)

    dq = dx * zhat
    dp = dx
    dg = dlam * zhat + lam * dx
    dh = -dlam
    mean_mode = config.broadcast_grad_reduction == "mean"
    dA = db = None
    if neq > 0:
        dA = bger(dnu, zhat) + bger(nu, dx)
        db = -dnu
        if Ab.shape[0] == 1 and B > 1:
            dA = dA.sum(dim=0, keepdim=True)
            if mean_mode:
                dA = dA / B_global

    def rvec(gr, was_unb):
        # expand's backward sums; only "mean" needs a correction.
        if gr is not None and mean_mode and was_unb and B_global > 1:
            return gr / B_global
        return gr

    return (rvec(dq, q_unb), rvec(dp, p_unb), rvec(dg, g_unb),
            rvec(dh, h_unb), dA, rvec(db, b_unb))


def _inputs(q, p, g, h, A, b, device):
    dev = _device(device)
    return tuple(_to(v, dev) for v in (q, p, g, h, A, b)), dev


def solve_qp_diag(q, p, g, h, A=None, b=None,
                  config: SolverConfig = DEFAULT_CONFIG, init=None,
                  device="cuda"):
    """Differentiable batched diagonal-structure QP solve; returns z* of
    shape (B, n).

    q, g: (B, n) or (n,) diagonals of Q and G (q > 0); p, h: (B, n) or
    (n,); A: (B, neq, n), (neq, n), None or zero-sized; b matching.
    Unbatched parameters receive summed (or, with
    ``broadcast_grad_reduction='mean'``, averaged) cotangents; a shared A
    receives the gradient summed over the batch. ``init``: a warm start
    (x, s, z, y) with full-batch shapes; carries no gradient."""
    (q, p, g, h, A, b), dev = _inputs(q, p, g, h, A, b, device)
    qb, pb, gb, hb, Ab, bb, meta = _canon_diag(q, p, g, h, A, b)
    return _DiagCore.apply(qb, pb, gb, hb, Ab, bb, _init_to(init, dev),
                           config, meta)


def solve_qp_diag_full(q, p, g, h, A=None, b=None,
                       config: SolverConfig = DEFAULT_CONFIG, init=None,
                       device="cuda") -> QPSolution:
    """Forward-only diagonal-structure solve returning the full
    primal-dual solution and ``SolveStats``. Not differentiable."""
    (q, p, g, h, A, b), dev = _inputs(q, p, g, h, A, b, device)
    qb, pb, gb, hb, Ab, bb, _ = _canon_diag(q, p, g, h, A, b)
    with torch.no_grad(), full_precision():
        return diag_core.solve_diag(qb, pb, gb, hb, Ab, bb, config,
                                    init=_init_to(init, dev))
