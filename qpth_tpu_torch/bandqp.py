"""Differentiable block-tridiagonal (banded) QP layer (counterpart of
``qpth_tpu/bandqp.py``): batched QPs

    min_x 1/2 x^T Q x + p^T x   s.t.  G x <= h,  A x = b

with Q block-tridiagonal (Qd the (nb, bs, bs) diagonal blocks, Qe the
(nb-1, bs, bs) subdiagonal blocks; the superdiagonal blocks are the implied
transposes) and G separable (every inequality row touches one variable:
diagonal G, box stacks [I; -I], variable bounds; see ``g_cols``) or an
arbitrary fixed pattern (``g_spec``), with implicit-KKT gradients to
(Qd, Qe, p, g, h, A, b). The gradients are the block restriction of the
dense ones: dQ = 1/2 (dx z^T + z dx^T) gives
dQd_i = 1/2 (dx_i z_i^T + z_i dx_i^T) and, since Qe parameterizes both the
(i+1, i) block and its transpose, dQe_i = dx_{i+1} z_i^T + z_{i+1} dx_i^T.

``SpQPFunction`` dispatches here for banded and general COO patterns (the
MPC-chain and fixed-pattern graph workloads).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import QPSolution, SolverConfig
from .core import banded as band_core
from .ops.linalg import full_precision
from .qp import DEFAULT_CONFIG, _device, _init_to, _to
from .utils import bger, normalize_constraints


def _canon_banded(Qd, Qe, p, g, h, A, b):
    """Blocks at minimal batch (1 when shared), vectors expanded to
    (B, ·) (``expand``'s backward sums the cotangent of an unbatched one).
    Returns the canonical tensors and meta = (B, p_unb, g_unb, h_unb,
    b_unb)."""
    A, b = normalize_constraints(A, b)
    Qd = Qd if Qd.dim() == 4 else Qd.unsqueeze(0)
    Qe = Qe if Qe.dim() == 4 else Qe.unsqueeze(0)
    vecs = (p, g, h)
    B = max([v.shape[0] if v.dim() == 2 else 1 for v in vecs]
            + [Qd.shape[0]])
    if b is not None:
        B = max(B, b.shape[0] if b.dim() == 2 else 1)
    unb = [v.dim() == 1 for v in vecs]

    def vec(v):
        v = v.unsqueeze(0) if v.dim() == 1 else v
        return v.expand(B, v.shape[-1])

    pb, gb, hb = map(vec, vecs)
    if A is not None:
        Ab = A.unsqueeze(0) if A.dim() == 2 else A
        bb = vec(b)
        unb.append(b.dim() == 1)
    else:
        Ab = bb = None
        unb.append(False)
    return Qd, Qe, pb, gb, hb, Ab, bb, (B, *unb)


class _BandCore(torch.autograd.Function):
    """z* with the implicit-KKT backward (the JAX package's custom_vjp).
    The warm start carries no gradient."""

    @staticmethod
    def forward(ctx, Qd, Qe, pb, gb, hb, Ab, bb, init, config, g_cols,
                g_spec, meta):
        with full_precision():
            sol = band_core.solve_banded(Qd, Qe, pb, gb, hb, Ab, bb, config,
                                         init=init, g_cols=g_cols,
                                         gen_g=g_spec)
        ctx.config, ctx.meta = config, meta
        ctx.g_cols, ctx.g_spec = g_cols, g_spec
        ctx.save_for_backward(sol.z, sol.lam, sol.s, sol.nu, Qd, Qe, gb, Ab)
        return sol.z

    @staticmethod
    def backward(ctx, dl_dz):
        with full_precision():
            grads = _backward(ctx, dl_dz)
        return grads + (None,) * 5


def _backward(ctx, dl_dz):
    """One banded KKT solve with RHS (dl/dz, 0, 0, 0); returns the
    cotangents of (Qd, Qe, pb, gb, hb, Ab, bb)."""
    zhat, lam, s, nu, Qd, Qe, gb, Ab = ctx.saved_tensors
    config, g_cols, spec = ctx.config, ctx.g_cols, ctx.g_spec
    B_global, p_unb, g_unb, h_unb, b_unb = ctx.meta
    B, n = zhat.shape
    nb, bs = Qd.shape[1], Qd.shape[-1]
    neq = Ab.shape[-2] if Ab is not None else 0

    c = config.grad_clamp
    d = torch.clamp(lam, min=c) / torch.clamp(s, min=c)
    dx, _, dlam, dnu = band_core.solve_kkt_banded(
        Qd, Qe, gb, Ab, d, dl_dz, config, g_cols=g_cols, gen_g=spec)

    # Block restriction of the dense gradient assembly.
    dx_b = dx.reshape(B, nb, bs)
    z_b = zhat.reshape(B, nb, bs)
    dQd = 0.5 * (bger(dx_b, z_b) + bger(z_b, dx_b))
    if nb > 1:
        dQe = (bger(dx_b[:, 1:], z_b[:, :-1])
               + bger(z_b[:, 1:], dx_b[:, :-1]))
    else:
        dQe = dl_dz.new_zeros((B, 0, bs, bs))
    if spec is not None:
        # Pattern restriction of dG = dlam z^T + lam dx^T: entry k is
        # (rows[k], cols[k]).
        gr = torch.as_tensor(spec.rows.astype(np.int64), device=dx.device)
        gc = torch.as_tensor(spec.cols.astype(np.int64), device=dx.device)
        dg = dlam[:, gr] * zhat[:, gc] + lam[:, gr] * dx[:, gc]
    elif g_cols is not None:
        # Separable G: row r touches column g_cols[r] alone.
        ci = torch.as_tensor(np.asarray(g_cols, np.int64), device=dx.device)
        dg = dlam * zhat[:, ci] + lam * dx[:, ci]
    else:
        dg = dlam * zhat + lam * dx
    dp, dh = dx, -dlam
    mean_mode = config.broadcast_grad_reduction == "mean"

    def rmat(gr_, canon_batch):
        if canon_batch == 1 and B > 1:
            gr_ = gr_.sum(dim=0, keepdim=True)
            if mean_mode:
                gr_ = gr_ / B_global
        return gr_

    dA = db = None
    if neq > 0:
        dA = rmat(bger(dnu, zhat) + bger(nu, dx), Ab.shape[0])
        db = -dnu

    def rvec(gr_, was_unb):
        # expand's backward sums; only "mean" needs a correction.
        if gr_ is not None and mean_mode and was_unb and B_global > 1:
            return gr_ / B_global
        return gr_

    return (rmat(dQd, Qd.shape[0]), rmat(dQe, Qe.shape[0]),
            rvec(dp, p_unb), rvec(dg, g_unb), rvec(dh, h_unb), dA,
            rvec(db, b_unb))


def _inputs(Qd, Qe, p, g, h, A, b, g_cols, g_spec, device):
    if g_cols is not None and g_spec is not None:
        raise ValueError("g_cols and g_spec are mutually exclusive")
    dev = _device(device)
    args = tuple(_to(v, dev) for v in (Qd, Qe, p, g, h, A, b))
    gc = None if g_cols is None else tuple(int(c) for c in g_cols)
    return args, gc, dev


def solve_qp_banded(Qd, Qe, p, g, h, A=None, b=None,
                    config: SolverConfig = DEFAULT_CONFIG, init=None,
                    g_cols=None, g_spec=None, device="cuda"):
    """Differentiable batched banded-structure QP solve; returns z* of
    shape (B, n).

    Qd: (B?, nb, bs, bs) symmetric diagonal blocks of Q; Qe: (B?, nb-1,
    bs, bs) subdiagonal blocks; p: (B?, n) with n = nb*bs.

    G is separable: g (B?, m) holds the row coefficients and ``g_cols``
    (static, length m) the column each row touches; g_cols=None means
    G = diag(g) with m = n; box constraints [I; -I] are
    g_cols = list(range(n)) * 2 with g = [1]*n + [-1]*n. Alternatively
    ``g_spec`` (:class:`qpth_tpu_torch.GeneralG`) describes an arbitrary
    fixed-pattern sparse G; ``g`` is then the (B?, nnz) entry values and
    its gradient lands on the pattern. h: (B?, m); A: (B?, neq, n) or
    None; b matching. Unbatched parameters receive summed (or, with
    ``broadcast_grad_reduction='mean'``, averaged) cotangents. ``init``:
    a warm start (x, s, z, y) with full-batch shapes; carries no
    gradient. Runs on ``device`` (CUDA unless asked for the CPU)."""
    args, gc, dev = _inputs(Qd, Qe, p, g, h, A, b, g_cols, g_spec, device)
    Qd, Qe, pb, gb, hb, Ab, bb, meta = _canon_banded(*args)
    return _BandCore.apply(Qd, Qe, pb, gb, hb, Ab, bb, _init_to(init, dev),
                           config, gc, g_spec, meta)


def solve_qp_banded_full(Qd, Qe, p, g, h, A=None, b=None,
                         config: SolverConfig = DEFAULT_CONFIG, init=None,
                         g_cols=None, g_spec=None,
                         device="cuda") -> QPSolution:
    """Forward-only banded-structure solve returning the full primal-dual
    solution and ``SolveStats`` (not differentiable). Same G contract as
    :func:`solve_qp_banded`."""
    args, gc, dev = _inputs(Qd, Qe, p, g, h, A, b, g_cols, g_spec, device)
    Qd, Qe, pb, gb, hb, Ab, bb, _ = _canon_banded(*args)
    with torch.no_grad(), full_precision():
        return band_core.solve_banded(Qd, Qe, pb, gb, hb, Ab, bb, config,
                                      init=_init_to(init, dev), g_cols=gc,
                                      gen_g=g_spec)
