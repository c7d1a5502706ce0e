"""Differentiable batched QP layer (counterpart of ``qpth_tpu/qp.py``).

Solves, for every element of a batch,

    z* = argmin_z 1/2 z^T Q z + p^T z   s.t.  G z <= h

and gives gradients to Q, p, G and h by implicit differentiation of the KKT
conditions at the solution: one extra solve on the cached factorization
(a ``torch.autograd.Function``).

Shapes: Q (B, nz, nz) or (nz, nz); p (B, nz) or (nz,); G (B, nineq, nz)
or (nineq, nz); h (B, nineq) or (nineq,). Shared matrices keep batch dim 1
and are factored once.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; inputs are moved there. Without CUDA, a call that did not
ask for the CPU raises. On CUDA the kernels run, on the CPU their plain
PyTorch versions.
"""

from __future__ import annotations

import torch

from . import scaling as scaling_mod
from .config import SolverConfig
from .core import pdipm
from .ops import kkt as kkt_ops
from .ops.linalg import (full_precision, bmv, btmv,
                         spd_check_eager)
from .utils import as_batched, bger, extract_nbatch, normalize_constraints

DEFAULT_CONFIG = SolverConfig()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qpth_tpu_torch: CUDA is not available; pass device='cpu' to "
            "solve on the CPU")
    return dev


def _to(x, dev):
    if x is None:
        return None
    return torch.as_tensor(x).to(dev)


def _inputs(Q, p, G, h, A, b, device, init=None):
    """Move the inputs to the device and refuse what is not ported."""
    dev = _device(device)
    Q, p, G, h, A, b = (_to(v, dev) for v in (Q, p, G, h, A, b))
    if normalize_constraints(A, b) != (None, None):
        raise NotImplementedError(
            "equality constraints (A, b) — ROADMAP.md §1 item 8")
    if normalize_constraints(G, h) == (None, None):
        raise NotImplementedError(
            "nineq == 0 (the closed-form equality solver) — "
            "ROADMAP.md §1 item 8")
    if init is not None:
        raise NotImplementedError(
            "warm starts (init=) — ROADMAP.md §1 item 10")
    return Q, p, G, h


def _canonicalize(Q, p, G, h):
    """Matrices at minimal batch (1 when shared), vectors expanded to the
    full batch. ``expand`` makes autograd sum the cotangent of an
    unbatched vector."""
    B = extract_nbatch(Q, p, G, h, None, None)
    Qb, _ = as_batched(Q, 3)
    Gb, _ = as_batched(G, 3)
    pb, p_unb = as_batched(p, 2)
    hb, h_unb = as_batched(h, 2)
    pb = pb.expand(B, pb.shape[-1])
    hb = hb.expand(B, hb.shape[-1])
    return Qb, pb, Gb, hb, (B, p_unb, h_unb)


def _build_factors(Qb, Gb, config: SolverConfig) -> kkt_ops.KKTFactors:
    """One-time prefactorization, Ruiz-equilibrated first where
    ``equilibrate`` says so. With the probe ("auto"), well-scaled data
    takes the light branch: the factors stay in original coordinates
    (``scaling`` = identity) and the Ruiz scalings act only through
    ``sem_scaling``; other data is scaled before factoring."""
    modes = kkt_ops.resolve_prefactor_modes(config, Qb.dtype)
    if not scaling_mod.resolve_equilibrate(config, Qb.dtype):
        return kkt_ops.pre_factor_kkt(Qb, Gb, **modes)
    probe = config.equilibrate == "auto"
    sc, ok = scaling_mod.ruiz_scalings(Qb, Gb, iters=config.ruiz_iters,
                                       probe=probe)
    if probe and ok:
        f = kkt_ops.pre_factor_kkt(Qb, Gb, **modes)
        return f._replace(scaling=scaling_mod.identity_like(sc),
                          sem_scaling=sc)
    f = kkt_ops.pre_factor_kkt(scaling_mod.scale_Q(Qb, sc),
                               scaling_mod.scale_G(Gb, sc), **modes)
    return f._replace(scaling=sc, sem_scaling=sc)


def _forward_batched(Qb, pb, Gb, hb, config: SolverConfig, factors=None):
    """Forward solve on canonical inputs; returns (solution, factors)."""
    pdipm.check_config(config, Qb.dtype)
    if config.check_Q_spd:
        spd_check_eager(Qb)
    if factors is None:
        factors = _build_factors(Qb, Gb, config)
    return pdipm.solve(Qb, pb, Gb, hb, factors, config), factors


class _QPCore(torch.autograd.Function):
    """z* with the implicit-KKT backward (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, Qb, pb, Gb, hb, factors, config, meta):
        with full_precision():
            sol, factors = _forward_batched(Qb, pb, Gb, hb, config,
                                            factors)
        ctx.factors = factors if config.save_factors_for_backward else None
        ctx.config, ctx.meta = config, meta
        ctx.save_for_backward(sol.z, sol.lam, sol.s, Qb, Gb)
        return sol.z

    @staticmethod
    def backward(ctx, dl_dz):
        with full_precision():
            dQ, dp, dG, dh = _backward(ctx, dl_dz)
        return dQ, dp, dG, dh, None, None, None


def _backward(ctx, dl_dz):
    """One KKT solve on the cached factors (RHS (dl/dz, 0, 0))."""
    zhat, lam, s, Qb, Gb = ctx.saved_tensors
    config = ctx.config
    B_global, p_unb, h_unb = ctx.meta
    B = dl_dz.shape[0]
    nineq = Gb.shape[-2]
    factors = ctx.factors
    if factors is None:
        factors = _build_factors(Qb, Gb, config)

    # Numerical-safety clamp of upstream qpth's backward.
    c = config.grad_clamp
    d = torch.clamp(lam, min=c) / torch.clamp(s, min=c)

    # Equilibrated factors solve the scaled KKT system: map the cotangent
    # and the complementarity diagonal in, the directions out.
    sc = factors.scaling
    if sc is not None:
        d = d * (sc.c / (sc.RG * sc.RG))
        dl_dz = dl_dz * (sc.c * sc.E)

    backend = kkt_ops.resolve_backend(zhat.dtype, nineq, zhat.device)
    fs = backend.prepare(factors)
    iQ_dl = kkt_ops.apply_invQ(fs, dl_dz)
    rhs_T = -btmv(fs.invQ_GT, dl_dz)                  # -G Q^-1 dl
    _, dlam = backend.factor_solve(fs.R, d, rhs_T)
    dx = -iQ_dl - bmv(fs.invQ_GT, dlam)
    if sc is not None:
        dx = dx * sc.E
        dlam = dlam * (sc.RG / sc.c)

    dQ = 0.5 * (bger(dx, zhat) + bger(zhat, dx))
    dp = dx
    dG = bger(dlam, zhat) + bger(lam, dx)
    dh = -dlam

    mean_mode = config.broadcast_grad_reduction == "mean"

    def reduce_mat(g, canon_batch):
        if canon_batch == 1 and B > 1:
            g = g.sum(dim=0, keepdim=True)
            if mean_mode:
                g = g / B_global
        return g

    def reduce_vec(g, was_unbatched):
        # expand's backward sums; only "mean" needs a correction.
        if mean_mode and was_unbatched and B_global > 1:
            return g / B_global
        return g

    return (reduce_mat(dQ, Qb.shape[0]), reduce_vec(dp, p_unb),
            reduce_mat(dG, Gb.shape[0]), reduce_vec(dh, h_unb))


def solve_qp(Q, p, G, h, A=None, b=None,
             config: SolverConfig = DEFAULT_CONFIG, init=None,
             factors=None, device="cuda"):
    """Differentiable batched QP solve; returns z* of shape (B, nz).

    Gradients flow to Q, p, G and h. Parameters passed without a batch
    dimension receive summed (``broadcast_grad_reduction='sum'``) or
    averaged (``'mean'``, upstream qpth's behavior) cotangents.
    ``factors``: a cached :func:`prefactor_qp` result for fixed (Q, G)."""
    Q, p, G, h = _inputs(Q, p, G, h, A, b, device, init)
    Qb, pb, Gb, hb, meta = _canonicalize(Q, p, G, h)
    return _QPCore.apply(Qb, pb, Gb, hb, factors, config, meta)


def solve_qp_full(Q, p, G, h, A=None, b=None,
                  config: SolverConfig = DEFAULT_CONFIG, init=None,
                  factors=None, device="cuda"):
    """Forward-only solve returning the full primal-dual solution and
    ``SolveStats``. Not differentiable; use :func:`solve_qp` for
    gradients."""
    Q, p, G, h = _inputs(Q, p, G, h, A, b, device, init)
    Qb, pb, Gb, hb, _ = _canonicalize(Q, p, G, h)
    with torch.no_grad(), full_precision():
        return _forward_batched(Qb, pb, Gb, hb, config, factors)[0]


def prefactor_qp(Q, G, A=None, config: SolverConfig = DEFAULT_CONFIG,
                 device="cuda"):
    """One-time KKT pre-factorization of fixed (Q, G) for repeated solves
    (``factors=`` of :func:`solve_qp` / :func:`solve_qp_full`). The
    ``config`` must match the one later passed to the solve."""
    dev = _device(device)
    A = _to(A, dev)
    if normalize_constraints(A, A) != (None, None):
        raise NotImplementedError(
            "equality constraints (A) — ROADMAP.md §1 item 8")
    Qb, _ = as_batched(_to(Q, dev), 3)
    Gb, _ = as_batched(_to(G, dev), 3)
    with torch.no_grad(), full_precision():
        return _build_factors(Qb, Gb, config)


def QPFunction(eps: float = 1e-12, verbose: int = 0,
               notImprovedLim: int = 3, maxIter: int = 20,
               check_Q_spd: bool = True, device="cuda", **kwargs):
    """Upstream qpth's factory: returns ``fn(Q, p, G, h, A=None, b=None)
    -> z``, differentiable. Extra keyword arguments go to
    :class:`SolverConfig`."""
    config = SolverConfig(eps=eps, verbose=verbose,
                          not_improved_lim=notImprovedLim, max_iter=maxIter,
                          check_Q_spd=check_Q_spd, **kwargs)

    def fn(Q, p, G, h, A=None, b=None):
        return solve_qp(Q, p, G, h, A, b, config=config, device=device)

    return fn
