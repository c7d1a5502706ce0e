"""Differentiable batched QP layer (counterpart of ``qpth_tpu/qp.py``).

Solves, for every element of a batch,

    z* = argmin_z 1/2 z^T Q z + p^T z   s.t.  G z <= h,  A z = b

and gives gradients to all six parameters by implicit differentiation of
the KKT conditions at the solution: one extra solve on the cached
factorization (a ``torch.autograd.Function``).

Shapes: Q (B, nz, nz) or (nz, nz); p (B, nz) or (nz,); G (B, nineq, nz)
or (nineq, nz); h (B, nineq) or (nineq,); A (B, neq, nz), (neq, nz), None
or zero-sized; b (B, neq), (neq,), None or zero-sized. Shared matrices keep
batch dim 1 and are factored once.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; inputs are moved there. Without CUDA, a call that did not
ask for the CPU raises. On CUDA the kernels run, on the CPU their plain
PyTorch versions.
"""

from __future__ import annotations

import dataclasses

import torch

from . import scaling as scaling_mod
from .config import QPSolution, QPSolvers, SolverConfig, SolveStats
from .core import pdipm
from .ops import kkt as kkt_ops
from .ops.linalg import (bmv, btmv, cho_solve, cho_solve_vec, cholesky,
                         full_precision, spd_check_eager)
from .profiling import span
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


def _inputs(Q, p, G, h, A, b, device):
    """Move the inputs to the device; empty constraints become None."""
    dev = _device(device)
    Q, p, G, h, A, b = (_to(v, dev) for v in (Q, p, G, h, A, b))
    return (Q, p) + normalize_constraints(G, h) + normalize_constraints(A, b)


def _init_to(init, dev):
    if init is None:
        return None
    return tuple(_to(v, dev) for v in init)


def _canonicalize(Q, p, G, h, A, b):
    """Matrices at minimal batch (1 when shared), vectors expanded to the
    full batch. ``expand`` makes autograd sum the cotangent of an
    unbatched vector."""
    B = extract_nbatch(Q, p, G, h, A, b)
    Qb, _ = as_batched(Q, 3)
    Gb, _ = as_batched(G, 3)
    Ab, _ = as_batched(A, 3)
    vecs, unb = [], []
    for v in (p, h, b):
        vb, v_unb = as_batched(v, 2)
        vecs.append(None if vb is None else vb.expand(B, vb.shape[-1]))
        unb.append(v_unb)
    pb, hb, bb = vecs
    return Qb, pb, Gb, hb, Ab, bb, (B, *unb)


def _build_factors(Qb, Gb, Ab, config: SolverConfig,
                   prefactor=None) -> kkt_ops.KKTFactors:
    """One-time prefactorization, Ruiz-equilibrated first where
    ``equilibrate`` says so. With the probe ("auto"), well-scaled data
    takes the light branch: the factors stay in original coordinates
    (``scaling`` = identity) and the Ruiz scalings act only through
    ``sem_scaling``; other data is scaled before factoring. ``prefactor``
    replaces ``kkt_ops.pre_factor_kkt`` (same arguments and result; the
    tensor-parallel prefactor of ``parallel.intra``)."""
    pre = prefactor or kkt_ops.pre_factor_kkt
    modes = kkt_ops.resolve_prefactor_modes(config, Qb.dtype)
    with span("qpth.prefactor"):
        if not scaling_mod.resolve_equilibrate(config, Qb.dtype):
            return pre(Qb, Gb, Ab, **modes)
        probe = config.equilibrate == "auto"
        sc, ok = scaling_mod.ruiz_scalings(
            Qb, Gb, Ab, iters=config.ruiz_iters, probe=probe,
            group=config.process_group)
        if probe and ok:
            f = pre(Qb, Gb, Ab, **modes)
            return f._replace(scaling=scaling_mod.identity_like(sc),
                              sem_scaling=sc)
        f = pre(scaling_mod.scale_Q(Qb, sc), scaling_mod.scale_G(Gb, sc),
                scaling_mod.scale_A(Ab, sc), **modes)
        return f._replace(scaling=sc, sem_scaling=sc)


def _forward_batched(Qb, pb, Gb, hb, Ab, bb, config: SolverConfig,
                     init=None, factors=None):
    """Forward solve on canonical inputs; returns (solution, factors), the
    factors None for the CPU oracle, which keeps none."""
    if config.check_Q_spd:
        spd_check_eager(Qb)
    if config.solver == QPSolvers.CPU_ORACLE:
        return _oracle_forward(Qb, pb, Gb, hb, Ab, bb), None
    if config.solver != QPSolvers.PDIPM_BATCHED:
        raise ValueError(config.solver)
    if factors is None:
        factors = _build_factors(Qb, Gb, Ab, config)
    return pdipm.solve(Qb, pb, Gb, hb, Ab, bb, factors, config,
                       init=init), factors


def _oracle_forward(Qb, pb, Gb, hb, Ab, bb) -> QPSolution:
    """``QPSolvers.CPU_ORACLE``: every lane solved in float64 on the host
    (upstream qpth's per-instance CVXPY loop) by the native C++ oracle
    (``native/``) where it builds, else by ``solvers/oracle.py``, as the JAX
    package chooses; the results come back in the inputs' dtype on their
    device. Stats report 0 iterations and every lane converged, as the JAX
    package's do."""
    from . import native
    from .solvers.oracle import solve_qp_batch_np

    B = pb.shape[0]
    dev, dt = pb.device, pb.dtype

    def host(v):
        if v is None:
            return None
        with span("qpth.sync"):
            return v.detach().cpu().numpy()

    solve = (native.solve_qp_batch_native if native.is_available()
             else solve_qp_batch_np)
    out = solve(*(host(v) for v in (Qb, pb, Gb, hb, Ab, bb)))
    x, nu, lam, s = (torch.as_tensor(v).to(dev, dt) for v in out)
    stats = SolveStats(
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
        best_resids=torch.zeros((B,), dtype=dt, device=dev),
        mu=torch.zeros((B,), dtype=dt, device=dev),
        converged=torch.ones((B,), dtype=torch.bool, device=dev))
    return QPSolution(z=x, nu=nu, lam=lam, s=s, stats=stats)


class _QPCore(torch.autograd.Function):
    """z* with the implicit-KKT backward (the JAX package's custom_vjp).
    The warm start and the cached factors carry no gradient: the solution
    does not depend on the starting point, and gradients to (Q, G, A) flow
    through the implicit-KKT formulas. A refined forward returns a float64
    z from float32 inputs; the backward runs in the inputs' dtype."""

    @staticmethod
    def forward(ctx, Qb, pb, Gb, hb, Ab, bb, init, factors, config, meta):
        with span("qpth.solve"), full_precision():
            sol, factors = _forward_batched(Qb, pb, Gb, hb, Ab, bb, config,
                                            init, factors)
        ctx.factors = factors if config.save_factors_for_backward else None
        ctx.config, ctx.meta = config, meta
        ctx.save_for_backward(sol.z, sol.lam, sol.s, sol.nu, Qb, Gb, Ab)
        return sol.z

    @staticmethod
    def backward(ctx, dl_dz):
        with span("qpth.backward"), full_precision():
            grads = _backward(ctx, dl_dz)
        return grads + (None, None, None, None)


def _kkt_directions(factors, Gb, Ab, zhat, lam, s, dl_dz, config):
    """The backward's KKT solve on ``factors``: the directions (dx, dlam,
    dnu) in the problem's own coordinates, dnu None without equality
    rows."""
    nineq = Gb.shape[-2]
    neq = Ab.shape[-2] if Ab is not None else 0
    # Numerical-safety clamp of upstream qpth's backward.
    c = config.grad_clamp
    d = torch.clamp(lam, min=c) / torch.clamp(s, min=c)

    # Equilibrated factors solve the scaled KKT system: map the cotangent
    # and the complementarity diagonal in, the directions out. Only the
    # substitution-mode branch reads the (scaled) G and A.
    sc = factors.scaling
    Gs, As = Gb, Ab
    if sc is not None:
        d = d * (sc.c / (sc.RG * sc.RG))
        dl_dz = dl_dz * (sc.c * sc.E)
        if factors.invQ_GT is None:
            Gs = scaling_mod.scale_G(Gb, sc)
            As = scaling_mod.scale_A(Ab, sc)

    backend = kkt_ops.resolve_backend(config.use_pallas, zhat.dtype, nineq,
                                      zhat.device)
    fs = kkt_ops.prepare_factors(factors)
    if fs.invQ_GT is not None:
        # Inverse mode: the RHS and back-substitution products fold into
        # the cached Q^-1 G^T / Q^-1 A^T; G and A are never read.
        iQ_dl = kkt_ops.apply_invQ(fs, dl_dz)
        rhs_T = -btmv(fs.invQ_GT, dl_dz)              # -G Q^-1 dl
        if neq > 0:
            u = bmv(fs.invS11, -btmv(fs.invQ_AT, dl_dz))
            rhs_T = rhs_T - bmv(fs.S21, u)
        _, dlam = backend.factor_solve(fs.R, d, rhs_T)
        dx = -iQ_dl - bmv(fs.invQ_GT, dlam)
        dnu = None
        if neq > 0:
            dnu = u - bmv(fs.W, dlam)
            dx = dx - bmv(fs.invQ_AT, dnu)
    else:
        rhs_T, u = kkt_ops.prepare_rhs_kkt(fs, d, Gs, As, dl_dz, None,
                                           None, None, backend.q_solve2)
        _, dz_sol = backend.factor_solve(fs.R, d, rhs_T)
        dx, _, dlam, dnu = kkt_ops.backsub_kkt(
            fs, dz_sol, u, d, Gs, As, dl_dz, None, backend.q_solve2)
    if sc is not None:
        dx = dx * sc.E
        dlam = dlam * (sc.RG / sc.c)
        if neq > 0:
            dnu = dnu * (sc.RA / sc.c)
    return dx, dlam, dnu


def _redo_broken_lanes(dx, dlam, dnu, Qb, Gb, Ab, zhat, lam, s, dl_dz,
                       config):
    """Where R (G Q^-1 G^T on the null space of A) has rank at most
    nz - neq < nineq, T = R + diag(s / lam) is positive definite on R's
    null space through its diagonal alone. On a lane whose forward ends
    with more constraints pinned than R's rank, s / lam there (1e-7 and
    below) falls under R's rounding below float64: T rounds to not SPD,
    and the lane's factor, and so its directions, come back NaN. Such
    lanes alone are solved again from factors built in float64 at the same
    point (zhat, lam, s); the others keep their directions bit for bit.
    One host read."""
    with span("qpth.sync"):
        idx = (~torch.isfinite(dlam).all(dim=1)).nonzero().squeeze(1)
    if idx.numel() == 0:
        return dx, dlam, dnu

    def lanes(v):
        if v is None:
            return None
        v = v if v.shape[0] == 1 else v[idx]
        return v.to(torch.float64)

    # These lanes are this process's alone: no batch-sharded reduction.
    config = dataclasses.replace(config, process_group=None)
    Q64, G64, A64 = lanes(Qb), lanes(Gb), lanes(Ab)
    redo = _kkt_directions(_build_factors(Q64, G64, A64, config), G64, A64,
                           lanes(zhat), lanes(lam), lanes(s), lanes(dl_dz),
                           config)
    return tuple(None if v is None else v.index_copy(0, idx, r.to(v.dtype))
                 for v, r in zip((dx, dlam, dnu), redo))


def _backward(ctx, dl_dz):
    """One KKT solve on the cached factors (RHS (dl/dz, 0, 0, 0)); returns
    the cotangents of (Qb, pb, Gb, hb, Ab, bb)."""
    zhat, lam, s, nu, Qb, Gb, Ab = ctx.saved_tensors
    dt = Qb.dtype
    if dl_dz.dtype != dt:
        # A refined forward's float64 solution: the backward solves with
        # the working-dtype factors and returns cotangents in the inputs'
        # dtype.
        dl_dz = dl_dz.to(dt)
        zhat, lam, s, nu = (v.to(dt) for v in (zhat, lam, s, nu))
    config = ctx.config
    B_global, p_unb, h_unb, b_unb = ctx.meta
    B = dl_dz.shape[0]
    neq = Ab.shape[-2] if Ab is not None else 0
    factors = ctx.factors
    if factors is None:
        factors = _build_factors(Qb, Gb, Ab, config)

    with span("qpth.backward.solve"):
        dx, dlam, dnu = _kkt_directions(factors, Gb, Ab, zhat, lam, s,
                                        dl_dz, config)
        nz, nineq = Qb.shape[-1], Gb.shape[-2]
        if dt != torch.float64 and nineq > nz - neq:
            dx, dlam, dnu = _redo_broken_lanes(dx, dlam, dnu, Qb, Gb, Ab,
                                               zhat, lam, s, dl_dz, config)

    with span("qpth.backward.grads"):
        dQ = 0.5 * (bger(dx, zhat) + bger(zhat, dx))
        dp = dx
        dG = bger(dlam, zhat) + bger(lam, dx)
        dh = -dlam
        dA = db = None
        if neq > 0:
            dA = bger(dnu, zhat) + bger(nu, dx)
            db = -dnu

        mean_mode = config.broadcast_grad_reduction == "mean"

        def reduce_mat(g, M):
            if g is not None and M.shape[0] == 1 and B > 1:
                g = g.sum(dim=0, keepdim=True)
                if mean_mode:
                    g = g / B_global
            return g

        def reduce_vec(g, was_unbatched):
            # expand's backward sums; only "mean" needs a correction.
            if (g is not None and mean_mode and was_unbatched
                    and B_global > 1):
                return g / B_global
            return g

        return (reduce_mat(dQ, Qb), reduce_vec(dp, p_unb),
                reduce_mat(dG, Gb), reduce_vec(dh, h_unb),
                reduce_mat(dA, Ab), reduce_vec(db, b_unb))


def solve_qp(Q, p, G, h, A=None, b=None,
             config: SolverConfig = DEFAULT_CONFIG, init=None,
             factors=None, device="cuda"):
    """Differentiable batched QP solve; returns z* of shape (B, nz).

    Gradients flow to all six parameters. Parameters passed without a
    batch dimension receive summed (``broadcast_grad_reduction='sum'``) or
    averaged (``'mean'``, upstream qpth's behavior) cotangents.

    ``init``: optional warm start (x, s, z, y) with full-batch shapes (y
    may be None); carries no gradient. ``factors``: a cached
    :func:`prefactor_qp` result for fixed (Q, G, A).

    ``nineq == 0`` (G/h None or zero-sized) dispatches to the closed-form
    equality solver :func:`solve_qp_eq`, differentiable by plain autograd."""
    Q, p, G, h, A, b = _inputs(Q, p, G, h, A, b, device)
    if G is None:
        return _solve_qp_eq_core(Q, p, A, b)[0]
    Qb, pb, Gb, hb, Ab, bb, meta = _canonicalize(Q, p, G, h, A, b)
    return _QPCore.apply(Qb, pb, Gb, hb, Ab, bb, _init_to(init, Qb.device),
                         factors, config, meta)


def solve_qp_full(Q, p, G, h, A=None, b=None,
                  config: SolverConfig = DEFAULT_CONFIG, init=None,
                  factors=None, device="cuda"):
    """Forward-only solve returning the full primal-dual solution and
    ``SolveStats``. Not differentiable; use :func:`solve_qp` for
    gradients. Takes the same warm start (pass the previous solution's
    (z, s, lam, nu) as (x, s, z, y)) and cached ``factors``.

    ``nineq == 0`` dispatches to the closed-form equality solver; ``lam``
    and ``s`` come back zero-width and the stats report convergence."""
    Q, p, G, h, A, b = _inputs(Q, p, G, h, A, b, device)
    with span("qpth.solve"), torch.no_grad(), full_precision():
        if G is None:
            x, y = _solve_qp_eq_core(Q, p, A, b)
            B = x.shape[0]
            empty = x.new_zeros((B, 0))
            stats = SolveStats(
                iterations=torch.ones((), dtype=torch.int32,
                                      device=x.device),
                best_resids=x.new_zeros((B,)), mu=x.new_zeros((B,)),
                converged=torch.ones((B,), dtype=torch.bool,
                                     device=x.device))
            return QPSolution(z=x, nu=y, lam=empty, s=empty, stats=stats)
        Qb, pb, Gb, hb, Ab, bb, _ = _canonicalize(Q, p, G, h, A, b)
        return _forward_batched(Qb, pb, Gb, hb, Ab, bb, config,
                                _init_to(init, Qb.device), factors)[0]


def prefactor_qp(Q, G, A=None, config: SolverConfig = DEFAULT_CONFIG,
                 device="cuda"):
    """One-time KKT pre-factorization of fixed (Q, G, A) for repeated
    solves (``factors=`` of :func:`solve_qp` / :func:`solve_qp_full`). The
    ``config`` must match the one later passed to the solve."""
    dev = _device(device)
    A = _to(A, dev)
    A, _ = normalize_constraints(A, A)
    Qb, _ = as_batched(_to(Q, dev), 3)
    Gb, _ = as_batched(_to(G, dev), 3)
    Ab, _ = as_batched(A, 3)
    with torch.no_grad(), full_precision():
        return _build_factors(Qb, Gb, Ab, config)


def solve_qp_eq(Q, p, A=None, b=None, device="cuda"):
    """Equality-constrained (or unconstrained) batched QP

        min_x 1/2 x^T Q x + p^T x   s.t.  A x = b

    in closed form through the Schur complement of the saddle system (one
    Cholesky of Q, one of A Q^-1 A^T; no IPM iterations). Differentiable
    by plain autograd. Returns x of shape (B, nz)."""
    Q, p, _, _, A, b = _inputs(Q, p, None, None, A, b, device)
    return _solve_qp_eq_core(Q, p, A, b)[0]


def _solve_qp_eq_core(Q, p, A, b):
    """(x, y) of the closed-form equality-constrained solve, y the
    equality duals ((B, 0) when A is None). Inputs are on their device
    with empty constraints already None."""
    B = extract_nbatch(Q, p, None, None, A, b)
    Qb, _ = as_batched(Q, 3)
    pb, _ = as_batched(p, 2)
    pb = pb.expand(B, pb.shape[-1])
    with full_precision():
        L_Q = cholesky(Qb)
        if A is None:
            x = cho_solve_vec(L_Q, -pb)
            return x, x.new_zeros((B, 0))
        Ab, _ = as_batched(A, 3)
        bb, _ = as_batched(b, 2)
        bb = bb.expand(B, bb.shape[-1])
        invQ_AT = cho_solve(L_Q, Ab.transpose(-1, -2))
        L_S = cholesky(torch.matmul(Ab, invQ_AT))
        y = -cho_solve_vec(L_S, bb + bmv(Ab, cho_solve_vec(L_Q, pb)))
        y = y.expand(B, y.shape[-1])
        x = cho_solve_vec(L_Q, -pb - btmv(Ab, y))
        return x, y


def QPFunction(eps: float = 1e-12, verbose: int = 0,
               notImprovedLim: int = 3, maxIter: int = 20,
               solver: QPSolvers = QPSolvers.PDIPM_BATCHED,
               check_Q_spd: bool = True, device="cuda", **kwargs):
    """Upstream qpth's factory: returns ``fn(Q, p, G, h, A=None, b=None)
    -> z``, differentiable. The positional parameters are upstream qpth's,
    in its order; ``device`` follows them. Extra keyword arguments go to
    :class:`SolverConfig`."""
    config = SolverConfig(eps=eps, verbose=verbose,
                          not_improved_lim=notImprovedLim, max_iter=maxIter,
                          solver=solver, check_Q_spd=check_Q_spd, **kwargs)

    def fn(Q, p, G, h, A=None, b=None):
        return solve_qp(Q, p, G, h, A, b, config=config, device=device)

    return fn
