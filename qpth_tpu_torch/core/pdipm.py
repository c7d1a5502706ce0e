"""Batched Mehrotra predictor-corrector primal-dual interior-point method
(counterpart of ``qpth_tpu/core/pdipm.py``).

Ported branch: the one the float32 defaults take, neq = 0, cached-product
("fast") algebra with tracked residuals (``resid_every`` k > 1),
coefficient-tracked x ("x-free" iterations) and one fused kernel per
iteration (kernel B, ``ops/cuda/kernels.py::ipm_step_xfree``). A float64
call with ``solve_method="inverse"`` and ``resid_every`` > 1 runs the same
branch. What it keeps from the JAX solver:

* init solve with d = 1 (in semantic coordinates) through the cached
  products, then the per-lane shift so s >= 1 and z >= 1, and the
  fail-soft restart of lanes whose init solve gave NaN;
* exact residual scores at checkpoints (every ``resid_every`` iterations),
  (1 - alpha)-scaled norms in between, and an exact rescore of the final
  iterate after the loop;
* element-wise best-iterate tracking; the not-improved window, per lane
  and latched with a nonzero improve margin, global with margin 0;
* equilibration: the iterates live in ``factors.scaling`` coordinates, the
  scoring and the init shift in ``factors.sem_scaling`` coordinates, and
  the result and stats come back in original coordinates.

The JAX loop is a ``lax.while_loop`` on the device. Here the loop is a
Python ``for`` with one host read of ``done`` per iteration, as upstream
qpth's loop does it; everything else stays on the device.
"""

from __future__ import annotations

import warnings

import torch

from ..config import (KKTSolver, QPSolution, QPSolvers, SolverConfig,
                      SolveStats, resolve_refine_steps)
from ..ops import kkt as kkt_ops
from ..ops.linalg import bmv, btmv


def resolve_resid_every(config: SolverConfig, dtype) -> int:
    """``SolverConfig.resid_every``: None = 1 at float64, 7 below."""
    if config.resid_every is not None:
        return config.resid_every
    return 1 if torch.empty((), dtype=dtype).element_size() >= 8 else 7


def check_config(config: SolverConfig, dtype) -> None:
    """Raise ``NotImplementedError`` for configurations whose branch is
    not ported yet (each names its ROADMAP item)."""
    if config.kkt_solver != KKTSolver.CHOL_PARTIAL:
        raise NotImplementedError(
            f"kkt_solver={config.kkt_solver} — ROADMAP.md §1 item 9")
    if config.solver == QPSolvers.CPU_ORACLE:
        raise NotImplementedError(
            "solver=QPSolvers.CPU_ORACLE — ROADMAP.md §1 item 12")
    kkt_ops.resolve_prefactor_modes(config, dtype)
    if resolve_resid_every(config, dtype) == 1:
        raise NotImplementedError(
            "resid_every=1 (untracked residuals, including the float64 "
            "default) — ROADMAP.md §1 item 7")
    if config.coeff_x is False:
        raise NotImplementedError(
            "coeff_x=False (direct x recurrence) — ROADMAP.md §1 item 10")
    if resolve_refine_steps(config, dtype)[0] > 0:
        raise NotImplementedError(
            "refine_steps > 0 (mixed-precision refinement) — "
            "ROADMAP.md §1 item 11")
    if config.escalate is not None:
        raise NotImplementedError(
            "escalate (oracle escalation) — ROADMAP.md §1 item 12")
    if config.verbose >= 1:
        raise NotImplementedError(
            "verbose >= 1 (per-iteration prints) — ROADMAP.md §1 item 14")


def solve(Q, p, G, h, factors: kkt_ops.KKTFactors,
          config: SolverConfig) -> QPSolution:
    """Run the batched IPM on one device. Q (bQ, nz, nz) and G
    (bG, nineq, nz) carry minimal batch dims; p (B, nz) and h (B, nineq)
    are full-batch. All parameters are in original (user) coordinates;
    ``factors`` comes from ``kkt_ops.pre_factor_kkt`` (possibly of the
    equilibrated problem, see ``factors.scaling``)."""
    B, nz = p.shape
    nineq = G.shape[-2]
    dtype, device = p.dtype, p.device

    sc = factors.scaling
    scaled = sc is not None
    if scaled:
        # Iterate coordinates (sc) vs semantic coordinates (sem): see the
        # JAX solver. In the probe's light branch sc is the identity.
        sem = factors.sem_scaling if factors.sem_scaling is not None else sc
        p_, h_ = p * (sc.c * sc.E), h * sc.RG
        c_flat = sc.c[..., 0]
        m_x, m_s, m_z = sc.E, 1.0 / sc.RG, sc.RG / sc.c
        sw_rx, sw_rz = sem.c * sem.E, sem.RG
        sem_c = sem.c[..., 0]
        ws_s = m_s * sem.RG
        ws_z = m_z * (sem.c / sem.RG)
    else:
        p_, h_ = p, h

    def to_orig(x, s, z):
        if not scaled:
            return x, s, z
        return x * m_x, s * m_s, z * m_z

    improve_margin = config.improve_margin
    if improve_margin is None:
        improve_margin = 0.0 if torch.empty(
            (), dtype=dtype).element_size() >= 8 else 1e-3
    per_lane_term = improve_margin > 0.0
    resid_every = resolve_resid_every(config, dtype)

    backend = kkt_ops.resolve_backend(dtype, nineq, device)
    fs = backend.prepare(factors)
    invQ_p = kkt_ops.apply_invQ(fs, p_)
    G_invQ_p = btmv(fs.invQ_GT, p_)
    q = -(h_ + G_invQ_p)
    q_t = backend.prepare_vec(q)

    # ---- Init: the fast predictor at (x, z) = 0 with d = 1 in semantic
    # coordinates (d_it = ws_s / ws_z in iterate coordinates). ----
    ones_m = (ws_s / ws_z if scaled
              else torch.ones((), dtype=dtype, device=device))
    ones_m = ones_m.expand(B, nineq).to(dtype).contiguous()
    zeros_m = torch.zeros((B, nineq), dtype=dtype, device=device)
    _, dz0 = backend.factor_solve_rz(fs.R, ones_m, q, zeros_m)
    s = (-zeros_m - dz0) / ones_m
    z = dz0
    x = -invQ_p - bmv(fs.invQ_GT, zeros_m + z)

    def shift_pos(v, w):
        vs = v * w if scaled else v
        mn = vs.amin(dim=-1, keepdim=True)
        vs = torch.where(mn < 0, vs - mn + 1.0, vs)
        return vs / w if scaled else vs

    s = shift_pos(s, ws_s if scaled else None)
    z = shift_pos(z, ws_z if scaled else None)

    # Fail-soft init: a lane whose init solve gave NaN restarts from the
    # neutral interior point (0, 1, 1) (the 1s in semantic coordinates).
    # The JAX solver also pre-arms an adaptive regularization for such a
    # lane, but the fused step never reads it, so it is not carried here.
    bad0 = (torch.isnan(x).any(-1) | torch.isnan(s).any(-1)
            | torch.isnan(z).any(-1)).unsqueeze(-1)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    x = torch.where(bad0, zero, x)
    s = torch.where(bad0, 1.0 / ws_s if scaled else one, s)
    z = torch.where(bad0, 1.0 / ws_z if scaled else one, z)

    # x-free mode: the x carry is the packed coefficient vector
    # [w (nineq) | e | c] with x = e x0 - c Q^-1 p - Q^-1 G^T w.
    pw = nineq
    x0_anchor = x

    def x_of(xp):
        return (xp[:, pw:pw + 1] * x0_anchor - xp[:, pw + 1:] * invQ_p
                - bmv(fs.invQ_GT, xp[:, :nineq]))

    def xp_step(xp, a_l, zeta):
        """One damped step on the packed coefficients (a_l = 0 on frozen
        lanes, whose zeta is masked: an exact no-op)."""
        a = a_l.unsqueeze(-1)
        na = 1.0 - a
        return torch.cat([na * xp[:, :nineq] + a * zeta,
                          na * xp[:, pw:pw + 1],
                          na * xp[:, pw + 1:] + a], dim=1)

    x = torch.cat([torch.zeros((B, pw), dtype=dtype, device=device),
                   torch.ones((B, 1), dtype=dtype, device=device),
                   torch.zeros((B, 1), dtype=dtype, device=device)], dim=1)

    def mu_sel_of(mu):
        return (mu / c_flat) * sem_c if scaled else mu

    def exact_pri_dual(x, s, z):
        """(pri, dual, pri_o, dual_o) from scratch, reading the original
        matrices; pri/dual in semantic coordinates."""
        xo, so, zo = to_orig(x, s, z)
        rx = bmv(Q, xo) + p + btmv(G, zo)
        rz = bmv(G, xo) + so - h
        pri_o = torch.linalg.vector_norm(rz, dim=-1)
        dual_o = torch.linalg.vector_norm(rx, dim=-1)
        if not scaled:
            return pri_o, dual_o, pri_o, dual_o
        return (torch.linalg.vector_norm(rz * sw_rz, dim=-1),
                torch.linalg.vector_norm(rx * sw_rx, dim=-1), pri_o, dual_o)

    inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
    best_x, best_s, best_z = x, s, z
    best_resids, best_resids_o = inf, inf
    mu = torch.zeros((B,), dtype=dtype, device=device)
    n_not = torch.zeros((B,) if per_lane_term else (), dtype=torch.int32,
                        device=device)
    lane_done = torch.zeros((B,), dtype=torch.bool, device=device)
    pri = dual = torch.zeros((B,), dtype=dtype, device=device)
    inc = max(resid_every, 1)
    iterations = 0

    for it in range(config.max_iter):
        iterations = it + 1
        mu = torch.abs((s * z).sum(dim=-1) / nineq)
        exact_now = (it == 0) if resid_every == 0 else it % resid_every == 0
        if exact_now:
            pri, dual, pri_o, dual_o = exact_pri_dual(x_of(x), s, z)
        resids = pri + dual + nineq * mu_sel_of(mu)

        # Only checkpoint (exactly scored) iterates enter the bookkeeping.
        if exact_now:
            resids_o = (pri_o + dual_o + nineq * (mu / c_flat) if scaled
                        else resids)
            improved_strict = resids < best_resids
            improved = resids < best_resids * (1.0 - improve_margin)
            best_resids = torch.where(improved_strict, resids, best_resids)
            if scaled:
                best_resids_o = torch.where(improved_strict, resids_o,
                                            best_resids_o)
            imp = improved_strict.unsqueeze(-1)
            best_x = torch.where(imp, x, best_x)
            best_s = torch.where(imp, s, best_s)
            best_z = torch.where(imp, z, best_z)
            if per_lane_term:
                n_not = torch.where(improved, 0, n_not + inc)
            else:
                n_not = torch.where(improved.any(), 0, n_not + inc)
        if per_lane_term:
            lane_done = lane_done | (n_not >= config.not_improved_lim)
            window_done = lane_done.all()
        else:
            window_done = n_not >= config.not_improved_lim
        # The current tracked score counts too, so a solve converging
        # between checkpoints exits promptly.
        max_best = torch.minimum(best_resids.amax(), resids.amax())
        done = (window_done | (max_best < config.eps)
                | (mu.amin() > config.mu_divergence))
        if bool(done):  # the one host read per iteration
            break

        zeta, s, z, a_l = backend.fused_step_xfree(fs.R, s, z, q_t,
                                                   config.n_correctors)
        x = xp_step(x, a_l, zeta)
        # The combined direction solves the Newton system exactly, so each
        # feasibility residual norm scales by (1 - alpha).
        pri, dual = pri * (1.0 - a_l), dual * (1.0 - a_l)

    x, best_x = x_of(x), x_of(best_x)

    # Exact rescore of the final iterate; it wins where it beats the
    # recorded checkpoint best.
    pri_f, dual_f, pri_fo, dual_fo = exact_pri_dual(x, s, z)
    mu_f = torch.abs((s * z).sum(dim=-1) / nineq)
    score_f = pri_f + dual_f + nineq * mu_sel_of(mu_f)
    take1 = score_f < best_resids
    take = take1.unsqueeze(-1)
    if scaled:
        score_fo = pri_fo + dual_fo + nineq * (mu_f / c_flat)
        best_resids_o = torch.where(take1, score_fo, best_resids_o)
    best_x = torch.where(take, x, best_x)
    best_s = torch.where(take, s, best_s)
    best_z = torch.where(take, z, best_z)
    best_resids = torch.minimum(score_f, best_resids)

    if config.verbose >= 0:
        max_best = float(best_resids.amax())
        if max_best > 1.0:
            warnings.warn(
                "qpth_tpu_torch: returning an inaccurate solution (max "
                f"residual {max_best:.3e} > 1); the problem may be "
                "infeasible or badly conditioned.", RuntimeWarning,
                stacklevel=3)

    its = torch.tensor(iterations, dtype=torch.int32, device=device)
    if scaled:
        mu_best_o = (torch.abs((best_s * best_z).sum(dim=-1)) / nineq
                     / c_flat)
        stats = SolveStats(iterations=its, best_resids=best_resids_o,
                           mu=mu_best_o,
                           converged=best_resids_o < config.eps)
    else:
        stats = SolveStats(iterations=its, best_resids=best_resids, mu=mu,
                           converged=best_resids < config.eps)

    bx, bs, bz = to_orig(best_x, best_s, best_z)
    return QPSolution(z=bx, nu=torch.zeros((B, 0), dtype=dtype,
                                           device=device),
                      lam=bz, s=bs, stats=stats)
