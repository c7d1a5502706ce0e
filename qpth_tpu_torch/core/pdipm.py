"""Batched Mehrotra predictor-corrector primal-dual interior-point method
(counterpart of ``qpth_tpu/core/pdipm.py``): the IPM loop that the dense,
diagonal and banded tiers share, and the dense tier.

The loop is written once. A tier supplies its scoring (its residuals and
score, :class:`Score`), its step and its post-loop work; the rest is here:

* :func:`resolve_improve_margin` and :func:`start_point`: the init solve's
  per-lane shift so s >= 1 and z >= 1 (in semantic coordinates where the
  solve is equilibrated), warm starts clipped at ``warm_start_min``;
* :func:`ipm_loop`: element-wise best-iterate tracking on strict
  improvement, the not-improved window, per lane and latched with a
  nonzero improve margin, global with margin 0 (:func:`exit_test`), and the
  one host read of ``done`` per iteration, as upstream qpth's loop does it
  (the per-iteration print rides in the same read);
* :func:`pc_direction` and :func:`damped_update`: a composed step's
  Mehrotra direction with its Gondzio corrections, and the 0.999 step with
  every lane whose direction holds a NaN frozen;
* :func:`finish_stats`: the INACC warning and ``SolveStats``.

The dense tier, :func:`solve` on :class:`_Dense`, runs the partial-Cholesky
KKT strategy, with and without equality constraints, in the branches of the
JAX solver:

* ``fast``: inverse-mode factors; the RHS and back-substitution products
  fold into the cached Q^-1 G^T / Q^-1 A^T / S11 products. Otherwise
  (substitution mode, the float64 default) every iteration computes the
  residual vectors and solves through ``ops/kkt.py::solve_kkt``.
* ``track`` (fast, ``resid_every`` != 1): exact residual scores at
  checkpoints, (1 - alpha)-scaled norms in between, an exact rescore of the
  final iterate after the loop.
* the fused iteration, one kernel per iteration where the backend has it
  (the kernels backend) and it fits a thread block: ``ipm_step_eq`` with
  equality constraints, ``ipm_step_xfree`` (tracked, coefficient-tracked
  x) or ``ipm_step`` (the direct x recurrence: ``resid_every=1`` or
  ``coeff_x=False``) without. Otherwise the composed step: the backend's
  factor with its first solve (kernel A, kernel C under
  ``use_pallas="blocked"``, or the hybrid backend's blocked factor past
  kernel A's fit), then its ``solve2`` (``inv_solve``, kernel D or the
  blocked substitution) for the corrector and each Gondzio correction,
  with the per-lane adaptive regularization of the fail-soft path.
* ``xfree``: x carried as recurrence coefficients [w | v | e | c] with
  x = e x0 - c Q^-1 p - Q^-1 G^T w - Q^-1 A^T v, rebuilt at checkpoints.

Which step an iteration takes is chosen once, before the loop. Beside that
the dense tier keeps from the JAX solver the init solve with d = 1 (in
semantic coordinates) and the fail-soft restart of lanes whose init solve
gave NaN; equilibration: the iterates live in ``factors.scaling``
coordinates, the scoring and the init shift in ``factors.sem_scaling``
coordinates, and the result and stats come back in original coordinates.

After the loop, as in the JAX solver: mixed-precision refinement
(``SolverConfig.refine_steps``, or the eps dial: :func:`_refine`, float64
residuals with working-dtype solves on the backend's kernels, the result in
float64), then escalation of the lanes still above ``escalate_tol`` to the
float64 CPU oracle (:func:`_escalate_oracle`). ``KKTSolver.FULL`` and
``KKTSolver.IR`` replace the partial-Cholesky algebra by the full saddle
system (``ops/kkt.py``); ``verbose >= 1`` prints one line per iteration.

The JAX loop is a ``lax.while_loop`` on the device. Here the loop is a
Python ``for`` with one host read of ``done`` per iteration: an iteration
that finds ``done`` counts and does not step, as ``lax.cond(done,
identity, do_step)`` does there. Everything else stays on the device.
Refinement's early exit likewise reads the host once per step. The dense
solve's phases (``qpth.ipm.init``, ``finish``), the loop (``qpth.ipm.loop``
with its ``score``, ``exit`` and ``step`` per iteration), a composed step's
factor and solves (``qpth.ipm.step.factor``, ``.solve``) and each host read
(``qpth.sync``) are ``profiling.span``s: profiler ranges while
``torch.profiler`` records, no-ops otherwise.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional

import torch

from .. import scaling as scaling_mod
from ..config import (KKTSolver, QPSolution, QPSolutionLow, SolverConfig,
                      SolveStats, resolve_refine_steps)
from ..ops import kkt as kkt_ops
from ..ops.cuda import kernels
from ..ops.linalg import bmv, btmv
from ..profiling import span


def _is_f64(dtype) -> bool:
    return torch.empty((), dtype=dtype).element_size() >= 8


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def resolve_resid_every(config: SolverConfig, dtype) -> int:
    """``SolverConfig.resid_every``: None = 1 at float64, 7 below."""
    if config.resid_every is not None:
        return config.resid_every
    return 1 if _is_f64(dtype) else 7


def greduce(group, *terms):
    """Finish batch reductions over a ``torch.distributed`` process group
    (the JAX package's ``_greduce`` under shard_map). ``terms`` are
    (value, op) pairs, op "max" or "min", each value a 0-dim tensor.
    Without a group the values come back as they are. With one, they travel
    packed in one float64 vector on their device through one
    ``all_reduce(MAX)``, a min as the max of its negation, and come back in
    their own dtypes."""
    if group is None:
        return tuple(v for v, _ in terms)
    import torch.distributed as dist

    packed = torch.stack([v.to(torch.float64) if op == "max"
                          else -v.to(torch.float64) for v, op in terms])
    dist.all_reduce(packed, op=dist.ReduceOp.MAX, group=group)
    out = []
    for r, (v, op) in zip(packed, terms):
        r = r if op == "max" else -r
        out.append(r > 0.5 if v.dtype == torch.bool else r.to(v.dtype))
    return tuple(out)


def exit_test(config: SolverConfig, per_lane_term: bool, improved, n_not,
              lane_done, inc: int, scores, mu):
    """The IPM loop's exit test: the not-improved window, per lane and
    latched (``per_lane_term``) or global, advanced by ``inc`` where
    ``improved`` is given (a scoring event), the max of each per-lane score
    in ``scores`` (the smallest of those maxima) below eps, and min(mu)
    above the divergence guard. Every batch reduction is finished over
    ``config.process_group`` in one :func:`greduce`; the window's counter
    takes the reduced ``any(improved)``. Returns (n_not, lane_done, done),
    ``done`` a 0-dim bool tensor on the device."""
    lim = config.not_improved_lim
    if per_lane_term:
        if improved is not None:
            n_not = torch.where(improved, 0, n_not + inc)
        lane_done = lane_done | (n_not >= lim)
        window = lane_done.all()
    else:
        window = (improved.any() if improved is not None
                  else torch.zeros((), dtype=torch.bool, device=mu.device))
    red = greduce(config.process_group,
                  (window, "min" if per_lane_term else "max"),
                  *((v.amax(), "max") for v in scores), (mu.amin(), "min"))
    if per_lane_term:
        window_done = red[0]
    else:
        if improved is not None:
            n_not = torch.where(red[0], 0, n_not + inc)
        window_done = n_not >= lim
    max_best = red[1]
    for v in red[2:-1]:
        max_best = torch.minimum(max_best, v)
    return n_not, lane_done, (window_done | (max_best < config.eps)
                              | (red[-1] > config.mu_divergence))


def warn_inaccurate(config: SolverConfig, best_resids, advice: str = ""):
    """The INACC warning (upstream qpth's INACC_ERR) where the batch's
    best residual, reduced over ``config.process_group``, exceeds 1."""
    max_best = greduce(config.process_group, (best_resids.amax(), "max"))[0]
    with span("qpth.sync"):
        max_best = float(max_best)
    if max_best > 1.0:
        warnings.warn(
            "qpth_tpu_torch: returning an inaccurate solution (max "
            f"residual {max_best:.3e} > 1); the problem may be "
            "infeasible or badly conditioned." + advice,
            RuntimeWarning, stacklevel=5)


def _step_to_boundary(v, dv):
    """Per-lane max step with v + a dv >= 0 (NaN propagates)."""
    inf = torch.full_like(v, float("inf"))
    return torch.where(dv < 0, -v / dv, inf).amin(dim=-1)




def _nan_lanes(dx, ds, dz, dy):
    """Per-lane mask (B,) of a direction that holds a NaN; dx and dy may
    be None."""
    bad = torch.isnan(ds).any(-1) | torch.isnan(dz).any(-1)
    if dx is not None:
        bad = bad | torch.isnan(dx).any(-1)
    if dy is not None:
        bad = bad | torch.isnan(dy).any(-1)
    return bad


def _step_min(s, z, ds, dz):
    """Per-lane max step keeping s and z nonnegative."""
    return torch.minimum(_step_to_boundary(z, dz), _step_to_boundary(s, ds))


# ---------------------------------------------------------------------------
# The loop shared by the dense, diagonal and banded tiers
# ---------------------------------------------------------------------------

def resolve_improve_margin(config: SolverConfig, dtype) -> float:
    """``SolverConfig.improve_margin``: None = 0 at float64 (upstream
    qpth's global window), 1e-3 below (per-lane latched windows)."""
    if config.improve_margin is not None:
        return config.improve_margin
    return 0.0 if _is_f64(dtype) else 1e-3


def _shift_pos(v, w=None):
    """v shifted per lane so that its least entry is 1 where it was
    negative, in the coordinates v * w (w None: v's own)."""
    vs = v * w if w is not None else v
    mn = vs.amin(dim=-1, keepdim=True)
    vs = torch.where(mn < 0, vs - mn + 1.0, vs)
    return vs / w if w is not None else vs


def start_point(config: SolverConfig, init, solve_init, B: int, dtype,
                device, ws=None):
    """The loop's first iterate (x, s, z, y). Without ``init``, the tier's
    init solve ``solve_init()`` (d = 1, RHS (p, 0, -h, -b)) with s and z
    each shifted per lane to >= 1; with it, the warm start with s and z
    clipped at ``config.warm_start_min``. ``ws`` = (ws_s, ws_z): the
    weights from iterate to semantic coordinates of an equilibrated solve,
    in which the shift and the clip are made. y is (B, 0) without equality
    rows."""
    if init is None:
        x, s, z, y = solve_init()
        s = _shift_pos(s, ws[0] if ws is not None else None)
        z = _shift_pos(z, ws[1] if ws is not None else None)
    else:
        x, s, z, y = init
        if ws is not None:
            s = torch.maximum(s, config.warm_start_min / ws[0])
            z = torch.maximum(z, config.warm_start_min / ws[1])
        else:
            s = torch.clamp(s, min=config.warm_start_min)
            z = torch.clamp(z, min=config.warm_start_min)
    if y is None:
        y = torch.zeros((B, 0), dtype=dtype, device=device)
    return x, s, z, y


class Score(NamedTuple):
    """A tier's scoring of one iterate."""

    #: Per-lane score (B,).
    resids: torch.Tensor
    #: Per-lane duality measure (B,).
    mu: torch.Tensor
    #: Whether the score is exact: only exact scores enter the best-iterate
    #: bookkeeping and advance the window.
    exact: bool = True
    #: What the tier's step takes from the scoring (its residual vectors).
    res: object = None
    #: The score in original coordinates, where it differs from ``resids``
    #: (an equilibrated dense solve); None otherwise.
    resids_o: Optional[torch.Tensor] = None
    #: The primal and dual norms of the per-iteration print; None: the
    #: tier prints nothing.
    pri: Optional[torch.Tensor] = None
    dual: Optional[torch.Tensor] = None


class LoopResult(NamedTuple):
    """What :func:`ipm_loop` hands to the tier's post-loop work."""

    #: The last iterate (x, s, z, y).
    state: tuple
    #: The best iterate, per lane.
    best: tuple
    best_resids: torch.Tensor
    #: The best iterates' scores in original coordinates (inf where the
    #: tier gives no ``Score.resids_o``).
    best_resids_o: torch.Tensor
    #: mu of the last scoring.
    mu: torch.Tensor
    iterations: int


def ipm_loop(config: SolverConfig, state, score, step, margin: float,
             tracked: bool = False, inc: int = 1) -> LoopResult:
    """The IPM loop. Each iteration scores the iterate
    (``score(it, x, s, z, y)`` -> :class:`Score`), keeps each lane's best
    exactly scored iterate on strict improvement, runs :func:`exit_test`
    (the window improved by ``margin``, advanced by ``inc`` per scoring
    event; with ``tracked`` the current score counts beside the best, so a
    solve converging between checkpoints exits promptly), reads ``done`` on
    the host once, and unless done steps
    (``step(x, s, z, y, mu, score.res)`` -> (x, s, z, y))."""
    x, s, z, y = state
    B, dtype, device = s.shape[0], s.dtype, s.device
    per_lane_term = margin > 0.0
    best = state
    best_resids = best_resids_o = torch.full((B,), float("inf"),
                                             dtype=dtype, device=device)
    mu = torch.zeros((B,), dtype=dtype, device=device)
    n_not = torch.zeros((B,) if per_lane_term else (), dtype=torch.int32,
                        device=device)
    lane_done = torch.zeros((B,), dtype=torch.bool, device=device)
    iterations = 0
    with span("qpth.ipm.loop"):
        for it in range(config.max_iter):
            iterations = it + 1
            with span("qpth.ipm.score"):
                sc = score(it, x, s, z, y)
                mu = sc.mu
                if sc.exact:
                    improved_strict = sc.resids < best_resids
                    improved = sc.resids < best_resids * (1.0 - margin)
                    best_resids = torch.where(improved_strict, sc.resids,
                                              best_resids)
                    if sc.resids_o is not None:
                        best_resids_o = torch.where(
                            improved_strict, sc.resids_o, best_resids_o)
                    imp = improved_strict.unsqueeze(-1)
                    best = tuple(torch.where(imp, v, bv)
                                 for v, bv in zip((x, s, z, y), best))
            with span("qpth.ipm.exit"):
                n_not, lane_done, done = exit_test(
                    config, per_lane_term, improved if sc.exact else None,
                    n_not, lane_done, inc, (best_resids, sc.resids)
                    if tracked else (best_resids,), mu)
                if config.verbose >= 1 and sc.pri is not None:
                    # The iteration's one host read carries the print's
                    # means.
                    vals = torch.stack([sc.pri.mean(), sc.dual.mean(),
                                        mu.mean(), done.to(dtype)])
                    with span("qpth.sync"):
                        *means, stop = vals.tolist()
                    print(f"iter: {it}, pri_resid: {means[0]:.5e}, "
                          f"dual_resid: {means[1]:.5e}, mu: {means[2]:.5e}")
                else:
                    with span("qpth.sync"):
                        stop = bool(done)  # the one host read per iteration
                if stop:
                    break
            with span("qpth.ipm.step"):
                x, s, z, y = step(x, s, z, y, mu, sc.res)
    return LoopResult((x, s, z, y), best, best_resids, best_resids_o, mu,
                      iterations)


def pc_direction(s, z, y, mu, d, res, predict, correct, n_correctors: int,
                 one):
    """A composed step's direction: Mehrotra's predictor and corrector,
    then ``n_correctors`` Gondzio centrality corrections, each accepted per
    lane only where it lengthens the step. ``predict(z, y, d, res)``
    factors the tier's system at d and returns (fac, dx, ds, dz, dy), the
    affine direction; ``correct(fac, d, rs)`` solves on ``fac`` for a
    right-hand side zero but for rs. dx is None where the tier forms it
    after the corrections, dy None without equality rows. ``one``: a 0-dim
    1 in the working dtype. Returns (dx, ds, dz, dy)."""
    with span("qpth.ipm.step.factor"):
        fac, dx_a, ds_a, dz_a, dy_a = predict(z, y, d, res)
    alpha = torch.minimum(_step_min(s, z, ds_a, dz_a), one).unsqueeze(-1)
    t1 = ((s + alpha * ds_a) * (z + alpha * dz_a)).sum(dim=-1)
    t2 = (s * z).sum(dim=-1)
    sig = (t1 / t2) ** 3

    rs_c = ((-mu * sig).unsqueeze(-1) + ds_a * dz_a) / s
    with span("qpth.ipm.step.solve"):
        dx_c, ds_c, dz_c, dy_c = correct(fac, d, rs_c)
        dx = dx_a + dx_c if dx_a is not None else None
    ds, dz = ds_a + ds_c, dz_a + dz_c
    dy = dy_a + dy_c if dy_a is not None else None

    for _ in range(n_correctors):
        a_g = torch.minimum(_step_min(s, z, ds, dz), one)
        a_t = torch.minimum(1.08 * a_g + 0.08, one).unsqueeze(-1)
        v = (s + a_t * ds) * (z + a_t * dz)
        mu_t = (sig * mu).unsqueeze(-1)
        rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                  10.0 * mu_t)) / s
        with span("qpth.ipm.step.solve"):
            ddx, dds, ddz, ddy = correct(fac, d, rs_g)
        dz_n, ds_n = dz + ddz, ds + dds
        a_n = torch.minimum(_step_min(s, z, ds_n, dz_n), one)
        acc = (a_n > a_g).unsqueeze(-1)
        dz = torch.where(acc, dz_n, dz)
        ds = torch.where(acc, ds_n, ds)
        if dy is not None:
            dy = torch.where(acc, dy + ddy, dy)
        if dx is not None:
            dx = torch.where(acc, dx + ddx, dx)
    return dx, ds, dz, dy


def damped_update(x, s, z, y, dx, ds, dz, dy, one, zero, move_x=None):
    """The step along (dx, ds, dz, dy): 0.999 of the step to the boundary,
    at most 1, with every lane whose direction holds a NaN frozen (its step
    0 and its direction masked, since 0 * NaN is NaN). Where dx is None,
    ``move_x(x, z, y, dz, dy, alpha, mask)`` moves x (the dense tier's
    coefficient-tracked x, whose dx is NaN exactly where dz is). Returns
    (x, s, z, y, alpha, lane_bad), alpha (B,) the applied step."""
    alpha = torch.minimum(0.999 * _step_min(s, z, ds, dz), one)
    lane_bad = _nan_lanes(dx, ds, dz, dy)
    mask = lane_bad.unsqueeze(-1)
    alpha = torch.where(mask, zero, alpha.unsqueeze(-1))
    if dx is None:
        x = move_x(x, z, y, dz, dy, alpha, mask)
    else:
        x = x + alpha * torch.where(mask, zero, dx)
    s = s + alpha * torch.where(mask, zero, ds)
    z = z + alpha * torch.where(mask, zero, dz)
    if dy is not None:
        y = y + alpha * torch.where(mask, zero, dy)
    return x, s, z, y, alpha[:, 0], lane_bad


def finish_stats(config: SolverConfig, iterations: int, best_resids, mu,
                 warn_on=None, advice: str = "") -> SolveStats:
    """The INACC warning (on ``warn_on``, default ``best_resids``) and the
    ``SolveStats`` of a solve."""
    if config.verbose >= 0:
        warn_inaccurate(config, best_resids if warn_on is None else warn_on,
                        advice)
    its = torch.tensor(iterations, dtype=torch.int32,
                       device=best_resids.device)
    return SolveStats(iterations=its, best_resids=best_resids, mu=mu,
                      converged=best_resids < config.eps)


def _refine(best, Q, p, G, h, A, b, nineq, kkt_factor_solve,
            config: SolverConfig, maps=None, steps: int = 0,
            early_exit: bool = False):
    """Mixed-precision refinement (``SolverConfig.refine_steps``): full
    Newton steps toward mu = 0 with float64 residuals and working-dtype
    solves (``kkt_factor_solve``: the backend's factor with its first solve,
    kernel A or kernel C). The float32 plateau comes from evaluating the
    Newton right-hand side in float32; recomputing the residuals in float64
    restores true corrections while cond(KKT) < 1/eps_f32, and the iterate
    is accumulated, and returned, in float64.

    ``best``: the loop's best (x, s, z, y) in iterate coordinates.
    ``maps``: (m_x, m_s, m_z, m_y, w_rx, w_rz, w_ry), the exact pow2 maps
    from iterate to original coordinates and from original residuals to
    iterate-coordinate ones: the residuals and scores are those of the
    original problem, the solves those of the scaled one. The complementarity
    diagonal is clamped at ``refine_clamp`` (1e-10 by default) and no
    fraction-to-boundary rule applies; per-lane best-score tracking keeps the
    entry iterate wherever a step degrades a lane.

    With ``early_exit`` (the eps dial) the steps stop once one does not halve
    the batch's max score, one host read per step; the test reduces over
    the whole batch, as the JAX package's does. Returns ((x, s, z, y),
    score, mu, steps): the point in iterate coordinates and the score and mu
    of the original problem, all float64, and the number of steps taken."""
    f64 = torch.float64
    neq = A.shape[-2] if A is not None else 0
    wd = p.dtype
    Q64, G64, p64, h64 = (v.to(f64) for v in (Q, G, p, h))
    A64 = A.to(f64) if neq > 0 else None
    b64 = b.to(f64) if neq > 0 else None
    if maps is not None:
        m_x, m_s, m_z, m_y, w_rx, w_rz, w_ry = maps
        m_x, m_s, m_z = (v.to(f64) for v in (m_x, m_s, m_z))
        m_y = m_y.to(f64) if m_y is not None else None

    def score64(x, s, z, y):
        if maps is not None:
            x, s, z = x * m_x, s * m_s, z * m_z
            if neq > 0:
                y = y * m_y
        rx = bmv(Q64, x) + p64 + btmv(G64, z)
        ry = None
        pri = 0.0
        if neq > 0:
            rx = rx + btmv(A64, y)
            ry = bmv(A64, x) - b64
            pri = _norm(ry)
        rz = bmv(G64, x) + s - h64
        mu = torch.abs((s * z).sum(dim=-1) / nineq)
        return rx, rz, ry, mu, pri + _norm(rz) + _norm(rx) + nineq * mu

    x, s, z, y = (v.to(f64) for v in best)
    _, _, _, mu_b, score_b = score64(x, s, z, y)
    bx, bs, bz, by = x, s, z, y
    c = config.refine_clamp if config.refine_clamp is not None else 1e-10

    def step_once(x, s, z, y):
        rx, rz, ry, _, _ = score64(x, s, z, y)
        s_hat = torch.clamp(s, min=c)
        d = (torch.clamp(z, min=c) / s_hat).to(wd)
        # (s z) / s_hat, not z: the complementarity row of the clamped
        # system.
        rs_eff = (z * (s / s_hat)).to(wd)
        if maps is not None:
            rx, rz = rx * w_rx, rz * w_rz
            ry = ry * w_ry if neq > 0 else None
        _, dx, ds, dz, dy = kkt_factor_solve(
            d, rx.to(wd), rs_eff, rz.to(wd),
            ry.to(wd) if neq > 0 else None)
        msk = _nan_lanes(dx, ds, dz, dy).unsqueeze(-1)
        x = x + torch.where(msk, 0.0, dx).to(f64)
        s = s + torch.where(msk, 0.0, ds).to(f64)
        z = z + torch.where(msk, 0.0, dz).to(f64)
        if neq > 0:
            y = y + torch.where(msk, 0.0, dy).to(f64)
        _, _, _, mu_n, score_n = score64(x, s, z, y)
        return x, s, z, y, mu_n, score_n

    def batch_max(v):
        m = greduce(config.process_group, (v.amax(), "max"))[0]
        with span("qpth.sync"):
            return float(m)

    k, prev_m = 0, float("inf")
    cur_m = batch_max(score_b) if early_exit else 0.0
    while k < steps and (not early_exit or k == 0 or cur_m < 0.5 * prev_m):
        x, s, z, y, mu_n, score_n = step_once(x, s, z, y)
        take = score_n < score_b
        t = take.unsqueeze(-1)
        bx, bs, bz = (torch.where(t, v, bv)
                      for v, bv in ((x, bx), (s, bs), (z, bz)))
        if neq > 0:
            by = torch.where(t, y, by)
        score_b = torch.minimum(score_n, score_b)
        mu_b = torch.where(take, mu_n, mu_b)
        if early_exit:
            prev_m, cur_m = cur_m, batch_max(score_n)
        k += 1
    return (bx, bs, bz, by), score_b, mu_b, k


def _escalate_oracle(esc, x, s, z, y, stats: SolveStats, Q, p, G, h, A, b,
                     config: SolverConfig):
    """Escalate conditioning-limited lanes to the float64 CPU oracle
    (``SolverConfig.escalate="oracle"``): the lanes ``esc`` (original-
    coordinate score above ``escalate_tol``) are found with one host read,
    only their operands go to the host (a shared matrix once), and each is
    solved by ``solvers/oracle.py::solve_qp_np``. The answers merge back on
    the device as hi words in the working dtype with their low words in
    ``lo`` (one working-dtype word cannot hold the float64 answer), with the
    exact float64 score (rounded to the working dtype) in ``best_resids``.
    ``stats.escalated`` is the attempt mask; a lane the oracle also fails on
    keeps its device iterate. Returns (x, s, z, y, lo, stats)."""
    import numpy as np

    from ..solvers.oracle import solve_qp_np

    neq = A.shape[-2] if A is not None else 0
    m = G.shape[-2]
    wd = p.dtype
    np_dt = np.float64 if _is_f64(wd) else np.float32
    lo = QPSolutionLow(*(torch.zeros(v.shape, dtype=wd, device=v.device)
                         for v in (x, y, z, s)))
    stats = stats._replace(escalated=esc)
    with span("qpth.sync"):
        idx = torch.nonzero(esc).flatten()      # the one host read
    if idx.numel() == 0:
        return x, s, z, y, lo, stats

    def host(M):
        """Escalated lanes' rows of M on the host; a shared matrix once."""
        M = M if M.shape[0] == 1 else M[idx]
        with span("qpth.sync"):
            return M.cpu().numpy()

    Qh, Gh, ph, hh = host(Q), host(G), host(p), host(h)
    Ah, bh = (host(A), host(b)) if neq > 0 else (None, None)
    ok, vals, score, mu_o = [], {k: [] for k in "xszy"}, [], []
    for j in range(idx.numel()):
        Qi = (Qh[j] if Qh.shape[0] > 1 else Qh[0]).astype(np.float64)
        Gi = (Gh[j] if Gh.shape[0] > 1 else Gh[0]).astype(np.float64)
        Ai = ((Ah[j] if Ah.shape[0] > 1 else Ah[0]).astype(np.float64)
              if Ah is not None else None)
        bi = bh[j].astype(np.float64) if bh is not None else None
        pi, hi = ph[j].astype(np.float64), hh[j].astype(np.float64)
        try:
            _, xi, nui, lami, si = solve_qp_np(Qi, pi, Gi, hi, Ai, bi)
        except Exception:
            continue
        if not np.isfinite(xi).all():
            continue
        yi = nui if (neq > 0 and nui is not None) else np.zeros(neq)
        for k, v in (("x", xi), ("s", si), ("z", lami), ("y", yi)):
            vals[k].append(v)
        # The exact float64 score of the oracle's answer (the merged words
        # are its rounding; scoring those would report the representation
        # error, not the solve's).
        rx = Qi @ xi + pi + Gi.T @ lami
        rz = Gi @ xi + si - hi
        sc = np.linalg.norm(rz) + np.linalg.norm(rx) + abs(si @ lami)
        if Ai is not None:
            sc = (np.linalg.norm(rz) + np.linalg.norm(rx + Ai.T @ yi)
                  + np.linalg.norm(Ai @ xi - bi) + abs(si @ lami))
        score.append(sc)
        mu_o.append(abs(si @ lami) / m)
        ok.append(j)
    if not ok:
        return x, s, z, y, lo, stats
    rows = idx[torch.as_tensor(ok, device=idx.device)]

    def merge(cur, new):
        out = cur.clone()
        out[rows] = torch.as_tensor(np.asarray(new)).to(cur.device, cur.dtype)
        return out

    hi_lo = {}
    for k, v in vals.items():
        v = np.stack(v)
        hw = v.astype(np_dt)
        hi_lo[k] = (hw, (v - hw.astype(np.float64)).astype(np_dt))
    x, s, z = (merge(cur, hi_lo[k][0]) for cur, k in ((x, "x"), (s, "s"),
                                                       (z, "z")))
    lo = lo._replace(z=merge(lo.z, hi_lo["x"][1]),
                     s=merge(lo.s, hi_lo["s"][1]),
                     lam=merge(lo.lam, hi_lo["z"][1]))
    if neq > 0:
        y = merge(y, hi_lo["y"][0])
        lo = lo._replace(nu=merge(lo.nu, hi_lo["y"][1]))
    score = np.asarray(score).astype(np_dt)
    stats = stats._replace(
        best_resids=merge(stats.best_resids, score),
        mu=merge(stats.mu, np.asarray(mu_o).astype(np_dt)),
        converged=merge(stats.converged, score < config.eps))
    return x, s, z, y, lo, stats


class _Dense:
    """One dense solve with the partial-Cholesky KKT strategy: its fixed
    operands and the pieces its loop runs, namely the coordinates (iterate,
    semantic and original), the cached products of inverse mode, the
    scoring and the steps, of which :meth:`bind` picks one before the
    loop."""

    def __init__(self, Q, p, G, h, A, b, factors: kkt_ops.KKTFactors,
                 config: SolverConfig, init, backend, refined: bool):
        B, nz = p.shape
        nineq = G.shape[-2]
        neq = A.shape[-2] if A is not None else 0
        dtype, device = p.dtype, p.device
        self.B, self.nz, self.nineq, self.neq = B, nz, nineq, neq
        self.dtype, self.device = dtype, device
        self.Q, self.p, self.G, self.h, self.A, self.b = Q, p, G, h, A, b
        self.config = config
        chol_partial = config.kkt_solver == KKTSolver.CHOL_PARTIAL

        sc = factors.scaling
        self.scaled = sc is not None
        self.ws = None
        if self.scaled:
            # Iterate coordinates (sc) vs semantic coordinates (sem): see the
            # JAX solver. In the probe's light branch sc is the identity.
            sem = (factors.sem_scaling if factors.sem_scaling is not None
                   else sc)
            self.p_, self.h_, self.b_ = scaling_mod.scale_vecs(p, h, b, sc)
            self.w_rx, self.w_rz, self.w_ry = sc.c * sc.E, sc.RG, sc.RA
            self.c_flat = sc.c[..., 0]
            self.m_x, self.m_s, self.m_z = sc.E, 1.0 / sc.RG, sc.RG / sc.c
            self.m_y = (sc.RA / sc.c) if sc.RA is not None else None
            self.sw_rx, self.sw_rz, self.sw_ry = sem.c * sem.E, sem.RG, sem.RA
            self.sem_c = sem.c[..., 0]
            self.ws = (self.m_s * sem.RG, self.m_z * (sem.c / sem.RG))
            if init is not None:
                init = scaling_mod.scale_point(*init, sc)
        else:
            self.p_, self.h_, self.b_ = p, h, b
        self.init = init

        self.margin = resolve_improve_margin(config, dtype)
        self.resid_every = resolve_resid_every(config, dtype)

        # FULL / IR build the saddle system each solve: no backend, and the
        # prefactorization serves the backward only.
        fs = None
        if chol_partial:
            if backend is None:
                backend = kkt_ops.resolve_backend(config.use_pallas, dtype,
                                                  nineq, device)
            fs = kkt_ops.prepare_factors(factors)
        self.fs, self.backend = fs, backend

        self.fast = fast = chol_partial and fs.invQ_GT is not None
        self.track = track = fast and self.resid_every != 1
        if fast:
            self.invQ_p = kkt_ops.apply_invQ(fs, self.p_)
            G_invQ_p = btmv(fs.invQ_GT, self.p_)
            self.A_invQ_p = btmv(fs.invQ_AT, self.p_) if neq > 0 else None
            self.q = -(self.h_ + G_invQ_p)
        if not fast or refined:
            # The matrices of the iterate coordinates: the substitution-mode
            # solves and the FULL / IR saddle systems read them, and so does
            # refinement's solve in inverse mode. The probe's light branch
            # keeps the factors in original coordinates, so there they are
            # the inputs themselves.
            same = not self.scaled or isinstance(
                sc, scaling_mod.IdentityScaling)
            self.Gm = G if same else scaling_mod.scale_G(G, sc)
            self.Am = A if same else scaling_mod.scale_A(A, sc)
            if not fast:
                self.Qm = Q if same else scaling_mod.scale_Q(Q, sc)

        # The fused iteration, where the backend has one and one QP's working
        # set fits a thread block.
        self.use_fused = use_fused = use_fused_eq = False
        if fast and backend.fused:
            want_xfree = track and config.coeff_x is not False
            if neq == 0:
                use_fused = kkt_ops.fused_step_supported(
                    device, dtype, nineq, 0 if want_xfree else nz)
            else:
                use_fused_eq = kkt_ops.fused_step_supported(
                    device, dtype, nineq, nz, neq)
        # Coefficient-tracked x: tracked mode only (the reference-parity mode
        # keeps the reference's own x recurrence); the fused step with equality
        # constraints owns its x and y updates.
        self.use_fused, self.use_fused_eq = use_fused, use_fused_eq
        self.xfree = xfree = (fast and track and not use_fused_eq
                              and config.coeff_x is not False)
        if use_fused or use_fused_eq:
            self.q_t = self.q.contiguous()
            if not xfree:
                self.ip_t = self.invQ_p.contiguous()
        if use_fused_eq:
            self.rb_t = (self.b_ + self.A_invQ_p).contiguous()

        self.zero = torch.zeros((), dtype=dtype, device=device)
        self.one = torch.ones((), dtype=dtype, device=device)
        # The not-improved window advances once per scoring event: every
        # iteration normally, every checkpoint (by resid_every) in tracked
        # mode.
        self.inc = max(self.resid_every, 1) if track else 1

    def bind(self):
        """The loop's (score, step), chosen once: the loop body runs score,
        exit and step with no branch on the path. The caller holds them;
        kept on the instance, these bound methods would make reference
        cycles that hold the solve's device tensors past its return, until
        the garbage collector runs."""
        if self.track:
            score = self._score_tracked
        else:
            score = functools.partial(
                self._score, self._resid_fast if self.fast else self._residuals)
        if self.use_fused and self.xfree:
            core = self._fused_xfree_step
        elif self.use_fused:
            core = self._fused_step
        elif self.use_fused_eq:
            core = self._fused_eq_step
        elif self.fast:
            core = functools.partial(
                self._composed_step, self._predict_fast, self._correct_fast,
                _keep_dx if self.xfree else self._combined_dx)
        else:
            core = functools.partial(self._composed_step, self._predict_solve,
                                     self._correct_solve, _keep_dx)
        return score, functools.partial(
            self._tracked_step if self.track else self._step, core)

    # ---- The first iterate ----------------------------------------------

    def solve_init(self):
        """The init solve with d = 1 in semantic coordinates (d_it = ws_s /
        ws_z in iterate coordinates), RHS (p, 0, -h, -b)."""
        B, nz, nineq, neq = self.B, self.nz, self.nineq, self.neq
        dtype, device = self.dtype, self.device
        ones_m = (self.ws[0] / self.ws[1] if self.scaled else self.one)
        ones_m = ones_m.expand(B, nineq).to(dtype).contiguous()
        if self.fast:
            # The fast predictor at (x, z, y) = 0 with d = 1.
            zeros_n = torch.zeros((B, nz), dtype=dtype, device=device)
            zeros_m = torch.zeros((B, nineq), dtype=dtype, device=device)
            y0 = (torch.zeros((B, neq), dtype=dtype, device=device)
                  if neq > 0 else None)
            _, _, s, z, y = self._predict_fast(zeros_m, y0, ones_m, None)
            x = self._combined_dx(zeros_n, zeros_m, y0, None, z, y)
            return x, s, z, y
        _, x, s, z, y = self.kkt_factor_solve(
            ones_m, self.p_, None, -self.h_, -self.b_ if neq > 0 else None)
        return x, s, z, y

    def fail_soft(self, x, s, z, y):
        """A lane whose init solve gave NaN restarts from the neutral
        interior point (0, 1, 1, 0) (the 1s in semantic coordinates) with
        the adaptive regularization of the composed step pre-armed. Returns
        the loop's first state, x packed as coefficients in xfree mode."""
        zero, one = self.zero, self.one
        bad0 = (torch.isnan(x).any(-1) | torch.isnan(s).any(-1)
                | torch.isnan(z).any(-1) | torch.isnan(y).any(-1))
        b0 = bad0.unsqueeze(-1)
        x = torch.where(b0, zero, x)
        s = torch.where(b0, 1.0 / self.ws[0] if self.scaled else one, s)
        z = torch.where(b0, 1.0 / self.ws[1] if self.scaled else one, z)
        y = torch.where(b0, zero, y)
        self.reg = torch.where(bad0, zero + self.config.ir_eps, zero)
        if self.xfree:
            B, pw = self.B, self.nineq + self.neq
            self.x0_anchor = x
            x = torch.cat([
                torch.zeros((B, pw), dtype=self.dtype, device=self.device),
                torch.ones((B, 1), dtype=self.dtype, device=self.device),
                torch.zeros((B, 1), dtype=self.dtype, device=self.device)],
                dim=1)
        # The tracked norms between checkpoints.
        self.pri = self.dual = torch.zeros((self.B,), dtype=self.dtype,
                                           device=self.device)
        return x, s, z, y

    # ---- Coordinates and coefficient-tracked x --------------------------

    def to_orig(self, x, s, z, y):
        if not self.scaled:
            return x, s, z, y
        return (x * self.m_x, s * self.m_s, z * self.m_z,
                (y * self.m_y) if self.neq > 0 else y)

    def _x_of(self, xp):
        """x from the packed coefficients [w | v | e | c]."""
        nineq, pw, fs = self.nineq, self.nineq + self.neq, self.fs
        xr = (xp[:, pw:pw + 1] * self.x0_anchor - xp[:, pw + 1:] * self.invQ_p
              - bmv(fs.invQ_GT, xp[:, :nineq]))
        if self.neq > 0:
            xr = xr - bmv(fs.invQ_AT, xp[:, nineq:pw])
        return xr

    def _xp_step(self, xp, a_l, zeta, zy):
        """One damped step on the packed coefficients; zeta = z + dz,
        zy = y + dy (None when neq == 0). a_l = 0 on frozen lanes, whose
        anchors are masked: an exact no-op."""
        nineq, pw = self.nineq, self.nineq + self.neq
        a = a_l.unsqueeze(-1)
        na = 1.0 - a
        parts = [na * xp[:, :nineq] + a * zeta]
        if self.neq > 0:
            parts.append(na * xp[:, nineq:pw] + a * zy)
        parts += [na * xp[:, pw:pw + 1], na * xp[:, pw + 1:] + a]
        return torch.cat(parts, dim=1)

    def _move_xfree(self, x, z, y, dz, dy, alpha, mask):
        """:func:`damped_update`'s move of the packed coefficients."""
        zeta = z + torch.where(mask, self.zero, dz)
        zy = ((y + torch.where(mask, self.zero, dy)) if self.neq > 0
              else None)
        return self._xp_step(x, alpha[:, 0], zeta, zy)

    # ---- Scoring ----------------------------------------------------------

    def _mu_of(self, s, z):
        return torch.abs((s * z).sum(dim=-1) / self.nineq)

    def _mu_sel_of(self, mu):
        return (mu / self.c_flat) * self.sem_c if self.scaled else mu

    def _exact_pri_dual(self, x, s, z, y):
        """(pri, dual, pri_o, dual_o) from scratch, reading the original
        matrices; pri/dual in semantic coordinates."""
        xo, so, zo, yo = self.to_orig(x, s, z, y)
        rx = bmv(self.Q, xo) + self.p + btmv(self.G, zo)
        rz = bmv(self.G, xo) + so - self.h
        pri_o = _norm(rz)
        if self.neq > 0:
            rx = rx + btmv(self.A, yo)
            ry = bmv(self.A, xo) - self.b
            pri_o = pri_o + _norm(ry)
        dual_o = _norm(rx)
        if not self.scaled:
            return pri_o, dual_o, pri_o, dual_o
        pri_s = _norm(rz * self.sw_rz)
        if self.neq > 0:
            pri_s = pri_s + _norm(ry * self.sw_ry)
        return pri_s, _norm(rx * self.sw_rx), pri_o, dual_o

    def _resid_fast(self, x, s, z, y):
        return (None,) + self._exact_pri_dual(x, s, z, y)

    def _residuals(self, x, s, z, y):
        """Residual vectors in iterate coordinates (the RHS of the
        substitution-mode solves) and the norms in both coordinate
        systems: ((rx, rz, ry), pri, dual, pri_o, dual_o)."""
        rx = bmv(self.Qm, x) + self.p_ + btmv(self.Gm, z)
        ry = None
        if self.neq > 0:
            rx = rx + btmv(self.Am, y)
            ry = bmv(self.Am, x) - self.b_
        rz = bmv(self.Gm, x) + s - self.h_
        if not self.scaled:
            pri = _norm(rz) + (_norm(ry) if self.neq > 0 else 0.0)
            dual = _norm(rx)
            return (rx, rz, ry), pri, dual, pri, dual
        rz_o, rx_o = rz / self.w_rz, rx / self.w_rx
        pri_o, pri = _norm(rz_o), _norm(rz_o * self.sw_rz)
        if self.neq > 0:
            ry_o = ry / self.w_ry
            pri_o = pri_o + _norm(ry_o)
            pri = pri + _norm(ry_o * self.sw_ry)
        return ((rx, rz, ry), pri, _norm(rx_o * self.sw_rx), pri_o,
                _norm(rx_o))

    def _scores(self, mu, pri, dual, pri_o, dual_o):
        """The score in semantic coordinates and, equilibrated, the
        original problem's."""
        resids = pri + dual + self.nineq * self._mu_sel_of(mu)
        resids_o = (pri_o + dual_o + self.nineq * (mu / self.c_flat)
                    if self.scaled else None)
        return resids, resids_o

    def _score(self, resid, it, x, s, z, y):
        """Every iteration scored exactly, from ``resid``'s norms."""
        mu = self._mu_of(s, z)
        res, pri, dual, pri_o, dual_o = resid(x, s, z, y)
        resids, resids_o = self._scores(mu, pri, dual, pri_o, dual_o)
        return Score(resids, mu, True, res, resids_o, pri, dual)

    def _score_tracked(self, it, x, s, z, y):
        """Exact at checkpoints (every ``resid_every`` iterations; 0: the
        first only), the tracked norms in between."""
        mu = self._mu_of(s, z)
        re = self.resid_every
        exact = (it == 0) if re == 0 else it % re == 0
        if not exact:
            resids = self.pri + self.dual + self.nineq * self._mu_sel_of(mu)
            return Score(resids, mu, False, None, None, self.pri, self.dual)
        self.pri, self.dual, pri_o, dual_o = self._exact_pri_dual(
            self._x_of(x) if self.xfree else x, s, z, y)
        resids, resids_o = self._scores(mu, self.pri, self.dual, pri_o,
                                        dual_o)
        return Score(resids, mu, True, None, resids_o, self.pri, self.dual)

    # ---- KKT solves -------------------------------------------------------

    def kkt_factor_solve(self, d, rx, rs, rz, ry):
        """The factor of T and the first solve on it in one kernel; returns
        (fac, dx, ds, dz, dy)."""
        fs, be = self.fs, self.backend
        rhs_T, u = kkt_ops.prepare_rhs_kkt(fs, d, self.Gm, self.Am, rx, rs,
                                           rz, ry, be.q_solve2)
        fac, dz = be.factor_solve(fs.R, d, rhs_T)
        return (fac,) + kkt_ops.backsub_kkt(fs, dz, u, d, self.Gm, self.Am,
                                            rx, rs, be.q_solve2)

    def kkt_solve(self, fac, d, rx, rs, rz, ry):
        """(dx, ds, dz, dy) on a factor made before; any of rx, rs, rz, ry
        may be None (zero)."""
        return kkt_ops.solve_kkt(self.fs, fac, d, self.Gm, self.Am, rx, rs,
                                 rz, ry, solve2=self.backend.solve2,
                                 q_solve2=self.backend.q_solve2)

    # ---- The composed step's solves ---------------------------------------

    def _predict_fast(self, z, y, d, res):
        """Factor and predictor solve through the cached products; returns
        (fac, None, ds, dz, dy). GiGT z = R z + S21 (W z), so the R z part
        goes to the backend's ``factor_solve_rz`` (folded into kernel A, or
        the w = x + z substitution of the blocked backend) and only the
        S21 / W products stay outside. dx is assembled once per iteration
        by :meth:`_combined_dx`."""
        fs, q_ = self.fs, self.q
        if self.neq > 0:
            r1 = self.b_ + self.A_invQ_p + btmv(fs.S21, z) + bmv(fs.S11, y)
            u = bmv(fs.invS11, -r1)
            q_ = self.q - bmv(fs.S21, bmv(fs.W, z) + y + u)
        fac, dz = self.backend.factor_solve_rz(fs.R, d, q_, z)
        dy = (u - bmv(fs.W, dz)) if self.neq > 0 else None
        return fac, None, (-z - dz) / d, dz, dy

    def _correct_fast(self, fac, d, rs):
        """Corrector solve (RHS zero except rs): (None, ds, dz, dy)."""
        dz = self.backend.solve2(fac, -(rs / d))
        dy = -bmv(self.fs.W, dz) if self.neq > 0 else None
        return None, (-rs - dz) / d, dz, dy

    def _predict_solve(self, z, y, d, res):
        rx, rz, ry = res
        return self.kkt_factor_solve(d, rx, z, rz, ry)

    def _correct_solve(self, fac, d, rs):
        return self.kkt_solve(fac, d, None, rs, None, None)

    def _combined_dx(self, x, z, y, dx, dz, dy):
        """dx = -(x + Q^-1 p) - Q^-1 G^T (z + dz) - Q^-1 A^T (y + dy)."""
        fs = self.fs
        dx = -(x + self.invQ_p) - bmv(fs.invQ_GT, z + dz)
        if self.neq > 0:
            dx = dx - bmv(fs.invQ_AT, y + dy)
        return dx

    # ---- Steps: each returns (x, s, z, y, alpha) --------------------------

    def _composed_step(self, predict, correct, form_dx, x, s, z, y, mu, res):
        """One predictor-corrector step from the backend's factor and
        solves (:func:`pc_direction`'s ``predict`` and ``correct``; dx
        from ``form_dx``), with the adaptive regularization of the
        fail-soft path."""
        d = z / s
        # A lane whose last direction was NaN re-factors T + reg I, as the
        # exact elementwise transform d' = d / (1 + reg d). reg = 0 leaves
        # a healthy lane bit-identical.
        d = d / (1.0 + self.reg.unsqueeze(-1) * d)
        dx, ds, dz, dy = pc_direction(s, z, y, mu, d, res, predict, correct,
                                      self.config.n_correctors, self.one)
        dx = form_dx(x, z, y, dx, dz, dy)
        x, s, z, y, a_l, lane_bad = damped_update(
            x, s, z, y, dx, ds, dz, dy, self.one, self.zero,
            self._move_xfree)
        # Failed lanes start at ir_eps and grow 8x per repeat failure;
        # healthy lanes keep their shift.
        self.reg = torch.where(
            lane_bad, torch.clamp(self.reg * 8.0, min=self.config.ir_eps),
            self.reg)
        return x, s, z, y, a_l

    def _fused_xfree_step(self, x, s, z, y, mu, res):
        zeta, s, z, a_l = kernels.ipm_step_xfree(
            self.fs.R, s.contiguous(), z.contiguous(), self.q_t,
            self.config.n_correctors)
        return self._xp_step(x, a_l, zeta, None), s, z, y, a_l

    def _fused_step(self, x, s, z, y, mu, res):
        x, s, z, a_l = kernels.ipm_step(
            self.fs.R, self.fs.invQ_GT, x.contiguous(), s.contiguous(),
            z.contiguous(), self.q_t, self.ip_t, self.config.n_correctors)
        return x, s, z, y, a_l

    def _fused_eq_step(self, x, s, z, y, mu, res):
        f = self.fs
        return kernels.ipm_step_eq(
            f.R, f.invQ_GT, f.S21, f.W, f.invS11, f.S11, f.invQ_AT,
            x.contiguous(), s.contiguous(), z.contiguous(), y.contiguous(),
            self.q_t, self.ip_t, self.rb_t, self.config.n_correctors)

    def _step(self, core, x, s, z, y, mu, res):
        return core(x, s, z, y, mu, res)[:4]

    def _tracked_step(self, core, x, s, z, y, mu, res):
        x, s, z, y, a_l = core(x, s, z, y, mu, res)
        # The combined direction solves the Newton system exactly, so each
        # feasibility residual norm scales by (1 - alpha).
        self.pri, self.dual = self.pri * (1.0 - a_l), self.dual * (1.0 - a_l)
        return x, s, z, y


class _DenseSaddle(_Dense):
    """``KKTSolver.FULL`` / ``IR``: the full saddle system built and solved
    every time, no backend, no factor kept; the prefactorization serves
    the backward only."""

    def __init__(self, *args):
        super().__init__(*args)
        cfg = self.config
        self.saddle = (kkt_ops.factor_solve_kkt
                       if cfg.kkt_solver == KKTSolver.FULL
                       else functools.partial(kkt_ops.solve_kkt_ir,
                                              eps=cfg.ir_eps,
                                              niter=cfg.ir_iters))

    def kkt_factor_solve(self, d, rx, rs, rz, ry):
        """FULL / IR have no factor to keep."""
        return (None,) + self.kkt_solve(None, d, rx, rs, rz, ry)

    def kkt_solve(self, fac, d, rx, rs, rz, ry):
        """The FULL / IR saddle systems, which take dense right-hand
        sides."""
        B, dtype, device = self.B, self.dtype, self.device

        def dense(v, n):
            return v if v is not None else torch.zeros(
                (B, n), dtype=dtype, device=device)

        rx, rs, rz = dense(rx, self.nz), dense(rs, self.nineq), dense(
            rz, self.nineq)
        if self.neq > 0:
            ry = dense(ry, self.neq)
        return self.saddle(self.Qm, torch.diag_embed(d), self.Gm, self.Am,
                           rx, rs, rz, ry)


def _keep_dx(x, z, y, dx, dz, dy):
    return dx


def solve(Q, p, G, h, A, b, factors: kkt_ops.KKTFactors,
          config: SolverConfig, init=None, backend=None) -> QPSolution:
    """Run the batched IPM on one device. Matrices carry minimal batch dims
    (1 when shared); p (B, nz), h (B, nineq) and b (B, neq) are full-batch;
    A and b are None when neq == 0. All parameters are in original (user)
    coordinates; ``factors`` comes from ``kkt_ops.pre_factor_kkt`` (possibly
    of the equilibrated problem, see ``factors.scaling``).

    ``init``: optional warm start (x, s, z, y), for instance the previous
    receding-horizon solution; s and z are clipped to
    ``config.warm_start_min`` to restore strict interiority. y may be None
    when neq == 0.

    ``backend``: a ``kkt_ops.KKTBackend`` in place of the one
    ``config.use_pallas`` resolves to (the tensor-parallel path passes its
    distributed factor and solves of T)."""
    if config.kkt_solver not in (KKTSolver.CHOL_PARTIAL, KKTSolver.FULL,
                                 KKTSolver.IR):
        raise ValueError(config.kkt_solver)
    if config.escalate not in (None, "oracle"):
        raise ValueError(f"escalate: {config.escalate!r}")
    refine_budget, refine_early = resolve_refine_steps(config, p.dtype)
    refined = refine_budget > 0

    with span("qpth.ipm.init"):
        cls = (_Dense if config.kkt_solver == KKTSolver.CHOL_PARTIAL
               else _DenseSaddle)
        dn = cls(Q, p, G, h, A, b, factors, config, init, backend, refined)
        score, step = dn.bind()
        state = dn.fail_soft(*start_point(config, dn.init, dn.solve_init,
                                          dn.B, dn.dtype, dn.device, dn.ws))

    out = ipm_loop(config, state, score, step, dn.margin,
                   tracked=dn.track, inc=dn.inc)

    with span("qpth.ipm.finish"):
        x, s, z, y = out.state
        best_x, best_s, best_z, best_y = out.best
        best_resids, best_resids_o, mu = (out.best_resids, out.best_resids_o,
                                          out.mu)
        nineq = dn.nineq
        if dn.xfree:
            x, best_x = dn._x_of(x), dn._x_of(best_x)

        if dn.track:
            # Exact rescore of the final iterate; it wins where it beats the
            # recorded checkpoint best.
            pri_f, dual_f, pri_fo, dual_fo = dn._exact_pri_dual(x, s, z, y)
            mu_f = dn._mu_of(s, z)
            score_f = pri_f + dual_f + nineq * dn._mu_sel_of(mu_f)
            take1 = score_f < best_resids
            take = take1.unsqueeze(-1)
            if dn.scaled:
                score_fo = pri_fo + dual_fo + nineq * (mu_f / dn.c_flat)
                best_resids_o = torch.where(take1, score_fo, best_resids_o)
            best_x = torch.where(take, x, best_x)
            best_s = torch.where(take, s, best_s)
            best_z = torch.where(take, z, best_z)
            best_y = torch.where(take, y, best_y)
            best_resids = torch.minimum(score_f, best_resids)

        if refined:
            maps = ((dn.m_x, dn.m_s, dn.m_z, dn.m_y, dn.w_rx, dn.w_rz,
                     dn.w_ry) if dn.scaled else None)
            (best_x, best_s, best_z, best_y), best_resids, mu, _ = _refine(
                (best_x, best_s, best_z, best_y), Q, p, G, h, A, b, nineq,
                dn.kkt_factor_solve, config, maps=maps, steps=refine_budget,
                early_exit=refine_early)

        # Stats are in original coordinates: the refined score is the
        # original problem's; the loop's recorded the original score beside
        # the semantic one.
        advice = (" Try SolverConfig(kkt_solver=KKTSolver.IR) or the CPU "
                  "oracle.")
        if dn.scaled and not refined:
            mu_best_o = (torch.abs((best_s * best_z).sum(dim=-1)) / nineq
                         / dn.c_flat)
            stats = finish_stats(config, out.iterations, best_resids_o,
                                 mu_best_o, warn_on=best_resids,
                                 advice=advice)
        else:
            stats = finish_stats(config, out.iterations, best_resids, mu,
                                 advice=advice)

        bx, bs, bz, by = dn.to_orig(best_x, best_s, best_z, best_y)
        lo = None
        if config.escalate is not None:
            bx, bs, bz, by, lo, stats = _escalate_oracle(
                stats.best_resids > config.escalate_tol, bx, bs, bz, by, stats,
                Q, p, G, h, A, b, config)
    return QPSolution(z=bx, nu=by, lam=bz, s=bs, stats=stats, lo=lo)
