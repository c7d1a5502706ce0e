"""Batched Mehrotra predictor-corrector primal-dual interior-point method
(counterpart of ``qpth_tpu/core/pdipm.py``).

Ported: the whole dense loop with the partial-Cholesky KKT strategy, with
and without equality constraints, in the branches of the JAX solver:

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

What it keeps from the JAX solver beside that: the init solve with d = 1
(in semantic coordinates), the per-lane shift so s >= 1 and z >= 1, warm
starts clipped at ``warm_start_min``, the fail-soft restart of lanes whose
init solve gave NaN; element-wise best-iterate tracking; the not-improved
window, per lane and latched with a nonzero improve margin, global with
margin 0; equilibration: the iterates live in ``factors.scaling``
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
Python ``for`` with one host read of ``done`` per iteration, as upstream
qpth's loop does it (the per-iteration print rides in the same read);
everything else stays on the device. Refinement's early exit likewise reads
the host once per step. Each phase of :func:`solve` (``qpth.ipm.init``,
``loop``, its ``score``, ``exit`` and ``step`` per iteration, ``finish``)
and each host read (``qpth.sync``) is a ``profiling.span``: a profiler
range while ``torch.profiler`` records, a no-op otherwise.
"""

from __future__ import annotations

import warnings

import torch

from .. import scaling as scaling_mod
from ..config import (KKTSolver, QPSolution, QPSolutionLow, SolverConfig,
                      SolveStats, resolve_refine_steps)
from ..ops import kkt as kkt_ops
from ..ops.linalg import bmv, btmv
from ..profiling import span


def _is_f64(dtype) -> bool:
    return torch.empty((), dtype=dtype).element_size() >= 8


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
            RuntimeWarning, stacklevel=4)


def _step_to_boundary(v, dv):
    """Per-lane max step with v + a dv >= 0 (NaN propagates)."""
    inf = torch.full_like(v, float("inf"))
    return torch.where(dv < 0, -v / dv, inf).amin(dim=-1)


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

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

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
            pri = norm(ry)
        rz = bmv(G64, x) + s - h64
        mu = torch.abs((s * z).sum(dim=-1) / nineq)
        return rx, rz, ry, mu, pri + norm(rz) + norm(rx) + nineq * mu

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
        lane_bad = (torch.isnan(dx).any(-1) | torch.isnan(ds).any(-1)
                    | torch.isnan(dz).any(-1))
        if neq > 0:
            lane_bad = lane_bad | torch.isnan(dy).any(-1)
        msk = lane_bad.unsqueeze(-1)
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
    B, nz = p.shape
    nineq = G.shape[-2]
    neq = A.shape[-2] if A is not None else 0
    dtype, device = p.dtype, p.device
    chol_partial = config.kkt_solver == KKTSolver.CHOL_PARTIAL
    if not chol_partial and config.kkt_solver not in (KKTSolver.FULL,
                                                      KKTSolver.IR):
        raise ValueError(config.kkt_solver)
    if config.escalate not in (None, "oracle"):
        raise ValueError(f"escalate: {config.escalate!r}")
    refine_budget, refine_early = resolve_refine_steps(config, dtype)
    refined = refine_budget > 0

    with span("qpth.ipm.init"):
        sc = factors.scaling
        scaled = sc is not None
        if scaled:
            # Iterate coordinates (sc) vs semantic coordinates (sem): see the
            # JAX solver. In the probe's light branch sc is the identity.
            sem = (factors.sem_scaling if factors.sem_scaling is not None
                   else sc)
            p_, h_, b_ = scaling_mod.scale_vecs(p, h, b, sc)
            w_rx, w_rz, w_ry = sc.c * sc.E, sc.RG, sc.RA
            c_flat = sc.c[..., 0]
            m_x, m_s, m_z = sc.E, 1.0 / sc.RG, sc.RG / sc.c
            m_y = (sc.RA / sc.c) if sc.RA is not None else None
            sw_rx, sw_rz, sw_ry = sem.c * sem.E, sem.RG, sem.RA
            sem_c = sem.c[..., 0]
            ws_s = m_s * sem.RG
            ws_z = m_z * (sem.c / sem.RG)
            if init is not None:
                init = scaling_mod.scale_point(*init, sc)
        else:
            p_, h_, b_ = p, h, b

        def to_orig(x, s, z, y):
            if not scaled:
                return x, s, z, y
            return x * m_x, s * m_s, z * m_z, (y * m_y) if neq > 0 else y

        improve_margin = config.improve_margin
        if improve_margin is None:
            improve_margin = 0.0 if _is_f64(dtype) else 1e-3
        per_lane_term = improve_margin > 0.0
        resid_every = resolve_resid_every(config, dtype)

        # FULL / IR build the saddle system each solve: no backend, and the
        # prefactorization serves the backward only.
        fs = None
        if chol_partial:
            if backend is None:
                backend = kkt_ops.resolve_backend(config.use_pallas, dtype,
                                                  nineq, device)
            fs = backend.prepare(factors)

        fast = chol_partial and fs.invQ_GT is not None
        track = fast and resid_every != 1
        if fast:
            invQ_p = kkt_ops.apply_invQ(fs, p_)
            G_invQ_p = btmv(fs.invQ_GT, p_)
            A_invQ_p = btmv(fs.invQ_AT, p_) if neq > 0 else None
            q = -(h_ + G_invQ_p)
        if not fast or refined:
            # The matrices of the iterate coordinates: the substitution-mode
            # solves and the FULL / IR saddle systems read them, and so does
            # refinement's solve in inverse mode. The probe's light branch
            # keeps the factors in original coordinates, so there they are
            # the inputs themselves.
            same = not scaled or isinstance(sc, scaling_mod.IdentityScaling)
            Gm = G if same else scaling_mod.scale_G(G, sc)
            Am = A if same else scaling_mod.scale_A(A, sc)
            if not fast:
                Qm = Q if same else scaling_mod.scale_Q(Q, sc)

        # The fused iteration, where the backend has one and one QP's working
        # set fits a thread block.
        use_fused = use_fused_eq = False
        if fast and backend.fused_step is not None:
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
        xfree = (fast and track and not use_fused_eq
                 and config.coeff_x is not False)
        if use_fused or use_fused_eq:
            q_t = backend.prepare_vec(q)
            if not xfree:
                ip_t = backend.prepare_vec(invQ_p)
        if use_fused_eq:
            rb_t = backend.prepare_vec(b_ + A_invQ_p)

        def fast_predictor(z, y, d):
            """Factor and predictor solve through the cached products;
            returns (fac, ds, dz, dy). GiGT z = R z + S21 (W z), so the R z
            part goes to the backend's ``factor_solve_rz`` (folded into kernel
            A, or the w = x + z substitution of the blocked backend) and only
            the S21 / W products stay outside.
            dx is assembled once per iteration in fast_combined_dx."""
            q_ = q
            if neq > 0:
                r1 = b_ + A_invQ_p + btmv(fs.S21, z) + bmv(fs.S11, y)
                u = bmv(fs.invS11, -r1)
                q_ = q - bmv(fs.S21, bmv(fs.W, z) + y + u)
            fac, dz = backend.factor_solve_rz(fs.R, d, q_, z)
            dy = (u - bmv(fs.W, dz)) if neq > 0 else None
            return fac, (-z - dz) / d, dz, dy

        def fast_corrector(fac, rs_c, d):
            """Corrector solve (RHS zero except rs): (ds, dz, dy)."""
            dz = backend.solve2(fac, -(rs_c / d))
            dy = -bmv(fs.W, dz) if neq > 0 else None
            return (-rs_c - dz) / d, dz, dy

        def fast_combined_dx(x, z, y, dz, dy):
            """dx = -(x + Q^-1 p) - Q^-1 G^T (z + dz) - Q^-1 A^T (y + dy)."""
            dx = -(x + invQ_p) - bmv(fs.invQ_GT, z + dz)
            if neq > 0:
                dx = dx - bmv(fs.invQ_AT, y + dy)
            return dx

        def kkt_factor_solve(d, rx, rs, rz, ry):
            """The factor of T and the first solve on it in one kernel; returns
            (fac, dx, ds, dz, dy). FULL / IR have no factor to keep."""
            if not chol_partial:
                return (None,) + kkt_solve(None, d, rx, rs, rz, ry)
            rhs_T, u = kkt_ops.prepare_rhs_kkt(fs, d, Gm, Am, rx, rs, rz, ry,
                                               backend.q_solve2)
            fac, dz = backend.factor_solve(fs.R, d, rhs_T)
            return (fac,) + kkt_ops.backsub_kkt(fs, dz, u, d, Gm, Am, rx, rs,
                                                backend.q_solve2)

        def kkt_solve(fac, d, rx, rs, rz, ry):
            """(dx, ds, dz, dy); any of rx, rs, rz, ry may be None (zero)."""
            if chol_partial:
                return kkt_ops.solve_kkt(fs, fac, d, Gm, Am, rx, rs, rz, ry,
                                         solve2=backend.solve2,
                                         q_solve2=backend.q_solve2)
            # The FULL / IR saddle systems take dense right-hand sides.
            def dense(v, n):
                return v if v is not None else torch.zeros(
                    (B, n), dtype=dtype, device=device)

            rx, rs, rz = dense(rx, nz), dense(rs, nineq), dense(rz, nineq)
            if neq > 0:
                ry = dense(ry, neq)
            D = torch.diag_embed(d)
            if config.kkt_solver == KKTSolver.FULL:
                return kkt_ops.factor_solve_kkt(Qm, D, Gm, Am, rx, rs, rz, ry)
            return kkt_ops.solve_kkt_ir(Qm, D, Gm, Am, rx, rs, rz, ry,
                                        eps=config.ir_eps,
                                        niter=config.ir_iters)

        zero = torch.zeros((), dtype=dtype, device=device)
        one = torch.ones((), dtype=dtype, device=device)

        if init is None:
            # ---- Init: solve with d = 1, RHS (p, 0, -h, -b); "d = 1" in
            # semantic coordinates (d_it = ws_s / ws_z in iterate coordinates).
            ones_m = (ws_s / ws_z if scaled else one)
            ones_m = ones_m.expand(B, nineq).to(dtype).contiguous()
            if fast:
                # The fast predictor at (x, z, y) = 0 with d = 1.
                zeros_n = torch.zeros((B, nz), dtype=dtype, device=device)
                zeros_m = torch.zeros((B, nineq), dtype=dtype, device=device)
                y0 = (torch.zeros((B, neq), dtype=dtype, device=device)
                      if neq > 0 else None)
                _, s, z, y = fast_predictor(zeros_m, y0, ones_m)
                x = fast_combined_dx(zeros_n, zeros_m, y0, z, y)
            else:
                _, x, s, z, y = kkt_factor_solve(ones_m, p_, None, -h_,
                                                 -b_ if neq > 0 else None)

            def shift_pos(v, w):
                vs = v * w if scaled else v
                mn = vs.amin(dim=-1, keepdim=True)
                vs = torch.where(mn < 0, vs - mn + 1.0, vs)
                return vs / w if scaled else vs

            s = shift_pos(s, ws_s if scaled else None)
            z = shift_pos(z, ws_z if scaled else None)
        else:
            x, s, z, y = init
            # Interiority clip in semantic coordinates.
            if scaled:
                s = torch.maximum(s, config.warm_start_min / ws_s)
                z = torch.maximum(z, config.warm_start_min / ws_z)
            else:
                s = torch.clamp(s, min=config.warm_start_min)
                z = torch.clamp(z, min=config.warm_start_min)
        if y is None:
            y = torch.zeros((B, 0), dtype=dtype, device=device)

        # Fail-soft init: a lane whose init solve gave NaN restarts from the
        # neutral interior point (0, 1, 1, 0) (the 1s in semantic coordinates)
        # with the adaptive regularization of the composed step pre-armed.
        bad0 = (torch.isnan(x).any(-1) | torch.isnan(s).any(-1)
                | torch.isnan(z).any(-1) | torch.isnan(y).any(-1))
        b0 = bad0.unsqueeze(-1)
        x = torch.where(b0, zero, x)
        s = torch.where(b0, 1.0 / ws_s if scaled else one, s)
        z = torch.where(b0, 1.0 / ws_z if scaled else one, z)
        y = torch.where(b0, zero, y)
        reg = torch.where(bad0, zero + config.ir_eps, zero)

        if xfree:
            pw = nineq + neq
            x0_anchor = x

            def x_of(xp):
                xr = (xp[:, pw:pw + 1] * x0_anchor - xp[:, pw + 1:] * invQ_p
                      - bmv(fs.invQ_GT, xp[:, :nineq]))
                if neq > 0:
                    xr = xr - bmv(fs.invQ_AT, xp[:, nineq:pw])
                return xr

            def xp_step(xp, a_l, zeta, zy):
                """One damped step on the packed coefficients; zeta = z + dz,
                zy = y + dy (None when neq == 0). a_l = 0 on frozen lanes,
                whose anchors are masked: an exact no-op."""
                a = a_l.unsqueeze(-1)
                na = 1.0 - a
                parts = [na * xp[:, :nineq] + a * zeta]
                if neq > 0:
                    parts.append(na * xp[:, nineq:pw] + a * zy)
                parts += [na * xp[:, pw:pw + 1], na * xp[:, pw + 1:] + a]
                return torch.cat(parts, dim=1)

            x = torch.cat([torch.zeros((B, pw), dtype=dtype, device=device),
                           torch.ones((B, 1), dtype=dtype, device=device),
                           torch.zeros((B, 1), dtype=dtype, device=device)],
                          dim=1)

        def mu_of(s, z):
            return torch.abs((s * z).sum(dim=-1) / nineq)

        def mu_sel_of(mu):
            return (mu / c_flat) * sem_c if scaled else mu

        def norm(v):
            return torch.linalg.vector_norm(v, dim=-1)

        def exact_pri_dual(x, s, z, y):
            """(pri, dual, pri_o, dual_o) from scratch, reading the original
            matrices; pri/dual in semantic coordinates."""
            xo, so, zo, yo = to_orig(x, s, z, y)
            rx = bmv(Q, xo) + p + btmv(G, zo)
            rz = bmv(G, xo) + so - h
            pri_o = norm(rz)
            if neq > 0:
                rx = rx + btmv(A, yo)
                ry = bmv(A, xo) - b
                pri_o = pri_o + norm(ry)
            dual_o = norm(rx)
            if not scaled:
                return pri_o, dual_o, pri_o, dual_o
            pri_s = norm(rz * sw_rz)
            if neq > 0:
                pri_s = pri_s + norm(ry * sw_ry)
            return pri_s, norm(rx * sw_rx), pri_o, dual_o

        def residuals(x, s, z, y):
            """Residual vectors in iterate coordinates (the RHS of the
            substitution-mode solves) and the norms in both coordinate
            systems: (rx, rz, ry, pri, dual, pri_o, dual_o)."""
            rx = bmv(Qm, x) + p_ + btmv(Gm, z)
            ry = None
            if neq > 0:
                rx = rx + btmv(Am, y)
                ry = bmv(Am, x) - b_
            rz = bmv(Gm, x) + s - h_
            if not scaled:
                pri = norm(rz) + (norm(ry) if neq > 0 else 0.0)
                dual = norm(rx)
                return rx, rz, ry, pri, dual, pri, dual
            rz_o, rx_o = rz / w_rz, rx / w_rx
            pri_o, pri = norm(rz_o), norm(rz_o * sw_rz)
            if neq > 0:
                ry_o = ry / w_ry
                pri_o = pri_o + norm(ry_o)
                pri = pri + norm(ry_o * sw_ry)
            return rx, rz, ry, pri, norm(rx_o * sw_rx), pri_o, norm(rx_o)

        def composed_step(x, s, z, y, reg, mu, rx, rz, ry):
            """One predictor-corrector step from the backend's factor and
            solves; returns the new state, the applied per-lane step (0
            on frozen lanes) and the regularization for the next iteration."""
            d = z / s
            # A lane whose last direction was NaN re-factors T + reg I, as the
            # exact elementwise transform d' = d / (1 + reg d). reg = 0 leaves
            # a healthy lane bit-identical.
            d = d / (1.0 + reg.unsqueeze(-1) * d)
            with span("qpth.ipm.step.factor"):
                if fast:
                    fac, ds_a, dz_a, dy_a = fast_predictor(z, y, d)
                else:
                    fac, dx_a, ds_a, dz_a, dy_a = kkt_factor_solve(
                        d, rx, z, rz, ry)

            def step_min(dz_, ds_):
                return torch.minimum(_step_to_boundary(z, dz_),
                                     _step_to_boundary(s, ds_))

            alpha = torch.minimum(step_min(dz_a, ds_a), one).unsqueeze(-1)
            t1 = ((s + alpha * ds_a) * (z + alpha * dz_a)).sum(dim=-1)
            t2 = (s * z).sum(dim=-1)
            sig = (t1 / t2) ** 3

            rs_c = ((-mu * sig).unsqueeze(-1) + ds_a * dz_a) / s
            with span("qpth.ipm.step.solve"):
                if fast:
                    ds_c, dz_c, dy_c = fast_corrector(fac, rs_c, d)
                    dx = None              # assembled after the corrections
                else:
                    dx_c, ds_c, dz_c, dy_c = kkt_solve(fac, d, None, rs_c,
                                                       None, None)
                    dx = dx_a + dx_c
            ds, dz = ds_a + ds_c, dz_a + dz_c
            dy = (dy_a + dy_c) if neq > 0 else None

            # Gondzio centrality corrections, accepted per lane only when the
            # step lengthens.
            for _ in range(config.n_correctors):
                a_g = torch.minimum(step_min(dz, ds), one)
                a_t = torch.minimum(1.08 * a_g + 0.08, one).unsqueeze(-1)
                v = (s + a_t * ds) * (z + a_t * dz)
                mu_t = (sig * mu).unsqueeze(-1)
                rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                          10.0 * mu_t)) / s
                with span("qpth.ipm.step.solve"):
                    if fast:
                        dds, ddz, ddy = fast_corrector(fac, rs_g, d)
                    else:
                        ddx, dds, ddz, ddy = kkt_solve(fac, d, None, rs_g,
                                                       None, None)
                dz_n, ds_n = dz + ddz, ds + dds
                a_n = torch.minimum(step_min(dz_n, ds_n), one)
                acc = (a_n > a_g).unsqueeze(-1)
                dz = torch.where(acc, dz_n, dz)
                ds = torch.where(acc, ds_n, ds)
                if neq > 0:
                    dy = torch.where(acc, dy + ddy, dy)
                if not fast:
                    dx = torch.where(acc, dx + ddx, dx)

            if fast and not xfree:
                dx = fast_combined_dx(x, z, y, dz, dy)
            alpha = torch.minimum(0.999 * step_min(dz, ds), one)
            # Freeze a lane whose factorization failed: alpha and the
            # directions both, since 0 * NaN is NaN. In xfree mode dx is never
            # formed; it is NaN exactly when dz is.
            lane_bad = torch.isnan(ds).any(-1) | torch.isnan(dz).any(-1)
            if not xfree:
                lane_bad = lane_bad | torch.isnan(dx).any(-1)
            if neq > 0:
                lane_bad = lane_bad | torch.isnan(dy).any(-1)
            mask = lane_bad.unsqueeze(-1)
            alpha = torch.where(mask, zero, alpha.unsqueeze(-1))
            if xfree:
                zeta = z + torch.where(mask, zero, dz)
                zy = (y + torch.where(mask, zero, dy)) if neq > 0 else None
                x = xp_step(x, alpha[:, 0], zeta, zy)
            else:
                x = x + alpha * torch.where(mask, zero, dx)
            s = s + alpha * torch.where(mask, zero, ds)
            z = z + alpha * torch.where(mask, zero, dz)
            if neq > 0:
                y = y + alpha * torch.where(mask, zero, dy)
            # Failed lanes start at ir_eps and grow 8x per repeat failure;
            # healthy lanes keep their shift.
            reg = torch.where(lane_bad,
                              torch.clamp(reg * 8.0, min=config.ir_eps), reg)
            return x, s, z, y, alpha[:, 0], reg

        inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
        best_x, best_s, best_z, best_y = x, s, z, y
        best_resids, best_resids_o = inf, inf
        mu = torch.zeros((B,), dtype=dtype, device=device)
        n_not = torch.zeros((B,) if per_lane_term else (), dtype=torch.int32,
                            device=device)
        lane_done = torch.zeros((B,), dtype=torch.bool, device=device)
        pri = dual = torch.zeros((B,), dtype=dtype, device=device)
        # The not-improved window advances once per scoring event: every
        # iteration normally, every checkpoint (by resid_every) in tracked
        # mode.
        inc = max(resid_every, 1) if track else 1
        iterations = 0
        rx = rz = ry = None

    with span("qpth.ipm.loop"):
        for it in range(config.max_iter):
            iterations = it + 1
            with span("qpth.ipm.score"):
                mu = mu_of(s, z)
                if track:
                    exact_now = ((it == 0) if resid_every == 0
                                 else it % resid_every == 0)
                    if exact_now:
                        pri, dual, pri_o, dual_o = exact_pri_dual(
                            x_of(x) if xfree else x, s, z, y)
                else:
                    exact_now = True
                    if fast:
                        pri, dual, pri_o, dual_o = exact_pri_dual(x, s, z, y)
                    else:
                        (rx, rz, ry, pri, dual, pri_o,
                         dual_o) = residuals(x, s, z, y)
                resids = pri + dual + nineq * mu_sel_of(mu)

                # Only exactly scored iterates enter the bookkeeping.
                if exact_now:
                    resids_o = (pri_o + dual_o + nineq * (mu / c_flat)
                                if scaled else resids)
                    improved_strict = resids < best_resids
                    improved = resids < best_resids * (1.0 - improve_margin)
                    best_resids = torch.where(improved_strict, resids,
                                              best_resids)
                    if scaled:
                        best_resids_o = torch.where(improved_strict, resids_o,
                                                    best_resids_o)
                    imp = improved_strict.unsqueeze(-1)
                    best_x = torch.where(imp, x, best_x)
                    best_s = torch.where(imp, s, best_s)
                    best_z = torch.where(imp, z, best_z)
                    best_y = torch.where(imp, y, best_y)
            with span("qpth.ipm.exit"):
                # The current tracked score counts too, so a solve
                # converging between checkpoints exits promptly.
                n_not, lane_done, done = exit_test(
                    config, per_lane_term, improved if exact_now else None,
                    n_not, lane_done, inc, (best_resids, resids) if track
                    else (best_resids,), mu)
                if config.verbose >= 1:
                    # The iteration's one host read carries the print's
                    # means.
                    vals = torch.stack([pri.mean(), dual.mean(), mu.mean(),
                                        done.to(dtype)])
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
                if use_fused and xfree:
                    zeta, s, z, a_l = backend.fused_step_xfree(
                        fs.R, s, z, q_t, config.n_correctors)
                    x = xp_step(x, a_l, zeta, None)
                elif use_fused:
                    x, s, z, a_l = backend.fused_step(
                        fs.R, fs.invQ_GT, x, s, z, q_t, ip_t,
                        config.n_correctors)
                elif use_fused_eq:
                    x, s, z, y, a_l = backend.fused_step_eq(
                        fs, x, s, z, y, q_t, ip_t, rb_t, config.n_correctors)
                else:
                    x, s, z, y, a_l, reg = composed_step(
                        x, s, z, y, reg, mu, rx, rz, ry)
                if track:
                    # The combined direction solves the Newton system
                    # exactly, so each feasibility residual norm scales by
                    # (1 - alpha).
                    pri, dual = pri * (1.0 - a_l), dual * (1.0 - a_l)

    with span("qpth.ipm.finish"):
        if xfree:
            x, best_x = x_of(x), x_of(best_x)

        if track:
            # Exact rescore of the final iterate; it wins where it beats the
            # recorded checkpoint best.
            pri_f, dual_f, pri_fo, dual_fo = exact_pri_dual(x, s, z, y)
            mu_f = mu_of(s, z)
            score_f = pri_f + dual_f + nineq * mu_sel_of(mu_f)
            take1 = score_f < best_resids
            take = take1.unsqueeze(-1)
            if scaled:
                score_fo = pri_fo + dual_fo + nineq * (mu_f / c_flat)
                best_resids_o = torch.where(take1, score_fo, best_resids_o)
            best_x = torch.where(take, x, best_x)
            best_s = torch.where(take, s, best_s)
            best_z = torch.where(take, z, best_z)
            best_y = torch.where(take, y, best_y)
            best_resids = torch.minimum(score_f, best_resids)

        if refined:
            maps = (m_x, m_s, m_z, m_y, w_rx, w_rz, w_ry) if scaled else None
            (best_x, best_s, best_z, best_y), best_resids, mu, _ = _refine(
                (best_x, best_s, best_z, best_y), Q, p, G, h, A, b, nineq,
                kkt_factor_solve, config, maps=maps, steps=refine_budget,
                early_exit=refine_early)

        if config.verbose >= 0:
            warn_inaccurate(config, best_resids, " Try SolverConfig("
                            "kkt_solver=KKTSolver.IR) or the CPU oracle.")

        # Stats are in original coordinates: the refined score is the original
        # problem's; the loop's recorded the original score beside the
        # semantic one.
        its = torch.tensor(iterations, dtype=torch.int32, device=device)
        if scaled and not refined:
            mu_best_o = (torch.abs((best_s * best_z).sum(dim=-1)) / nineq
                         / c_flat)
            stats = SolveStats(iterations=its, best_resids=best_resids_o,
                               mu=mu_best_o,
                               converged=best_resids_o < config.eps)
        else:
            stats = SolveStats(iterations=its, best_resids=best_resids, mu=mu,
                               converged=best_resids < config.eps)

        bx, bs, bz, by = to_orig(best_x, best_s, best_z, best_y)
        lo = None
        if config.escalate is not None:
            bx, bs, bz, by, lo, stats = _escalate_oracle(
                stats.best_resids > config.escalate_tol, bx, bs, bz, by, stats,
                Q, p, G, h, A, b, config)
    return QPSolution(z=bx, nu=by, lam=bz, s=bs, stats=stats, lo=lo)
