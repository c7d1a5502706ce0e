"""Independent float64 CPU oracle (a copy of ``qpth_tpu/solvers/oracle.py``;
the port imports nothing of the JAX package, so it keeps its own).

Plays the role of upstream qpth's per-instance CVXPY solver path: an
implementation on a *different* code path from the batched device solver.
``QPSolvers.CPU_ORACLE`` solves whole batches with it
(``qp.py::_oracle_forward``) and ``SolverConfig(escalate="oracle")``
re-solves the lanes the device left inaccurate
(``core/pdipm.py::_escalate_oracle``).

Deliberately different implementation choices from the device solver so
bugs don't correlate: numpy float64, the *unreduced* augmented KKT system
solved with pivoted LAPACK (``numpy.linalg.solve``), infinity-norm
termination, and a fraction-to-boundary rule instead of best-iterate
tracking.

The JAX package also has a native C++ twin of this oracle (same answers,
faster); it is not ported yet.
"""

from __future__ import annotations

import numpy as np


def solve_qp_np(Q, p, G, h, A=None, b=None, tol=1e-11, max_iter=100,
                return_status: bool = False):
    """Solve  min 1/2 x^T Q x + p^T x  s.t. Gx <= h, Ax = b  in float64.

    Returns (objective, x, nu, lam, slacks) mirroring the reference oracle's
    return contract (cvxpy.py:31): nu is None when there are no equality
    constraints. With ``return_status=True`` a trailing int is appended:
    0 = converged, 1 = max_iter reached (best effort).
    """
    Q = np.asarray(Q, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    has_eq = A is not None and np.size(A) > 0
    if has_eq:
        A = np.asarray(A, dtype=np.float64).reshape(-1, len(p))
        b = np.asarray(b, dtype=np.float64).ravel()
        neq = A.shape[0]
    else:
        A, b, neq = None, None, 0

    n = p.shape[0]
    m = G.shape[0]

    # Robust strictly-interior start.
    x = np.linalg.solve(Q + np.eye(n), -p)
    s = np.maximum(h - G @ x, 1.0)
    z = np.ones(m)
    y = np.zeros(neq)

    def residuals(x, s, z, y):
        rd = Q @ x + p + G.T @ z + (A.T @ y if has_eq else 0.0)
        rp = G @ x + s - h
        re = A @ x - b if has_eq else np.zeros(0)
        return rd, rp, re

    def newton(rd, rp, re, rc, s, z, reg=0.0):
        """Solve the augmented system in (dx, dz, dy) after eliminating
        ds = (-rc - s*dz) / z from the complementarity row.

        ``reg``: primal-dual Tikhonov regularization (+reg on the primal
        block, -reg on the dual blocks — the standard symmetric
        quasidefinite shift) for degenerate/extreme-conditioning
        instances; returns None on a singular or non-finite solve so the
        caller can escalate reg instead of polluting the iterate."""
        k = n + m + neq
        M = np.zeros((k, k))
        M[:n, :n] = Q + reg * np.eye(n)
        M[:n, n:n + m] = G.T
        M[n:n + m, :n] = G
        M[n:n + m, n:n + m] = -np.diag(s / z) - reg * np.eye(m)
        if has_eq:
            M[:n, n + m:] = A.T
            M[n + m:, :n] = A
            M[n + m:, n + m:] = -reg * np.eye(neq)
        rhs = np.concatenate([-rd, -rp + rc / z, -re])
        try:
            sol = np.linalg.solve(M, rhs)
        except np.linalg.LinAlgError:
            return None
        if not np.isfinite(sol).all():
            return None
        dx, dz, dy = sol[:n], sol[n:n + m], sol[n + m:]
        ds = (-rc - s * dz) / z
        if not np.isfinite(ds).all():
            return None
        return dx, ds, dz, dy

    def newton_safe(rd, rp, re, rc, s, z):
        """newton() with escalating regularization — the f64 analog of
        the device solver's per-lane adaptive Tikhonov (core/pdipm.py):
        exact solve first, then reg growing 100x until the direction is
        finite. None only when every level fails."""
        d = newton(rd, rp, re, rc, s, z)
        reg = 1e-12
        while d is None and reg <= 1e-2:
            d = newton(rd, rp, re, rc, s, z, reg=reg)
            reg *= 100.0
        return d

    def max_step(v, dv):
        neg = dv < 0
        if not np.any(neg):
            return 1.0
        return min(1.0, np.min(-v[neg] / dv[neg]))

    converged = False
    best = None  # (score, x, s, z, y) — returned if the loop breaks down
    for _ in range(max_iter):
        rd, rp, re = residuals(x, s, z, y)
        mu = s @ z / m
        score = max(np.abs(rd).max(), np.abs(rp).max(),
                    np.abs(re).max() if has_eq else 0.0, abs(mu))
        if np.isfinite(score) and (best is None or score < best[0]):
            best = (score, x.copy(), s.copy(), z.copy(), y.copy())
        if (max(np.abs(rd).max(), np.abs(rp).max(),
                np.abs(re).max() if has_eq else 0.0) < tol and mu < tol):
            converged = True
            break

        # Predictor.
        rc_aff = s * z
        d_a = newton_safe(rd, rp, re, rc_aff, s, z)
        if d_a is None:
            break       # out of regularization headroom: keep the best
        dx_a, ds_a, dz_a, dy_a = d_a
        a_p = max_step(s, ds_a)
        a_d = max_step(z, dz_a)
        mu_aff = (s + a_p * ds_a) @ (z + a_d * dz_a) / m
        sigma = min((mu_aff / mu) ** 3, 1.0) if mu > 0 else 1.0

        # Corrector (combined direction).
        rc = s * z + ds_a * dz_a - sigma * mu
        d_c = newton_safe(rd, rp, re, rc, s, z)
        if d_c is None:
            break
        dx, ds, dz, dy = d_c
        eta = 0.99995
        a_p = eta * max_step(s, ds)
        a_d = eta * max_step(z, dz)
        alpha = min(a_p, a_d)
        if not np.isfinite(alpha):
            break

        x = x + alpha * dx
        s = s + alpha * ds
        z = z + alpha * dz
        if has_eq:
            y = y + alpha * dy
        # Keep the slack pair strictly positive: underflowed entries make
        # every subsequent d = s/z division meaningless.
        s = np.maximum(s, 1e-300)
        z = np.maximum(z, 1e-300)

    # Final-iterate vs best-iterate: return the better-scored point (the
    # loop above may have broken down after its best iterate).
    rd, rp, re = residuals(x, s, z, y)
    mu = s @ z / m
    score = max(np.abs(rd).max(), np.abs(rp).max(),
                np.abs(re).max() if has_eq else 0.0, abs(mu))
    if best is not None and not (np.isfinite(score) and score <= best[0]):
        _, x, s, z, y = best

    obj = 0.5 * x @ Q @ x + p @ x
    out = (obj, x, (y if has_eq else None), z, s)
    return out + (0 if converged else 1,) if return_status else out


def solve_qp_batch_np(Q, p, G, h, A=None, b=None,
                      return_status: bool = False, **kw):
    """Loop the oracle over a batch, broadcasting unbatched params —
    the numpy analog of the reference's CVXPY batch loop (qp.py:104-115).

    Per-lane failure isolation: a lane whose solve hits a singular system
    (infeasible/degenerate instance — exactly the inputs this oracle
    exists to debug) gets NaN-filled outputs instead of aborting the
    batch; healthy lanes keep their solutions. ``return_status=True``
    appends a per-lane int array (0 = ok, -1 = failed).
    """
    p = np.asarray(p)
    B = p.shape[0] if p.ndim == 2 else 1
    p2 = np.atleast_2d(p)

    def get(M, i, nd):
        if M is None or np.size(M) == 0:
            return None
        M = np.asarray(M)
        if M.ndim == nd:
            return M[i if M.shape[0] > 1 else 0]  # batch-1 = shared
        return M

    n = p2.shape[1]
    m = np.asarray(G).shape[-2]
    Ai0 = get(A, 0, 3)
    neq = Ai0.shape[0] if Ai0 is not None else 0
    has_eq = neq > 0

    status = np.zeros((B,), dtype=np.int32)
    xs, nus, lams, ss = [], [], [], []
    for i in range(B):
        try:
            _, x, nu, lam, s, st = solve_qp_np(
                get(Q, i, 3), p2[i], get(G, i, 3), get(h, i, 2),
                get(A, i, 3), get(b, i, 2), return_status=True, **kw)
            status[i] = st
            if not (np.isfinite(x).all() and np.isfinite(lam).all()
                    and np.isfinite(s).all()
                    and (nu is None or np.isfinite(nu).all())):
                raise np.linalg.LinAlgError("non-finite iterate")
        except np.linalg.LinAlgError:
            status[i] = -1
            x = np.full(n, np.nan)
            lam = np.full(m, np.nan)
            s = np.full(m, np.nan)
            nu = np.full(neq, np.nan) if has_eq else None
        xs.append(x)
        nus.append(nu)
        lams.append(lam)
        ss.append(s)
    nu_arr = np.stack(nus) if has_eq else np.zeros((B, 0))
    out = (np.stack(xs), nu_arr, np.stack(lams), np.stack(ss))
    return out + (status,) if return_status else out
