"""Batched IPM for diagonal-Q / diagonal-G QPs (counterpart of
``qpth_tpu/core/diag.py``).

With Q = diag(q) and G = diag(g) (nineq == nz), slack elimination with
d = z/s turns the Newton system into

    ds = -rz - g*dx
    dz = -rs + d*(rz + g*dx)
    H dx + A^T dy = -rx + g*rs - g*d*rz  =: rt,   H = q + g^2 d (a vector)
    A dx = -ry

so without equality rows dx = rt / H elementwise, and with them
M dy = A (rt/H) + ry with the (neq x neq) SPD M = A diag(1/H) A^T.

M is assembled by one batched product (``torch.matmul`` under
``full_precision``). Where M fits a thread block (``kernels.fits(neq,
dtype)``) its factor is Linv = inv(chol(M)) from kernel A (``factor_inv``
with dinv = 0) and every solve on it is ``inv_solve``; beyond the fit it is
``torch.linalg``'s Cholesky, the reference's own XLA branch. The CPU takes
the same branch as the card at the same size, so the two run the same
arithmetic. With ``SolverConfig(fused_diag_step=True)``, a shared A and a
fit (``kernels.diag_step_fits``), every stepping iteration is one
``diag_step`` launch after the M product.

Loop semantics (init + shift, residual score, best-iterate tracking, the
not-improved window, Mehrotra predictor-corrector with optional Gondzio
corrections, 0.999 step, NaN freeze) follow the reference line by line.
Its ``lax.while_loop`` is a Python ``for`` here with one host read of
``done`` per iteration: an iteration that finds ``done`` counts and does
not step, as ``lax.cond(done, identity, do_step)`` does there.
"""

from __future__ import annotations

import torch

from ..config import QPSolution, SolverConfig, SolveStats
from ..ops.cuda import kernels
from ..ops.kkt import no_library_path
from ..ops.linalg import bmv, btmv, cho_solve_vec, cholesky
from .pdipm import (_is_f64, _step_to_boundary, exit_test,
                    warn_inaccurate)


def _bvec(v, B):
    """A possibly-unbatched vector parameter as (B, n); a shared one is an
    expansion (batch stride 0), not a copy."""
    if v.dim() == 1:
        v = v.unsqueeze(0)
    return v.expand(B, v.shape[-1])


def _m_assemble(A, w):
    """M = A diag(w) A^T, (B, neq, neq), for A (1 or B, neq, n) and
    w (B, n)."""
    return torch.matmul(A * w.unsqueeze(-2), A.transpose(-1, -2))


def _factor_spd(M, use_kernels: bool):
    """Factor an assembled batched SPD M (B, k, k); returns the opaque
    factor :func:`_m_solve` takes: kernel A's Linv, or the Cholesky factor
    beyond the kernel's fit."""
    if use_kernels:
        zero_d = torch.zeros(M.shape[:2], dtype=M.dtype, device=M.device)
        return ("inv", kernels.factor_inv(M.contiguous(), zero_d))
    return ("chol", cholesky(M))


def _m_factor(A, w, use_kernels: bool):
    """Assemble and factor M = A diag(w) A^T."""
    return _factor_spd(_m_assemble(A, w), use_kernels)


def _m_solve(fac, r):
    kind, F = fac
    if kind == "inv":
        return kernels.inv_solve(F, r.contiguous())
    return cho_solve_vec(F, r)


def use_kernels_m(dtype, neq: int) -> bool:
    """Whether M's factor and solves run in kernels A and ``inv_solve``
    (counterpart of the reference's ``_use_pallas_m``): M fits a thread
    block. The reference's kernels are float32-only and it factors M in
    float64 by XLA; here the kernels take both dtypes, so the fit alone
    decides."""
    return neq > 0 and kernels.fits(neq, dtype)


def solve_diag(q, p, g, h, A, b, config: SolverConfig,
               init=None) -> QPSolution:
    """Batched IPM with Q = diag(q), G = diag(g).

    q, g: (B, n) or (n,) with q > 0; p, h: (B, n) or (n,); A: (bA, neq, n)
    with bA in {1, B}, or None; b: (B, neq) or (neq,). ``init``: a warm
    start (x, s, z, y), s and z clipped at ``config.warm_start_min``.
    Tensors on one device; call under ``ops.linalg.full_precision``."""
    p = p if p.dim() == 2 else p.unsqueeze(0)
    B = max(p.shape[0], h.shape[0] if h.dim() == 2 else 1)
    n = p.shape[-1]
    dtype, device = p.dtype, p.device

    q, g, p, h = (_bvec(v, B) for v in (q, g, p, h))
    if A is not None:
        A = A if A.dim() == 3 else A.unsqueeze(0)
        neq = A.shape[-2]
        b = _bvec(b, B)
    else:
        neq = 0
        b = None
    m = n  # G is diagonal: nineq == nz

    improve_margin = config.improve_margin
    if improve_margin is None:
        improve_margin = 0.0 if _is_f64(dtype) else 1e-3
    # Per-lane latched windows with a margin, the global window at 0.
    per_lane_term = improve_margin > 0.0

    # Every other use_pallas value runs the kernels here, as every value
    # but False / "xla" takes the lanes kernels in the JAX package's tier.
    no_library_path(config.use_pallas)
    use_kernels = use_kernels_m(dtype, neq)
    use_fused = (use_kernels and config.fused_diag_step and A is not None
                 and A.shape[0] == 1
                 and kernels.diag_step_fits(n, neq, dtype))
    if use_fused:
        A_k = A.contiguous()
        # A shared g is an expansion: the kernel reads its one row.
        g_k = g[:1].contiguous() if g.stride(0) == 0 else g.contiguous()

        def fused_step(x, s, z, y, rx, rz, ry):
            d = z / s
            H = q + g * g * d
            M = _m_assemble(A, 1.0 / H)
            return kernels.diag_step(
                M, A_k, g_k, H.contiguous(), rx.contiguous(),
                rz.contiguous(), ry.contiguous(), x.contiguous(),
                s.contiguous(), z.contiguous(), y.contiguous(),
                config.n_correctors)

    def solve_newton(H, fac, rx, rs, rz, ry, d):
        """Solve the H-system; a residual block given as None is
        structurally zero (the corrector's RHS is rs alone)."""
        return solve_kkt_diag(q, g, A, d, H, fac, rx, rs, rz, ry, B, n,
                              dtype)

    def factor(d):
        H = q + g * g * d
        fac = _m_factor(A, 1.0 / H, use_kernels) if neq > 0 else None
        return H, fac

    # ---- Init: d = 1, RHS (p, 0, -h, -b) ----
    if init is None:
        ones = torch.ones((B, m), dtype=dtype, device=device)
        H0, fac0 = factor(ones)
        x, s, z, y = solve_newton(H0, fac0, p, None, -h,
                                  -b if neq > 0 else None, ones)

        def shift_pos(v):
            mn = v.amin(dim=-1, keepdim=True)
            return torch.where(mn < 0, v - mn + 1.0, v)

        s = shift_pos(s)
        z = shift_pos(z)
    else:
        x, s, z, y = init
        s = torch.clamp(s, min=config.warm_start_min)
        z = torch.clamp(z, min=config.warm_start_min)
    if y is None:
        y = torch.zeros((B, 0), dtype=dtype, device=device)

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    def residuals(x, s, z, y):
        rx = q * x + p + g * z
        if neq > 0:
            rx = rx + btmv(A, y)
            ry = bmv(A, x) - b
            y_resid = norm(ry)
        else:
            ry = None
            y_resid = torch.zeros((B,), dtype=dtype, device=device)
        rz = g * x + s - h
        mu = torch.abs((s * z).sum(dim=-1) / m)
        resids = y_resid + norm(rz) + norm(rx) + m * mu
        return rx, rz, ry, mu, resids

    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def step_min(z, s, dz, ds):
        return torch.minimum(_step_to_boundary(z, dz),
                             _step_to_boundary(s, ds))

    def composed_step(x, s, z, y, mu, rx, rz, ry):
        d = z / s
        H, fac = factor(d)

        # Predictor (rs := z).
        dx_a, ds_a, dz_a, dy_a = solve_newton(H, fac, rx, z, rz, ry, d)
        alpha = torch.minimum(step_min(z, s, dz_a, ds_a), one).unsqueeze(-1)
        t1 = ((s + alpha * ds_a) * (z + alpha * dz_a)).sum(dim=-1)
        t2 = (s * z).sum(dim=-1)
        sig = (t1 / t2) ** 3

        # Corrector: RHS zero except rs.
        rs_c = ((-mu * sig).unsqueeze(-1) + ds_a * dz_a) / s
        dx_c, ds_c, dz_c, dy_c = solve_newton(H, fac, None, rs_c, None,
                                              None, d)
        dx, ds, dz = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c
        dy = (dy_a + dy_c) if neq > 0 else None

        # Gondzio centrality corrections, accepted per lane when the step
        # lengthens.
        for _ in range(config.n_correctors):
            a_g = torch.minimum(step_min(z, s, dz, ds), one)
            a_t = torch.minimum(1.08 * a_g + 0.08, one).unsqueeze(-1)
            v = (s + a_t * ds) * (z + a_t * dz)
            mu_t = (sig * mu).unsqueeze(-1)
            rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                      10.0 * mu_t)) / s
            ddx, dds, ddz, ddy = solve_newton(H, fac, None, rs_g, None,
                                              None, d)
            dz_n, ds_n = dz + ddz, ds + dds
            a_n = torch.minimum(step_min(z, s, dz_n, ds_n), one)
            acc = (a_n > a_g).unsqueeze(-1)
            dz = torch.where(acc, dz_n, dz)
            ds = torch.where(acc, ds_n, ds)
            dx = torch.where(acc, dx + ddx, dx)
            if neq > 0:
                dy = torch.where(acc, dy + ddy, dy)

        alpha = torch.minimum(0.999 * step_min(z, s, dz, ds), one)
        lane_bad = (torch.isnan(dx).any(-1) | torch.isnan(ds).any(-1)
                    | torch.isnan(dz).any(-1))
        if neq > 0:
            lane_bad = lane_bad | torch.isnan(dy).any(-1)
        msk = lane_bad.unsqueeze(-1)
        alpha = torch.where(msk, zero, alpha.unsqueeze(-1))
        x = x + alpha * torch.where(msk, zero, dx)
        s = s + alpha * torch.where(msk, zero, ds)
        z = z + alpha * torch.where(msk, zero, dz)
        if neq > 0:
            y = y + alpha * torch.where(msk, zero, dy)
        return x, s, z, y

    inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
    best_x, best_s, best_z, best_y = x, s, z, y
    best_resids = inf
    mu = torch.zeros((B,), dtype=dtype, device=device)
    n_not = torch.zeros((B,) if per_lane_term else (), dtype=torch.int32,
                        device=device)
    lane_done = torch.zeros((B,), dtype=torch.bool, device=device)
    iterations = 0

    for it in range(config.max_iter):
        iterations = it + 1
        rx, rz, ry, mu, resids = residuals(x, s, z, y)

        improved_strict = resids < best_resids
        improved = resids < best_resids * (1.0 - improve_margin)
        best_resids = torch.where(improved_strict, resids, best_resids)
        imp = improved_strict.unsqueeze(-1)
        best_x = torch.where(imp, x, best_x)
        best_s = torch.where(imp, s, best_s)
        best_z = torch.where(imp, z, best_z)
        if neq > 0:
            best_y = torch.where(imp, y, best_y)

        n_not, lane_done, done = exit_test(config, per_lane_term, improved,
                                           n_not, lane_done, 1,
                                           (best_resids,), mu)
        if bool(done):  # the one host read per iteration
            break
        if use_fused:
            x, s, z, y = fused_step(x, s, z, y, rx, rz, ry)
        else:
            x, s, z, y = composed_step(x, s, z, y, mu, rx, rz, ry)

    if config.verbose >= 0:
        warn_inaccurate(config, best_resids)

    stats = SolveStats(
        iterations=torch.tensor(iterations, dtype=torch.int32,
                                device=device),
        best_resids=best_resids, mu=mu,
        converged=best_resids < config.eps)
    return QPSolution(z=best_x, nu=best_y, lam=best_z, s=best_s, stats=stats)


def solve_kkt_diag(q, g, A, d, H, fac, rx, rs, rz, ry, B, n, dtype):
    """One Newton solve of the diagonal-structure KKT system on a factor
    of M made before (the solver's steps and the backward's rx-only RHS).
    Returns (dx, ds, dz, dy), dy None without equality rows."""
    rt = torch.zeros((B, n), dtype=dtype, device=d.device)
    if rx is not None:
        rt = rt - rx
    if rs is not None:
        rt = rt + g * rs
    if rz is not None:
        rt = rt - g * d * rz
    if A is not None:
        rhs = bmv(A, rt / H)
        if ry is not None:
            rhs = rhs + ry
        dy = _m_solve(fac, rhs)
        dx = (rt - btmv(A, dy)) / H
    else:
        dy = None
        dx = rt / H
    gdx = g * dx
    ds = -gdx if rz is None else (-rz - gdx)
    dz = -d * ds if rs is None else (-rs - d * ds)
    return dx, ds, dz, dy
