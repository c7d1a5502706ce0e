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

The loop is the dense tier's (``core/pdipm.py::ipm_loop``, with its
init shift, best-iterate tracking, window, Mehrotra predictor-corrector
with Gondzio corrections and NaN freeze); this tier supplies its residual
score and its step, and follows the reference line by line.
"""

from __future__ import annotations

import torch

from ..config import QPSolution, SolverConfig
from ..ops.cuda import kernels
from ..ops.kkt import no_library_path
from ..ops.linalg import bmv, btmv, cho_solve_vec, cholesky
from .pdipm import (Score, _norm, damped_update, finish_stats, ipm_loop,
                    pc_direction, resolve_improve_margin, start_point)


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

    # Every other use_pallas value runs the kernels here, as every value
    # but False / "xla" takes the lanes kernels in the JAX package's tier.
    no_library_path(config.use_pallas)
    use_kernels = use_kernels_m(dtype, neq)
    use_fused = (use_kernels and config.fused_diag_step and A is not None
                 and A.shape[0] == 1
                 and kernels.diag_step_fits(n, neq, dtype))

    def factor(d):
        """(H, the factor of M) at d."""
        H = q + g * g * d
        return H, (_m_factor(A, 1.0 / H, use_kernels) if neq > 0 else None)

    def newton(fac, d, rx, rs, rz, ry):
        """Solve the H-system on ``factor(d)``; a residual block given as
        None is structurally zero (the corrector's RHS is rs alone)."""
        return solve_kkt_diag(q, g, A, d, *fac, rx, rs, rz, ry, B, n, dtype)

    def solve_init():
        ones = torch.ones((B, m), dtype=dtype, device=device)
        return newton(factor(ones), ones, p, None, -h,
                      -b if neq > 0 else None)

    x, s, z, y = start_point(config, init, solve_init, B, dtype, device)

    def score(it, x, s, z, y):
        rx = q * x + p + g * z
        if neq > 0:
            rx = rx + btmv(A, y)
            ry = bmv(A, x) - b
            y_resid = _norm(ry)
        else:
            ry = None
            y_resid = torch.zeros((B,), dtype=dtype, device=device)
        rz = g * x + s - h
        mu = torch.abs((s * z).sum(dim=-1) / m)
        return Score(y_resid + _norm(rz) + _norm(rx) + m * mu, mu,
                     res=(rx, rz, ry))

    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def predict(z, y, d, res):
        rx, rz, ry = res
        fac = factor(d)
        return (fac,) + newton(fac, d, rx, z, rz, ry)

    def correct(fac, d, rs):
        return newton(fac, d, None, rs, None, None)

    def composed_step(x, s, z, y, mu, res):
        d = z / s
        dirs = pc_direction(s, z, y, mu, d, res, predict, correct,
                            config.n_correctors, one)
        return damped_update(x, s, z, y, *dirs, one, zero)[:4]

    if use_fused:
        A_k = A.contiguous()
        # A shared g is an expansion: the kernel reads its one row.
        g_k = g[:1].contiguous() if g.stride(0) == 0 else g.contiguous()

        def fused_step(x, s, z, y, mu, res):
            rx, rz, ry = res
            d = z / s
            H = q + g * g * d
            M = _m_assemble(A, 1.0 / H)
            return kernels.diag_step(
                M, A_k, g_k, H.contiguous(), rx.contiguous(),
                rz.contiguous(), ry.contiguous(), x.contiguous(),
                s.contiguous(), z.contiguous(), y.contiguous(),
                config.n_correctors)

    out = ipm_loop(config, (x, s, z, y), score,
                   fused_step if use_fused else composed_step,
                   resolve_improve_margin(config, dtype))
    stats = finish_stats(config, out.iterations, out.best_resids, out.mu)
    best_x, best_s, best_z, best_y = out.best
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
