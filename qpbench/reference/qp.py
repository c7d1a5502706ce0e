"""Plain batched QP solver and its implicit-KKT gradients: the benchmark's
yardstick.

    z* = argmin_z 1/2 z^T Q z + p^T z   s.t.  G z <= h,  A z = b

A textbook primal-dual interior point method (Mehrotra predictor-corrector,
the algorithm of OptNet, arXiv:1703.00443, section 3) written with plain
``torch`` operations: every Newton system is the full saddle matrix
[[Q + G^T D G, A^T], [A, 0]] (D = lam / s) factored by ``torch.linalg``'s
LU, with no elimination beyond the slacks, no caching across iterations and
no kernels. The gradients are OptNet's equations (6)-(8) in the
symmetric form: with d = max(lam, c) / max(s, c) (c the configuration's
``grad_clamp``),

    [[Q + G^T diag(d) G, A^T], [A, 0]] [dx; dnu] = [-dl/dz; 0],
    dlam = d * (G dx),
    dQ = (dx z^T + z dx^T) / 2,  dp = dx,  dG = dlam z^T + lam dx^T,
    dh = -dlam,  dA = dnu z^T + nu dx^T,  db = -dnu.

Everything is batched over a leading lane dimension B; a shared matrix is
passed with batch 1 and expanded. Lanes are processed in blocks so that the
saddle matrices fit beside whatever else is resident. This module imports
nothing but ``torch``: it is independent of the solver under test.
"""

from __future__ import annotations

import torch


def _bmv(M, v):
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _btmv(M, v):
    return torch.matmul(M.transpose(-1, -2), v.unsqueeze(-1)).squeeze(-1)


def _saddle(Q, G, A, d):
    """[[Q + G^T diag(d) G, A^T], [A, 0]] for every lane."""
    H = Q + torch.matmul(G.transpose(-1, -2), d.unsqueeze(-1) * G)
    if A is None:
        return H
    B, n = H.shape[0], H.shape[-1]
    k = A.shape[-2]
    K = H.new_zeros((B, n + k, n + k))
    K[:, :n, :n] = H
    K[:, :n, n:] = A.expand(B, k, n).transpose(-1, -2)
    K[:, n:, :n] = A.expand(B, k, n)
    return K


def _max_step(v, dv):
    """Largest alpha in [0, 1] with v + alpha dv >= 0, per lane."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return ratio.amin(dim=-1).clamp(max=1.0)


def _solve_block(Q, p, G, h, A, b, max_iter, stall):
    B, n = p.shape
    m = h.shape[-1]
    k = 0 if A is None else A.shape[-2]

    def newton(lu, s, lam, rd, rpi, re, rc):
        rhs = -rd + _btmv(G, rc / s - (lam / s) * rpi)
        if k:
            rhs = torch.cat([rhs, -re], dim=-1)
        sol = torch.linalg.lu_solve(*lu, rhs.unsqueeze(-1)).squeeze(-1)
        dz, dnu = sol[:, :n], sol[:, n:]
        ds = -rpi - _bmv(G, dz)
        dlam = (-rc - lam * ds) / s
        return dz, ds, dlam, dnu

    # Initial point (OptNet's): the Newton system at D = I, then s and lam
    # shifted into the positive orthant.
    K0 = _saddle(Q, G, A, torch.ones_like(h))
    rhs = -p + _btmv(G, h)
    if k:
        rhs = torch.cat([rhs, b], dim=-1)
    sol = torch.linalg.solve_ex(K0, rhs.unsqueeze(-1))[0].squeeze(-1)
    z, nu = sol[:, :n], sol[:, n:]
    lam = _bmv(G, z) - h
    s = -lam

    def shift(v):
        lo = v.amin(dim=-1, keepdim=True)
        return torch.where(lo < 0, v - lo + 1.0, v)

    s, lam = shift(s), shift(lam)

    def residuals(z, s, lam, nu):
        rd = _bmv(Q, z) + p + _btmv(G, lam)
        if k:
            rd = rd + _btmv(A, nu)
        rpi = _bmv(G, z) + s - h
        re = _bmv(A, z) - b if k else z.new_zeros((B, 0))
        return rd, rpi, re

    def score_of(rd, rpi, re, s, lam):
        return (rd.norm(dim=-1) + rpi.norm(dim=-1) + re.norm(dim=-1)
                + (s * lam).sum(dim=-1).abs())

    best = (z, s, lam, nu)
    best_score = torch.full((B,), float("inf"), dtype=p.dtype,
                            device=p.device)
    since = torch.zeros((B,), dtype=torch.int64, device=p.device)
    for _ in range(max_iter):
        rd, rpi, re = residuals(z, s, lam, nu)
        score = score_of(rd, rpi, re, s, lam)
        better = score < best_score
        since = torch.where(score < best_score * (1 - 1e-3),
                            torch.zeros_like(since), since + 1)
        best_score = torch.where(better, score, best_score)
        best = tuple(torch.where(better.unsqueeze(-1), v, bv)
                     for v, bv in zip((z, s, lam, nu), best))
        live = (since < stall) & torch.isfinite(score)
        if not bool(live.any()):
            break
        mu = (s * lam).sum(dim=-1, keepdim=True) / m
        # A lane whose matrix is singular in the working precision gets
        # non-finite directions, a non-finite score next, and keeps its
        # best iterate.
        lu = torch.linalg.lu_factor_ex(_saddle(Q, G, A, lam / s))[:2]
        # Predictor (affine scaling).
        dz, ds, dlam, dnu = newton(lu, s, lam, rd, rpi, re, s * lam)
        a = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        a = a.unsqueeze(-1)
        mu_aff = ((s + a * ds) * (lam + a * dlam)).sum(
            dim=-1, keepdim=True) / m
        sigma = (mu_aff / mu) ** 3
        # Corrector.
        dz, ds, dlam, dnu = newton(lu, s, lam, rd, rpi, re,
                                   s * lam + ds * dlam - sigma * mu)
        a = 0.99 * torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        a = a.unsqueeze(-1)
        # A stopped lane keeps its iterate (its direction may not be
        # finite once s or lam reaches 0).
        keep = live.unsqueeze(-1)
        z, s, lam, nu = (torch.where(keep, v + a * dv, v) for v, dv in
                         ((z, dz), (s, ds), (lam, dlam), (nu, dnu)))
    z, s, lam, nu = best
    return z, s, lam, nu


def _lanes(v, B):
    """A batch-1 or batch-B tensor as B lanes (expanded, not copied)."""
    return v.expand(B, *v.shape[1:])


def _blocks(B, block):
    for i in range(0, B, block):
        yield slice(i, min(i + block, B))


def solve(Q, p, G, h, A=None, b=None, *, max_iter=80, stall=5,
          block=1024):
    """Solve every lane. Q (1 or B, n, n), p (B, n), G (1 or B, m, n),
    h (B, m), A (1 or B, k, n) or None, b (B, k) or None, all of one dtype.
    Returns a dict of z (B, n), s and lam (B, m), nu (B, k): the iterate
    with the smallest residual score, each lane stopped once its score has
    not improved by 0.1% for ``stall`` iterations."""
    B = p.shape[0]
    out = {key: [] for key in ("z", "s", "lam", "nu")}
    for sl in _blocks(B, block):
        nb = sl.stop - sl.start

        def take(v):
            if v is None:
                return None
            return _lanes(v, B)[sl] if v.shape[0] == B else _lanes(v, nb)

        res = _solve_block(take(Q), p[sl], take(G), h[sl], take(A),
                           None if b is None else b[sl], max_iter, stall)
        for key, v in zip(("z", "s", "lam", "nu"), res):
            out[key].append(v)
    return {key: torch.cat(v) for key, v in out.items()}


def gradients(Q, G, A, sol, dl_dz, clamp, *, shared=(), block=1024):
    """OptNet's implicit-KKT gradients of sum(dl_dz * z*) at ``sol`` (the
    dict :func:`solve` returns): a dict of Q, p, G, h (and A, b with
    equality rows). A name in ``shared`` gets its gradient summed over the
    lanes (shape of one lane); the others are per lane, (B, ...)."""
    B, n = dl_dz.shape
    k = 0 if A is None else A.shape[-2]
    parts = {key: [] for key in ("Q", "p", "G", "h", "A", "b")}
    for sl in _blocks(B, block):
        nb = sl.stop - sl.start

        def take(v):
            return _lanes(v, B)[sl] if v.shape[0] == B else _lanes(v, nb)

        Qs, Gs = take(Q), take(G)
        As = None if A is None else take(A)
        z, s, lam, nu = (sol[key][sl] for key in ("z", "s", "lam", "nu"))
        d = lam.clamp(min=clamp) / s.clamp(min=clamp)
        rhs = -dl_dz[sl]
        if k:
            rhs = torch.cat([rhs, rhs.new_zeros((nb, k))], dim=-1)
        x = torch.linalg.solve_ex(_saddle(Qs, Gs, As, d),
                                  rhs.unsqueeze(-1))[0].squeeze(-1)
        dx, dnu = x[:, :n], x[:, n:]
        dlam = d * _bmv(Gs, dx)
        block_grads = {"p": dx, "h": -dlam}
        # A shared matrix's gradient is summed here, so that no (B, ., .)
        # tensor of per-lane outer products is formed.
        for key, (u1, v1, u2, v2, half) in {
                "Q": (dx, z, z, dx, True), "G": (dlam, z, lam, dx, False),
                "A": (dnu, z, nu, dx, False)}.items():
            if key == "A" and not k:
                continue
            eq = "bi,bj->ij" if key in shared else "bi,bj->bij"
            g = torch.einsum(eq, u1, v1) + torch.einsum(eq, u2, v2)
            block_grads[key] = 0.5 * g if half else g
        if k:
            block_grads["b"] = -dnu
        for key, g in block_grads.items():
            parts[key].append(g)
    return {key: (torch.stack(v).sum(0) if key in shared else torch.cat(v))
            for key, v in parts.items() if v}
