"""Ruiz equilibration of the QP data (counterpart of ``qpth_tpu/scaling.py``,
ported for neq = 0).

Scaled problem (E: variable scaling, R_G: constraint row scaling, c: cost
scaling):

    Q~ = c E Q E      p~ = c E p
    G~ = R_G G E      h~ = R_G h

and back: x = E x~, lam = R_G lam~ / c, s = s~ / R_G. Every factor is a
power of two, so scaling and unscaling are exact in floating point. When a
matrix is shared (batch 1) the norms are max-reduced over the batch and one
shared scaling is used, so a shared Q/G is never materialized at batch
size. See the JAX module's docstring for the derivations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Scaling(NamedTuple):
    """Diagonal equilibration of a batch of QPs (minimal batch dims)."""

    #: Variable scaling, (b, nz).
    E: torch.Tensor
    #: Inequality row scaling, (b, nineq).
    RG: torch.Tensor
    #: Equality row scaling; None (neq > 0 is not ported).
    RA: Optional[torch.Tensor]
    #: Cost scaling, (b, 1).
    c: torch.Tensor


def _pow2(x):
    """Round positive values to the nearest power of two. ``ldexp`` with an
    integer exponent is exact; ``exp2`` need not be."""
    return torch.ldexp(torch.ones_like(x),
                       torch.round(torch.log2(x)).to(torch.int32))


def _safe(n):
    """Guard zero norms (empty rows/cols scale by 1)."""
    return torch.where(n > 0, n, torch.ones_like(n))


def _colmax(aM, b):
    """max_i |M[i, j]| per column j, batch max-reduced to b lanes."""
    m = aM.amax(dim=-2)
    if aM.shape[0] > b:
        m = m.amax(dim=0, keepdim=True)
    return m


def _rowmax(aM, b):
    m = aM.amax(dim=-1)
    if aM.shape[0] > b:
        m = m.amax(dim=0, keepdim=True)
    return m


def _wcolmax(aM, r, b):
    """Column norms of diag(r) @ aM, batch-collapsed."""
    m = (aM * r.unsqueeze(-1)).amax(dim=-2)
    if aM.shape[0] > b:
        m = m.amax(dim=0, keepdim=True)
    return m


def _wrowmax(aM, cw, b):
    """Row norms of aM @ diag(cw), batch-collapsed."""
    m = (aM * cw.unsqueeze(-2)).amax(dim=-1)
    if aM.shape[0] > b:
        m = m.amax(dim=0, keepdim=True)
    return m


def scale_Q(Q, s: Scaling):
    """Q~ = c E Q E."""
    return Q * (s.c.unsqueeze(-1) * s.E.unsqueeze(-1) * s.E.unsqueeze(-2))


def scale_G(G, s: Scaling):
    """G~ = R_G G E."""
    return G * (s.RG.unsqueeze(-1) * s.E.unsqueeze(-2))


def ruiz_scalings(Q, G, iters: int = 4, pow2: bool = True,
                  probe: bool = False, probe_spread: float = 16.0):
    """Ruiz scalings of (Q, G) (not the scaled matrices).

    Q: (bQ, nz, nz); G: (bG, nineq, nz). Returns ``(scaling, ok)``.

    ``probe``: when the row/column norm spreads are <= ``probe_spread`` and
    the magnitudes lie in (2^-10, 2^10), one Ruiz iteration from the
    probe's norms is the answer (``ok`` is True: the light branch); else
    the full ``iters`` sweeps run (``ok`` False). ``ok`` is None without
    the probe. The JAX package takes the branch inside ``lax.cond``; here
    it is one host read."""
    dt = Q.dtype
    bQ, nz = Q.shape[0], Q.shape[-1]
    bG, nineq = G.shape[0], G.shape[-2]
    bmax = max(bQ, bG)
    # Per-lane scalings only when every matrix carries the same batch.
    b = bmax if bQ == bG else 1
    aQ, aG = Q.abs(), G.abs()
    probe = probe and iters > 0

    caQ = _colmax(aQ, b)
    cn0 = torch.maximum(caQ, _colmax(aG, b))
    rg0 = _rowmax(aG, b)

    def run_ruiz():
        E = torch.ones((b, nz), dtype=dt, device=Q.device)
        RG = torch.ones((b, nineq), dtype=dt, device=Q.device)
        for k in range(iters):
            if k == 0:
                cn, rg = cn0, rg0
            else:
                cn = torch.maximum(_wcolmax(aQ, E, b) * E,
                                   _wcolmax(aG, RG, b) * E)
                rg = _wrowmax(aG, E, b) * RG
            dE = 1.0 / torch.sqrt(_safe(cn))
            dG = 1.0 / torch.sqrt(_safe(rg))
            if pow2:
                dE, dG = _pow2(dE), _pow2(dG)
            E, RG = E * dE, RG * dG
        qn = (_wcolmax(aQ, E, b) * E).mean(dim=-1, keepdim=True)
        c = 1.0 / _safe(qn)
        if pow2:
            c = _pow2(c)
        return E, RG, c

    def light():
        E1 = 1.0 / torch.sqrt(_safe(cn0))
        RG1 = 1.0 / torch.sqrt(_safe(rg0))
        if pow2:
            E1, RG1 = _pow2(E1), _pow2(RG1)
        qn = (E1 * E1 * caQ).mean(dim=-1, keepdim=True)
        c1 = 1.0 / _safe(qn)
        if pow2:
            c1 = _pow2(c1)
        return E1, RG1, c1

    ok = None
    if not probe:
        E, RG, c = run_ruiz()
    else:
        def spread(v):
            vs = _safe(v)
            return (vs.amax(dim=-1) / vs.amin(dim=-1)).amax()

        flag = torch.ones((), dtype=torch.bool, device=Q.device)
        hi = torch.zeros((), dtype=dt, device=Q.device)
        lo = torch.full((), float("inf"), dtype=dt, device=Q.device)
        for v in (cn0, rg0):
            flag = flag & (spread(v) <= probe_spread)
            hi = torch.maximum(hi, _safe(v).amax())
            lo = torch.minimum(lo, _safe(v).amin())
        flag = flag & (hi < 2.0 ** 10) & (lo > 2.0 ** -10)
        ok = bool(flag)
        E, RG, c = light() if ok else run_ruiz()
    return Scaling(E=E, RG=RG, RA=None, c=c), ok


def identity_like(s: Scaling) -> Scaling:
    """All-ones scaling with s's shapes (the identity coordinates)."""
    return Scaling(E=torch.ones_like(s.E), RG=torch.ones_like(s.RG),
                   RA=None, c=torch.ones_like(s.c))


def scale_vecs(p, h, s: Scaling):
    """Scale the per-solve vectors (B, .) into equilibrated coordinates."""
    return p * (s.c * s.E), h * s.RG


def resolve_equilibrate(config, dtype) -> bool:
    """``SolverConfig.equilibrate``: "auto" = on below float64."""
    eq = config.equilibrate
    if eq == "auto":
        return torch.empty((), dtype=dtype).element_size() < 8
    return bool(eq)
