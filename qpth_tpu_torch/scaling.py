"""Ruiz equilibration of the QP data (counterpart of ``qpth_tpu/scaling.py``).

Scaled problem (E: variable scaling, R_G / R_A: constraint row scalings,
c: cost scaling):

    Q~ = c E Q E      p~ = c E p
    G~ = R_G G E      h~ = R_G h
    A~ = R_A A E      b~ = R_A b

and back: x = E x~, lam = R_G lam~ / c, nu = R_A nu~ / c, s = s~ / R_G.
Every factor is a
power of two, so scaling and unscaling are exact in floating point. When a
matrix is shared (batch 1) the norms are max-reduced over the batch and one
shared scaling is used, so a shared Q/G is never materialized at batch
size. See the JAX module's docstring for the derivations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .profiling import span


class Scaling(NamedTuple):
    """Diagonal equilibration of a batch of QPs (minimal batch dims)."""

    #: Variable scaling, (b, nz).
    E: torch.Tensor
    #: Inequality row scaling, (b, nineq).
    RG: torch.Tensor
    #: Equality row scaling, (b, neq); None when neq == 0.
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


def scale_A(A, s: Scaling):
    """A~ = R_A A E (None passes through)."""
    if A is None:
        return None
    return A * (s.RA.unsqueeze(-1) * s.E.unsqueeze(-2))


def ruiz_scalings(Q, G, A=None, iters: int = 4, pow2: bool = True,
                  probe: bool = False, probe_spread: float = 16.0,
                  group=None):
    """Ruiz scalings of (Q, G, A) (not the scaled matrices).

    Q: (bQ, nz, nz); G: (bG, nineq, nz); A: (bA, neq, nz) or None. Returns
    ``(scaling, ok)``.

    ``group``: the ``torch.distributed`` process group of a batch-sharded
    solve. Where the matrices' batches differ, the norms collapse over the
    batch, and then over the group too (one ``all_reduce(MAX)`` each), so
    every rank scales a shared matrix alike. The probe's flag stays per
    rank, as under the JAX package's shard_map.

    ``probe``: when the row/column norm spreads are <= ``probe_spread`` and
    the magnitudes lie in (2^-10, 2^10), one Ruiz iteration from the
    probe's norms is the answer (``ok`` is True: the light branch); else
    the full ``iters`` sweeps run (``ok`` False). ``ok`` is None without
    the probe. The JAX package takes the branch inside ``lax.cond``; here
    it is one host read."""
    dt = Q.dtype
    bQ, nz = Q.shape[0], Q.shape[-1]
    bG, nineq = G.shape[0], G.shape[-2]
    batches = [bQ, bG] + ([A.shape[0]] if A is not None else [])
    bmax = max(batches)
    # Per-lane scalings only when every matrix carries the same batch.
    b = bmax if all(x == bmax for x in batches) else 1
    collapsing = b == 1 and bmax > 1

    def gmax(v):
        """Finish a batch-collapsed max over the group."""
        if collapsing and group is not None:
            import torch.distributed as dist

            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        return v

    aQ, aG = Q.abs(), G.abs()
    aA = A.abs() if A is not None else None
    probe = probe and iters > 0

    def rnd(v):
        return _pow2(v) if pow2 and v is not None else v

    def isqrt(v):
        return None if v is None else 1.0 / torch.sqrt(_safe(v))

    caQ = gmax(_colmax(aQ, b))
    cn0 = torch.maximum(caQ, gmax(_colmax(aG, b)))
    if A is not None:
        cn0 = torch.maximum(cn0, gmax(_colmax(aA, b)))
    rg0 = gmax(_rowmax(aG, b))
    ra0 = gmax(_rowmax(aA, b)) if A is not None else None

    def run_ruiz():
        E = torch.ones((b, nz), dtype=dt, device=Q.device)
        RG = torch.ones((b, nineq), dtype=dt, device=Q.device)
        RA = (torch.ones((b, A.shape[-2]), dtype=dt, device=Q.device)
              if A is not None else None)
        for k in range(iters):
            if k == 0:
                cn, rg, ra = cn0, rg0, ra0
            else:
                cn = torch.maximum(_wcolmax(aQ, E, b) * E,
                                   _wcolmax(aG, RG, b) * E)
                if A is not None:
                    cn = torch.maximum(cn, _wcolmax(aA, RA, b) * E)
                cn = gmax(cn)
                rg = gmax(_wrowmax(aG, E, b) * RG)
                ra = (gmax(_wrowmax(aA, E, b) * RA) if A is not None
                      else None)
            E, RG = E * rnd(isqrt(cn)), RG * rnd(isqrt(rg))
            RA = RA * rnd(isqrt(ra)) if A is not None else None
        qn = gmax(_wcolmax(aQ, E, b) * E).mean(dim=-1, keepdim=True)
        return E, RG, RA, rnd(1.0 / _safe(qn))

    def light():
        E1, RG1, RA1 = rnd(isqrt(cn0)), rnd(isqrt(rg0)), rnd(isqrt(ra0))
        qn = (E1 * E1 * caQ).mean(dim=-1, keepdim=True)
        return E1, RG1, RA1, rnd(1.0 / _safe(qn))

    ok = None
    if not probe:
        E, RG, RA, c = run_ruiz()
    else:
        def spread(v):
            vs = _safe(v)
            return (vs.amax(dim=-1) / vs.amin(dim=-1)).amax()

        flag = torch.ones((), dtype=torch.bool, device=Q.device)
        hi = torch.zeros((), dtype=dt, device=Q.device)
        lo = torch.full((), float("inf"), dtype=dt, device=Q.device)
        for v in (cn0, rg0) + ((ra0,) if A is not None else ()):
            flag = flag & (spread(v) <= probe_spread)
            hi = torch.maximum(hi, _safe(v).amax())
            lo = torch.minimum(lo, _safe(v).amin())
        flag = flag & (hi < 2.0 ** 10) & (lo > 2.0 ** -10)
        with span("qpth.sync"):
            ok = bool(flag)
        E, RG, RA, c = light() if ok else run_ruiz()
    return Scaling(E=E, RG=RG, RA=RA, c=c), ok


class IdentityScaling(Scaling):
    """The all-ones scaling of the probe's light branch, marked by its type:
    the factors stay in original coordinates, so the solver reads G and A
    themselves where the iterate coordinates' copies are asked for."""

    __slots__ = ()


def identity_like(s: Scaling) -> IdentityScaling:
    """All-ones scaling with s's shapes (the identity coordinates)."""
    return IdentityScaling(
        E=torch.ones_like(s.E), RG=torch.ones_like(s.RG),
        RA=torch.ones_like(s.RA) if s.RA is not None else None,
        c=torch.ones_like(s.c))


def scale_vecs(p, h, b, s: Scaling):
    """Scale the per-solve vectors (B, .) into equilibrated coordinates."""
    return (p * (s.c * s.E), h * s.RG,
            b * s.RA if b is not None else None)


def scale_point(x, slacks, z, y, s: Scaling):
    """Map an original-coordinates point (a warm start) into scaled
    coordinates: the inverse of the solution mapping above."""
    x = x / s.E
    z = z * (s.c / s.RG)
    slacks = slacks * s.RG
    if y is not None and y.shape[-1] > 0 and s.RA is not None:
        y = y * (s.c / s.RA)
    return x, slacks, z, y


def resolve_equilibrate(config, dtype) -> bool:
    """``SolverConfig.equilibrate``: "auto" = on below float64."""
    eq = config.equilibrate
    if eq == "auto":
        return torch.empty((), dtype=dtype).element_size() < 8
    return bool(eq)
