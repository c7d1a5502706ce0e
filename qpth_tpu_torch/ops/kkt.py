"""KKT linear-algebra layer (counterpart of ``qpth_tpu/ops/kkt.py``).

Per IPM iteration the Newton system is reduced, by slack elimination with
D = diag(z/s), to the Schur complement in the dual variables

    S = [ A Q^-1 A^T     A Q^-1 G^T          ]
        [ G Q^-1 A^T     G Q^-1 G^T + D^-1   ]

whose iteration-varying block is T = R + diag(1/d) with
R = G Q^-1 G^T - S21 S11^-1 S21^T (S11 = A Q^-1 A^T, S21 = G Q^-1 A^T).
The one-time prefactorization caches either explicit inverses and products
(inverse mode: Q^-1, S11^-1, Q^-1 G^T, Q^-1 A^T; the float32 default) or
Cholesky factors of Q and S11 (substitution mode; the float64 default).

The per-iteration work on T runs in the port's kernels through
:class:`KKTBackend`; the tensors' device picks kernel or plain version.
T's factor is always Linv = inv(chol(T)) from kernel A, also in
substitution mode, where the JAX package's XLA backend keeps chol(T) and
substitutes: every further solve on it is ``inv_solve``. Q and S11 are
factored outside any kernel, as in the JAX package: the inverses by kernel
A and one Gram product, the Cholesky factors by ``torch.linalg``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda import kernels
from .linalg import bmm, bmv, btmv, cho_solve, cho_solve_vec, cholesky


class KKTFactors(NamedTuple):
    """Cached one-time factorization products. Batch dims are minimal (1
    if the parameter is shared). Field names and meanings follow the JAX
    package's ``KKTFactors``: substitution mode keeps L_Q / L_S11, inverse
    mode invQ / invS11 and the cached products.
    """

    #: Lower Cholesky of Q, (bQ, nz, nz); None in inverse mode.
    L_Q: Optional[torch.Tensor]
    #: Schur complement core G Q^-1 G^T - S21 S11^-1 S21^T,
    #: (b, nineq, nineq).
    R: torch.Tensor
    #: Lower Cholesky of S11 = A Q^-1 A^T; None when neq == 0 or in
    #: inverse mode.
    L_S11: Optional[torch.Tensor]
    #: S21 = G Q^-1 A^T, (b, nineq, neq); None when neq == 0.
    S21: Optional[torch.Tensor]
    #: W = S11^-1 S21^T, (b, neq, nineq); None when neq == 0.
    W: Optional[torch.Tensor]
    #: Q^-1, (bQ, nz, nz); None in substitution mode.
    invQ: Optional[torch.Tensor] = None
    #: S11^-1, (b, neq, neq); None when neq == 0 or substitution mode.
    invS11: Optional[torch.Tensor] = None
    #: Q^-1 G^T, (b, nz, nineq); None unless inverse mode.
    invQ_GT: Optional[torch.Tensor] = None
    #: Q^-1 A^T, (b, nz, neq); None unless inverse mode with neq > 0.
    invQ_AT: Optional[torch.Tensor] = None
    #: G Q^-1 G^T, (b, nineq, nineq); None unless inverse mode. Equal to R
    #: when neq == 0.
    GiGT: Optional[torch.Tensor] = None
    #: S11 = A Q^-1 A^T, (b, neq, neq); None unless inverse mode, neq > 0.
    S11: Optional[torch.Tensor] = None
    #: Blocked factor of Q beyond the kernel fit (hybrid path; not ported:
    #: always None).
    facQ: Optional[object] = None
    #: Coordinates of the cached products (scaling.Scaling): identity
    #: values when the equilibration probe kept the factors unscaled.
    scaling: Optional[object] = None
    #: The Ruiz scalings themselves (drive the solver's vector-space
    #: behaviors: init shift, clamps, scoring).
    sem_scaling: Optional[object] = None


def _spd_inv(M):
    """Batched SPD inverse: kernel A gives Linv = inv(chol(M)), then
    M^-1 = Linv^T Linv by one batched product."""
    B, n = M.shape[0], M.shape[-1]
    zero_d = torch.zeros((B, n), dtype=M.dtype, device=M.device)
    Linv = kernels.factor_inv(M.contiguous(), zero_d)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


def _q_rep(Q):
    """Inverse-mode representation of Q^-1: (invQ, facQ) with the explicit
    inverse. Beyond kernel A's shared-memory fit the JAX package switches
    to a blocked factor (the hybrid path), which is not ported."""
    nz = Q.shape[-1]
    if Q.device.type == "cuda" and not kernels.fits(nz, Q.dtype):
        raise NotImplementedError(
            f"nz = {nz} beyond the kernels' shared-memory fit for {Q.dtype} "
            "(hybrid path) — ROADMAP.md §1 item 13")
    return _spd_inv(Q), None


def apply_invQ(factors: KKTFactors, v):
    """Q^-1 v for batched vectors."""
    return bmv(factors.invQ, v)


def _bmm_t(XT, Y):
    """X @ Y from the transpose XT that the caller already holds."""
    if XT.shape[0] == Y.shape[0]:
        return torch.einsum("bnm,bnk->bmk", XT, Y)
    return bmm(XT.transpose(-1, -2), Y)               # mixed batch


def pre_factor_kkt(Q, G, A=None, *, inverse: bool = True) -> KKTFactors:
    """One-time factorizations.

    Q: (bQ, nz, nz) SPD; G: (bG, nineq, nz); A: (bA, neq, nz) or None.
    ``inverse=True`` builds explicit Q^-1 / S11^-1 and the cached products
    of the fast per-iteration algebra; ``inverse=False`` keeps Cholesky
    factors (the reference-parity mode)."""
    GT = G.transpose(-1, -2)
    facQ = None
    if inverse:
        invQ, facQ = _q_rep(Q)
        L_Q = None
        invQ_GT = bmm(invQ, GT)                       # (b, nz, nineq)
    else:
        invQ = None
        L_Q = cholesky(Q)
        invQ_GT = cho_solve(L_Q, GT)
    G_invQ_GT = _bmm_t(GT, invQ_GT)                   # (b, nineq, nineq)
    if A is None:
        return KKTFactors(L_Q=L_Q, R=G_invQ_GT, L_S11=None, S21=None,
                          W=None, invQ=invQ, facQ=facQ,
                          invQ_GT=invQ_GT if inverse else None,
                          GiGT=G_invQ_GT if inverse else None)

    AT = A.transpose(-1, -2)
    invQ_AT = bmm(invQ, AT) if inverse else cho_solve(L_Q, AT)
    S11 = _bmm_t(AT, invQ_AT)                         # (b, neq, neq) SPD
    S21 = _bmm_t(GT, invQ_AT)                         # (b, nineq, neq)
    S21T = S21.transpose(-1, -2)
    if inverse:
        invS11 = _spd_inv(S11)
        W = bmm(invS11, S21T)
        L_S11 = None
    else:
        invS11 = None
        L_S11 = cholesky(S11)
        W = cho_solve(L_S11, S21T)                    # (b, neq, nineq)
    R = G_invQ_GT - bmm(S21, W)
    return KKTFactors(L_Q=L_Q, R=R, L_S11=L_S11, S21=S21, W=W, invQ=invQ,
                      facQ=facQ, invS11=invS11,
                      invQ_GT=invQ_GT if inverse else None,
                      invQ_AT=invQ_AT if inverse else None,
                      GiGT=G_invQ_GT if inverse else None,
                      S11=S11 if inverse else None)


class KKTBackend(NamedTuple):
    """The per-iteration factor/solve operations on T (counterpart of the
    JAX package's ``KKTBackend``, with the lanes layout gone: ``prepare``
    and ``prepare_vec`` are the identity on batch-major tensors, and the
    fused steps take the cached factors as they are)."""

    #: One-time layout preparation of the cached factors.
    prepare: object
    #: (R, d) -> Linv of R + diag(1/d).
    factor: object
    #: (Linv, v) -> x solving (R + diag(1/d)) x = v on a factor made before.
    solve2: object
    #: (R, d, v) -> (Linv, x) solving (R + diag(1/d)) x = v.
    factor_solve: object
    #: (R, d, q, z) -> (Linv, x) solving (R + diag(1/d)) x = q - R z.
    factor_solve_rz: object
    #: v -> loop-invariant vector in the backend's layout.
    prepare_vec: object
    #: (R, iGT, x, s, z, q, ip, n_correctors) -> (x', s', z', alpha): one
    #: fused iteration with the direct x update (neq == 0).
    fused_step: object
    #: (factors, x, s, z, y, q, ip, rb, n_correctors) ->
    #: (x', s', z', y', alpha): one fused iteration with equality
    #: constraints.
    fused_step_eq: object
    #: (R, s, z, q, n_correctors) -> (zeta, s', z', alpha): one fused
    #: x-free iteration (neq == 0).
    fused_step_xfree: object


def kernels_backend() -> KKTBackend:
    """The port's only backend: its CUDA kernels (plain versions on CPU)."""

    def factor(R, d):
        return kernels.factor_inv(R, 1.0 / d)

    def solve2(Linv, v):
        return kernels.inv_solve(Linv, v.contiguous())

    def factor_solve(R, d, v):
        return kernels.factor_inv(R, 1.0 / d, v.contiguous())

    def factor_solve_rz(R, d, q, z):
        # The R z form, not the JAX XLA backend's w = x + z substitution,
        # which cancels in float32 near convergence.
        return kernels.factor_inv(R, 1.0 / d, q.contiguous(),
                                  z.contiguous())

    def fused_step(R, iGT, x, s, z, q, ip, n_correctors):
        return kernels.ipm_step(R, iGT, x.contiguous(), s.contiguous(),
                                z.contiguous(), q, ip, n_correctors)

    def fused_step_eq(f, x, s, z, y, q, ip, rb, n_correctors):
        return kernels.ipm_step_eq(
            f.R, f.invQ_GT, f.S21, f.W, f.invS11, f.S11, f.invQ_AT,
            x.contiguous(), s.contiguous(), z.contiguous(), y.contiguous(),
            q, ip, rb, n_correctors)

    def fused_step_xfree(R, s, z, q, n_correctors):
        return kernels.ipm_step_xfree(R, s.contiguous(), z.contiguous(), q,
                                      n_correctors)

    def prepare(f: KKTFactors) -> KKTFactors:
        """The kernels read each matrix in place: make them contiguous
        once per solve (a no-op for factors this module built)."""
        return f._replace(**{
            k: v.contiguous() for k, v in f._asdict().items()
            if isinstance(v, torch.Tensor)})

    return KKTBackend(prepare=prepare, factor=factor, solve2=solve2,
                      factor_solve=factor_solve,
                      factor_solve_rz=factor_solve_rz,
                      prepare_vec=lambda v: v.contiguous(),
                      fused_step=fused_step, fused_step_eq=fused_step_eq,
                      fused_step_xfree=fused_step_xfree)


def resolve_backend(dtype, m: int, device) -> KKTBackend:
    """The backend for a solve with nineq = m. On CUDA, an m beyond the
    kernels' shared-memory fit needs the hybrid blocked path, which is not
    ported."""
    if torch.device(device).type == "cuda" and not kernels.fits(m, dtype):
        raise NotImplementedError(
            f"nineq = {m} beyond the kernels' shared-memory fit for {dtype} "
            "(hybrid path) — ROADMAP.md §1 item 13")
    return kernels_backend()


def fused_step_supported(device, dtype, m: int, nz: int = 0,
                         neq: int = 0) -> bool:
    """Whether the fused iteration fits one thread block (counterpart of
    the JAX package's ``ipm_step_supported``): ``nz`` = 0 for the x-free
    kernel, whose fit does not depend on nz. The plain versions on the CPU
    take any size. Where this is False and kernel A still fits, the solver
    composes the iteration from kernel A and ``inv_solve``."""
    if torch.device(device).type != "cuda":
        return True
    return kernels.fits(m, dtype, nz, neq)


def resolve_prefactor_modes(config, dtype=None) -> dict:
    """kwargs for :func:`pre_factor_kkt`, resolved as the JAX package
    resolves them on a TPU: "auto" is inverse mode below float64 and
    substitution mode at float64."""
    method = config.solve_method
    if method == "auto":
        inverse = torch.empty((), dtype=dtype).element_size() < 8
    else:
        inverse = method == "inverse"
    return dict(inverse=inverse)


def solve_kkt(factors: KKTFactors, fac, d, G, A, rx, rs, rz, ry, solve2):
    """Solve the reduced KKT system given the cached factors and the
    per-iteration factor ``fac`` of T:

        S [dy; dz] = -[ A Q^-1 rx - ry ;  G Q^-1 rx + rs/d - rz ]
        dx = Q^-1 (-rx - G^T dz - A^T dy)
        ds = (-rs - dz) / d

    with the Schur solve in symmetric block form: u = S11^-1 (-r1);
    dz = T^-1 (-r2 - S21 u); dy = u - W dz. Any of rx/rs/rz/ry may be
    ``None``, meaning structurally zero: its products are skipped.
    Returns (dx, ds, dz, dy) with dy None when neq == 0."""
    rhs_T, u = prepare_rhs_kkt(factors, d, G, A, rx, rs, rz, ry)
    dz = solve2(fac, rhs_T)
    return backsub_kkt(factors, dz, u, d, G, A, rx, rs)


def _acc(*terms):
    terms = [t for t in terms if t is not None]
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _q_solvers(factors: KKTFactors):
    """(v -> Q^-1 v, v -> S11^-1 v) under either representation."""
    if factors.invQ is not None:
        return (lambda v: apply_invQ(factors, v),
                lambda v: bmv(factors.invS11, v))
    return (lambda v: cho_solve_vec(factors.L_Q, v),
            lambda v: cho_solve_vec(factors.L_S11, v))


def prepare_rhs_kkt(factors: KKTFactors, d, G, A, rx, rs, rz, ry):
    """Stage 1 of :func:`solve_kkt`: everything up to the T-solve. Returns
    (rhs_T, u) with dz = T^-1 rhs_T and u the S11 intermediate (None unless
    neq > 0 with a nonzero (rx, ry) block). Split out so the factor and the
    first solve run in one kernel (``backend.factor_solve``)."""
    solveQ, solveS11 = _q_solvers(factors)
    invQ_rx = solveQ(rx) if rx is not None else None
    r2 = _acc(bmv(G, invQ_rx) if invQ_rx is not None else None,
              rs / d if rs is not None else None,
              -rz if rz is not None else None)
    u = None
    rhs_T = -r2
    if A is not None:
        r1 = _acc(bmv(A, invQ_rx) if invQ_rx is not None else None,
                  -ry if ry is not None else None)
        if r1 is not None:
            u = solveS11(-r1)
            rhs_T = -r2 - bmv(factors.S21, u)
    return rhs_T, u


def backsub_kkt(factors: KKTFactors, dz, u, d, G, A, rx, rs):
    """Stage 2 of :func:`solve_kkt`: (dx, ds, dy) from dz."""
    solveQ, _ = _q_solvers(factors)
    if A is None:
        dy = None
        g1 = _acc(-rx if rx is not None else None, -btmv(G, dz))
    else:
        dy = (u if u is not None else 0.0) - bmv(factors.W, dz)
        g1 = _acc(-rx if rx is not None else None, -btmv(G, dz),
                  -btmv(A, dy))
    dx = solveQ(g1)
    ds = (-rs - dz) / d if rs is not None else -dz / d
    return dx, ds, dz, dy
