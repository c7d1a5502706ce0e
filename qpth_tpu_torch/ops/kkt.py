"""KKT linear-algebra layer (counterpart of ``qpth_tpu/ops/kkt.py``).

Per IPM iteration the Newton system is reduced, by slack elimination with
D = diag(z/s), to the Schur complement T = R + diag(1/d) with
R = G Q^-1 G^T (neq = 0). The one-time prefactorization caches Q^-1 and
the products Q^-1 G^T and G Q^-1 G^T (inverse mode); every later step
works on those products.

Ported so far: inverse mode with neq = 0, the branch the float32 defaults
take. Q^-1 comes from kernel A (the factor inverse of Q) and one Gram
product. The per-iteration work runs in the port's two kernels through
:class:`KKTBackend`; the tensors' device picks kernel or plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda import kernels
from .linalg import bmm, bmv


class KKTFactors(NamedTuple):
    """Cached one-time factorization products. Batch dims are minimal (1
    if the parameter is shared). Field names and meanings follow the JAX
    package's ``KKTFactors``; fields of branches not ported yet stay None.
    """

    #: Lower Cholesky of Q (substitution mode; not ported: None).
    L_Q: Optional[torch.Tensor]
    #: Schur complement core G Q^-1 G^T, (b, nineq, nineq).
    R: torch.Tensor
    #: Lower Cholesky of S11 (neq > 0 substitution mode; None).
    L_S11: Optional[torch.Tensor]
    #: S21 = G Q^-1 A^T (neq > 0; None).
    S21: Optional[torch.Tensor]
    #: W = S11^-1 S21^T (neq > 0; None).
    W: Optional[torch.Tensor]
    #: Q^-1, (bQ, nz, nz).
    invQ: Optional[torch.Tensor] = None
    #: S11^-1 (neq > 0; None).
    invS11: Optional[torch.Tensor] = None
    #: Q^-1 G^T, (b, nz, nineq).
    invQ_GT: Optional[torch.Tensor] = None
    #: Q^-1 A^T (neq > 0; None).
    invQ_AT: Optional[torch.Tensor] = None
    #: G Q^-1 G^T, (b, nineq, nineq); equal to R when neq == 0.
    GiGT: Optional[torch.Tensor] = None
    #: S11 = A Q^-1 A^T (neq > 0; None).
    S11: Optional[torch.Tensor] = None
    #: Blocked factor of Q beyond the kernel fit (hybrid path; None).
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


def pre_factor_kkt(Q, G, A=None, *, inverse: bool = True) -> KKTFactors:
    """One-time factorizations for neq = 0 in inverse mode.

    Q: (bQ, nz, nz) SPD; G: (bG, nineq, nz)."""
    if A is not None:
        raise NotImplementedError(
            "equality constraints (neq > 0) — ROADMAP.md §1 item 8")
    if not inverse:
        raise NotImplementedError(
            "solve_method='subst' — ROADMAP.md §1 item 7")
    invQ, facQ = _q_rep(Q)
    GT = G.transpose(-1, -2)
    invQ_GT = bmm(invQ, GT)                           # (b, nz, nineq)
    if G.shape[0] == invQ_GT.shape[0]:
        G_invQ_GT = torch.einsum("bnm,bnk->bmk", GT, invQ_GT)
    else:
        G_invQ_GT = bmm(G, invQ_GT)                   # mixed batch
    return KKTFactors(L_Q=None, R=G_invQ_GT, L_S11=None, S21=None, W=None,
                      invQ=invQ, facQ=facQ, invQ_GT=invQ_GT,
                      GiGT=G_invQ_GT)


class KKTBackend(NamedTuple):
    """The per-iteration factor/solve operations (counterpart of the JAX
    package's ``KKTBackend``, with the lanes layout gone: ``prepare`` and
    ``prepare_vec`` are the identity on batch-major tensors)."""

    #: One-time layout preparation of the cached factors.
    prepare: object
    #: (R, d) -> Linv of R + diag(1/d).
    factor: object
    #: (R, d, v) -> (Linv, x) solving (R + diag(1/d)) x = v.
    factor_solve: object
    #: (R, d, q, z) -> (Linv, x) solving (R + diag(1/d)) x = q - R z.
    factor_solve_rz: object
    #: v -> loop-invariant vector in the backend's layout.
    prepare_vec: object
    #: (R, s, z, q, n_correctors) -> (zeta, s', z', alpha): one fused
    #: x-free iteration (neq == 0).
    fused_step_xfree: object


def kernels_backend() -> KKTBackend:
    """The port's only backend: kernels A and B (plain versions on CPU)."""

    def factor(R, d):
        return kernels.factor_inv(R, 1.0 / d)

    def factor_solve(R, d, v):
        return kernels.factor_inv(R, 1.0 / d, v.contiguous())

    def factor_solve_rz(R, d, q, z):
        # The R z form, not the JAX XLA backend's w = x + z substitution,
        # which cancels in float32 near convergence.
        return kernels.factor_inv(R, 1.0 / d, q.contiguous(),
                                  z.contiguous())

    def fused_step_xfree(R, s, z, q, n_correctors):
        return kernels.ipm_step_xfree(R, s.contiguous(), z.contiguous(), q,
                                      n_correctors)

    return KKTBackend(prepare=lambda f: f, factor=factor,
                      factor_solve=factor_solve,
                      factor_solve_rz=factor_solve_rz,
                      prepare_vec=lambda v: v.contiguous(),
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


def resolve_prefactor_modes(config, dtype=None) -> dict:
    """kwargs for :func:`pre_factor_kkt`, resolved as the JAX package
    resolves them on a TPU: "auto" is inverse mode below float64 and
    substitution mode at float64."""
    method = config.solve_method
    if method == "auto":
        inverse = torch.empty((), dtype=dtype).element_size() < 8
    else:
        inverse = method == "inverse"
    if not inverse:
        raise NotImplementedError(
            "solve_method='subst' (including the float64 default) — "
            "ROADMAP.md §1 item 7")
    return dict(inverse=inverse)
