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
``SolverConfig.use_pallas`` picks one of three backends:

* :func:`kernels_backend` (``"auto"``, ``True``, ``"lanes"``): T's factor
  is Linv = inv(chol(T)) from kernel A, also in substitution mode, where
  the JAX package's XLA backend keeps chol(T) and substitutes; every
  further solve on it is ``inv_solve``; the fused steps run where they fit.
  In substitution mode Q and S11 are factored by ``torch.linalg`` and
  solved by ``torch.cholesky_solve``.
* :func:`blocked_backend` (``"blocked"``, the JAX package's
  ``pallas_blocked_backend``): T's factor is Lt = chol(T)^T from kernel C
  and every solve on it is kernel D; no fused steps. In substitution mode
  kernel C also factors Q and S11 and kernel D runs every Q and S11 solve.
* :func:`hybrid_backend` (``"hybrid"`` and ``"hybrid_xla"``, and
  ``"auto"`` / ``True``
  / ``"lanes"`` on CUDA with nineq past kernel A's fit, as the JAX package
  goes past its VMEM wall): T's factor is the blocked ``HybridFactor``,
  kernel A on the diagonal blocks and batched GEMMs for the rest; no fused
  steps.

Past kernel A's fit on CUDA the inverse-mode prefactor keeps Q as the
blocked factor ``facQ`` instead of Q^-1 (``_q_rep``) and builds the cached
products by blocked substitution; S11^-1 past the fit is the blocked
explicit inverse (``_spd_inv``).

Layouts of the factor objects: a backend's per-iteration factor of T is
Linv (lower, row i of inv(L) in row i) under the kernels backend, Lt
(upper) under the blocked one and a ``HybridFactor`` under the hybrid one.
``KKTFactors.L_Q`` and ``L_S11`` are the lower factors L under every
backend and in every caller (the backward, ``solve_qp_eq``): kernel D reads
them as they are (``lower=True``), so no transposed copy is made.

Inverse mode forms Q^-1 and S11^-1 by kernel A and one Gram product under
both backends, as the JAX package does with its lanes kernel.

``KKTSolver.FULL`` and ``KKTSolver.IR`` (:func:`factor_solve_kkt`,
:func:`solve_kkt_ir`) build the whole saddle system every solve and factor
it by partial-pivot LU (``torch.linalg.lu_factor_ex``); the JAX package
computes these with XLA outside any Pallas kernel, so they have no kernel
here either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cholesky as chol_ops
from . import hybrid
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
    #: Blocked factor of Q (``ops.hybrid.HybridFactor``) in place of invQ
    #: where nz is past kernel A's fit on CUDA (inverse mode); else None.
    facQ: Optional[object] = None
    #: Coordinates of the cached products (scaling.Scaling): identity
    #: values when the equilibration probe kept the factors unscaled.
    scaling: Optional[object] = None
    #: The Ruiz scalings themselves (drive the solver's vector-space
    #: behaviors: init shift, clamps, scoring).
    sem_scaling: Optional[object] = None


def past_fit(n: int, dtype, device) -> bool:
    """Whether an n x n matrix is past kernel A's one-tile fit on a CUDA
    device (``kernels.fits``), where the hybrid blocked path takes over:
    the plain versions on the CPU take any size."""
    return torch.device(device).type == "cuda" and not kernels.fits(n, dtype)


def _spd_inv(M):
    """Batched SPD inverse: kernel A gives Linv = inv(chol(M)), then
    M^-1 = Linv^T Linv by one batched product; past kernel A's fit on CUDA,
    the blocked inverse (``hybrid.spd_inv_hybrid``)."""
    B, n = M.shape[0], M.shape[-1]
    if past_fit(n, M.dtype, M.device):
        return hybrid.spd_inv_hybrid(M)
    zero_d = torch.zeros((B, n), dtype=M.dtype, device=M.device)
    Linv = kernels.factor_inv(M.contiguous(), zero_d)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


def _q_rep(Q):
    """Inverse-mode representation of Q^-1: (invQ, facQ), exactly one set.
    Within kernel A's fit, the explicit inverse; past it on CUDA, Q's
    blocked factor (the JAX package's hybrid regime), whose products are
    blocked substitutions."""
    if past_fit(Q.shape[-1], Q.dtype, Q.device):
        return None, hybrid.factor_hybrid(Q)
    return _spd_inv(Q), None


def apply_invQ(factors: KKTFactors, v):
    """Q^-1 v for batched vectors under either inverse-mode
    representation."""
    if factors.invQ is not None:
        return bmv(factors.invQ, v)
    return hybrid.solve_hybrid(factors.facQ, v)


def _bmm_t(XT, Y):
    """X @ Y from the transpose XT that the caller already holds."""
    if XT.shape[0] == Y.shape[0]:
        return torch.einsum("bnm,bnk->bmk", XT, Y)
    return bmm(XT.transpose(-1, -2), Y)               # mixed batch


def _chol_kernel(M):
    """Lower Cholesky factor of batched SPD M by kernel C (the blocked
    backend's factor of Q and S11 in substitution mode)."""
    n = M.shape[-1]
    if M.device.type == "cuda" and not kernels.chol_fits(n, M.dtype):
        raise NotImplementedError(
            f"n = {n} beyond the Cholesky kernel's shared-memory fit for "
            f"{M.dtype} under use_pallas='blocked'; use_pallas='auto' or "
            "'hybrid' solves past it")
    return chol_ops.cholesky(M).contiguous()


def pre_factor_kkt(Q, G, A=None, *, inverse: bool = True,
                   blocked: bool = False) -> KKTFactors:
    """One-time factorizations.

    Q: (bQ, nz, nz) SPD; G: (bG, nineq, nz); A: (bA, neq, nz) or None.
    ``inverse=True`` builds explicit Q^-1 / S11^-1 and the cached products
    of the fast per-iteration algebra; ``inverse=False`` keeps Cholesky
    factors (the reference-parity mode), from kernel C with ``blocked``
    (the blocked backend), else from ``torch.linalg``."""
    GT = G.transpose(-1, -2)
    facQ = None
    factor = _chol_kernel if blocked else cholesky
    if inverse:
        invQ, facQ = _q_rep(Q)
        L_Q = None
        invQ_GT = (hybrid.solve_hybrid_mat(facQ, GT) if facQ is not None
                   else bmm(invQ, GT))                # (b, nz, nineq)
    else:
        invQ = None
        L_Q = factor(Q)
        invQ_GT = cho_solve(L_Q, GT)
    G_invQ_GT = _bmm_t(GT, invQ_GT)                   # (b, nineq, nineq)
    if A is None:
        return KKTFactors(L_Q=L_Q, R=G_invQ_GT, L_S11=None, S21=None,
                          W=None, invQ=invQ, facQ=facQ,
                          invQ_GT=invQ_GT if inverse else None,
                          GiGT=G_invQ_GT if inverse else None)

    AT = A.transpose(-1, -2)
    if not inverse:
        invQ_AT = cho_solve(L_Q, AT)
    elif facQ is not None:
        invQ_AT = hybrid.solve_hybrid_mat(facQ, AT)
    else:
        invQ_AT = bmm(invQ, AT)
    S11 = _bmm_t(AT, invQ_AT)                         # (b, neq, neq) SPD
    S21 = _bmm_t(GT, invQ_AT)                         # (b, nineq, neq)
    S21T = S21.transpose(-1, -2)
    if inverse:
        invS11 = _spd_inv(S11)
        W = bmm(invS11, S21T)
        L_S11 = None
    else:
        invS11 = None
        L_S11 = factor(S11)
        W = cho_solve(L_S11, S21T)                    # (b, neq, nineq)
    R = G_invQ_GT - bmm(S21, W)
    return KKTFactors(L_Q=L_Q, R=R, L_S11=L_S11, S21=S21, W=W, invQ=invQ,
                      facQ=facQ, invS11=invS11,
                      invQ_GT=invQ_GT if inverse else None,
                      invQ_AT=invQ_AT if inverse else None,
                      GiGT=G_invQ_GT if inverse else None,
                      S11=S11 if inverse else None)


class KKTBackend(NamedTuple):
    """The per-iteration factor and solves of T = R + diag(1/d)
    (counterpart of the JAX package's ``KKTBackend``, with the lanes layout
    gone: the kernels read the batch-major factors as they are, after one
    :func:`prepare_factors`). ``fac`` is the backend's factor of T: Linv
    (kernels backend), Lt (blocked), a ``HybridFactor`` (hybrid) or a
    ``TPFactor`` (``parallel/intra.py``)."""

    #: (fac, v) -> x solving (R + diag(1/d)) x = v on a factor made before.
    solve2: object
    #: (R, d, v) -> (fac, x) solving (R + diag(1/d)) x = v.
    factor_solve: object
    #: (R, d, q, z) -> (fac, x) solving (R + diag(1/d)) x = q - R z.
    factor_solve_rz: object
    #: (L, v) -> x solving (L L^T) x = v on the lower Cholesky factor of Q
    #: or S11 (substitution mode); None: ``torch.cholesky_solve``. The
    #: JAX package passes one ``solve2`` for T, Q and S11 alike; here T's
    #: factor under the kernels backend is no Cholesky factor.
    q_solve2: object = None
    #: Whether the fused iterations (``kernels.ipm_step_xfree``,
    #: ``ipm_step``, ``ipm_step_eq``) stand in for the composed step where
    #: they fit: the kernels backend's.
    fused: bool = False


def prepare_factors(f: KKTFactors) -> KKTFactors:
    """The kernels read each matrix in place: make them contiguous once per
    solve (a no-op for factors this module built)."""
    return f._replace(**{k: v.contiguous() for k, v in f._asdict().items()
                         if isinstance(v, torch.Tensor)})


def kernels_backend() -> KKTBackend:
    """Kernel A's factor-inverse and ``inv_solve``, and the fused steps
    (plain versions on CPU)."""

    def solve2(Linv, v):
        return kernels.inv_solve(Linv, v.contiguous())

    def factor_solve(R, d, v):
        return kernels.factor_inv(R, 1.0 / d, v.contiguous())

    def factor_solve_rz(R, d, q, z):
        # The R z form, not the JAX XLA backend's w = x + z substitution,
        # which cancels in float32 near convergence.
        return kernels.factor_inv(R, 1.0 / d, q.contiguous(),
                                  z.contiguous())

    return KKTBackend(solve2=solve2, factor_solve=factor_solve,
                      factor_solve_rz=factor_solve_rz, fused=True)


def rz_by_substitution(factor_solve):
    """``factor_solve_rz`` from ``factor_solve`` by the JAX package's
    substitution w = x + z: (R + D^-1) w = q + z/d, so no R z product; its
    float32 error is measured in PERF.md."""

    def factor_solve_rz(R, d, q, z):
        fac, w = factor_solve(R, d, q + z / d)
        return fac, w - z

    return factor_solve_rz


def blocked_backend() -> KKTBackend:
    """The Cholesky-factor backend (the JAX package's
    ``pallas_blocked_backend``): T's factor is Lt = chol(T)^T from kernel C,
    and kernel D runs every solve on it and, in substitution mode, on the
    lower factors of Q and S11. No fused steps: the solver composes each
    iteration from one kernel C with its first solve and kernel D."""

    def factor_solve(R, d, v):
        return chol_ops.factor_solve_kkt(R, 1.0 / d, v)

    return KKTBackend(
        solve2=chol_ops.cho_solve_vec_t, factor_solve=factor_solve,
        factor_solve_rz=rz_by_substitution(factor_solve),
        q_solve2=lambda L, v: kernels.cho_solve(L, v.contiguous(),
                                                lower=True))


def hybrid_backend() -> KKTBackend:
    """The backend over the blocked factor (``ops/hybrid.py``) at its
    default block: ``use_pallas="hybrid"``, and "auto" past kernel A's fit
    on CUDA. No fused steps: the solver composes each iteration."""

    def factor_solve(R, d, v):
        return hybrid.factor_solve_hybrid(R, v, dinv=1.0 / d)

    return KKTBackend(solve2=hybrid.solve_hybrid, factor_solve=factor_solve,
                      factor_solve_rz=rz_by_substitution(factor_solve))


def no_library_path(use_pallas) -> None:
    """Raise for the JAX package's library-only values of ``use_pallas``."""
    if use_pallas is False or use_pallas == "xla":
        raise NotImplementedError(
            f"use_pallas={use_pallas!r}: the port has no library-only path; "
            "the tensors' device picks the kernel or its plain version. "
            "use_pallas='blocked' runs the Cholesky-and-substitution algebra "
            "of the JAX package's XLA backend through kernels C and D")


def backend_kind(use_pallas) -> str:
    """"kernels", "blocked" or "hybrid" for a ``SolverConfig.use_pallas``
    value; raises ``NotImplementedError`` for the values without a port.
    ``"hybrid_xla"`` is the hybrid backend: the JAX package's value is its
    hybrid path with no ``pallas_call`` (so GSPMD can partition it), and
    the port has no library-only path; ``parallel.intra.solve_qp_tp``
    distributes its factor and solves of T over a process group."""
    no_library_path(use_pallas)
    if use_pallas in ("hybrid", "hybrid_xla"):
        return "hybrid"
    if use_pallas == "blocked":
        return use_pallas
    return "kernels"


def resolve_backend(use_pallas, dtype, m: int, device) -> KKTBackend:
    """The backend for a solve with nineq = m. ``"hybrid"`` and
    ``"hybrid_xla"`` are the blocked backend at every m on both devices. On CUDA, an m past kernel A's
    shared-memory fit (``fits``: float32 m <= 237, float64 m <= 166) takes
    it too, as the JAX package's lanes backend does past its VMEM wall;
    ``"blocked"`` past kernel C's fit (``chol_fits``: 239, 168) raises, as
    the JAX package's blocked Pallas backend has no path there either."""
    kind = backend_kind(use_pallas)
    if kind == "hybrid":
        return hybrid_backend()
    if kind == "blocked":
        if (torch.device(device).type == "cuda"
                and not kernels.chol_fits(m, dtype)):
            raise NotImplementedError(
                f"nineq = {m} beyond kernel C's shared-memory fit for "
                f"{dtype} under use_pallas='blocked'; use_pallas='auto' or "
                "'hybrid' solves past it")
        return blocked_backend()
    if past_fit(m, dtype, device):
        return hybrid_backend()
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
    substitution mode at float64. As there, the kernels backend's explicit
    values (True, "lanes") refuse substitution mode below float64, where
    the JAX package would run its lanes kernels."""
    blocked = backend_kind(config.use_pallas) == "blocked"
    below_f64 = torch.empty((), dtype=dtype).element_size() < 8
    method = config.solve_method
    if method == "auto":
        inverse = below_f64
    else:
        inverse = method == "inverse"
    if (below_f64 and not inverse and (config.use_pallas is True
                                       or config.use_pallas == "lanes")):
        raise ValueError(
            "the lanes Pallas backend applies Q/S11 via explicit inverses; "
            "solve_method='subst' requires use_pallas in (False, 'xla', "
            "'blocked')")
    return dict(inverse=inverse, blocked=blocked)


def solve_kkt(factors: KKTFactors, fac, d, G, A, rx, rs, rz, ry, solve2,
              q_solve2=None):
    """Solve the reduced KKT system given the cached factors and the
    per-iteration factor ``fac`` of T:

        S [dy; dz] = -[ A Q^-1 rx - ry ;  G Q^-1 rx + rs/d - rz ]
        dx = Q^-1 (-rx - G^T dz - A^T dy)
        ds = (-rs - dz) / d

    with the Schur solve in symmetric block form: u = S11^-1 (-r1);
    dz = T^-1 (-r2 - S21 u); dy = u - W dz. Any of rx/rs/rz/ry may be
    ``None``, meaning structurally zero: its products are skipped.
    ``solve2`` solves on ``fac``, ``q_solve2`` on the factors of Q and S11
    (the backend's fields of those names). Returns (dx, ds, dz, dy) with dy
    None when neq == 0."""
    rhs_T, u = prepare_rhs_kkt(factors, d, G, A, rx, rs, rz, ry, q_solve2)
    dz = solve2(fac, rhs_T)
    return backsub_kkt(factors, dz, u, d, G, A, rx, rs, q_solve2)


def _acc(*terms):
    terms = [t for t in terms if t is not None]
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _q_solvers(factors: KKTFactors, solve2=None):
    """(v -> Q^-1 v, v -> S11^-1 v) under either representation; in
    substitution mode ``solve2`` (a backend's ``q_solve2``) applies the
    lower factors, None meaning ``torch.cholesky_solve``."""
    if factors.invQ is not None or factors.facQ is not None:
        return (lambda v: apply_invQ(factors, v),
                lambda v: bmv(factors.invS11, v))
    solve = solve2 or cho_solve_vec
    return (lambda v: solve(factors.L_Q, v),
            lambda v: solve(factors.L_S11, v))


def prepare_rhs_kkt(factors: KKTFactors, d, G, A, rx, rs, rz, ry,
                    solve2=None):
    """Stage 1 of :func:`solve_kkt`: everything up to the T-solve. Returns
    (rhs_T, u) with dz = T^-1 rhs_T and u the S11 intermediate (None unless
    neq > 0 with a nonzero (rx, ry) block). Split out so the factor and the
    first solve run in one kernel (``backend.factor_solve``). ``solve2``
    as in :func:`_q_solvers`."""
    solveQ, solveS11 = _q_solvers(factors, solve2)
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


def backsub_kkt(factors: KKTFactors, dz, u, d, G, A, rx, rs, solve2=None):
    """Stage 2 of :func:`solve_kkt`: (dx, ds, dy) from dz; ``solve2`` as in
    :func:`_q_solvers`."""
    solveQ, _ = _q_solvers(factors, solve2)
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


def _lu_solver(M):
    """v -> M^-1 v from one partial-pivot LU factorization of the general
    matrix M (bM, n, n): the JAX package's ``lu_solve_general``, which XLA
    computes outside any Pallas kernel there too. The right-hand sides,
    (b, n, k) or (b, n), have b = 1 or bM (the saddle systems carry d's
    batch). A singular lane gives inf/NaN, as there."""
    LU, piv, _ = torch.linalg.lu_factor_ex(M)

    def solve(rhs):
        vec = rhs.dim() == M.dim() - 1
        if vec:
            rhs = rhs.unsqueeze(-1)
        if rhs.shape[0] == 1 and LU.shape[0] > 1:
            rhs = rhs.expand(LU.shape[0], *rhs.shape[1:])
        out = torch.linalg.lu_solve(LU, piv, rhs)
        return out.squeeze(-1) if vec else out

    return solve


def factor_solve_kkt(Q, D, G, A, rx, rs, rz, ry):
    """``KKTSolver.FULL``: build the full saddle system fresh and do a
    textbook Schur solve (upstream qpth's LU_FULL path). D: (B, nineq,
    nineq), the diagonal case is diag_embed(d). Returns (dx, ds, dz, dy)
    with dy None when neq == 0."""
    return _factor_solve_saddle(Q, D, G, A, rx, rs, rz, ry, reg_eps=0.0)


def _factor_solve_saddle(Q, D, G, A, rx, rs, rz, ry, reg_eps: float):
    """Shared core of :func:`factor_solve_kkt` (``reg_eps`` = 0) and the
    regularized solve of :func:`solve_kkt_ir` (S shifted by -eps I; the
    caller passes Q and D with +eps already on their diagonals)."""
    nineq, nz = G.shape[-2], G.shape[-1]
    neq = A.shape[-2] if A is not None else 0
    B = max(x.shape[0] for x in (Q, D, G, rx, rs, rz) if x is not None)
    dtype, device = Q.dtype, Q.device

    # H = blockdiag(Q, D); Abar = [[G, I], [A, 0]].
    H = torch.zeros((max(Q.shape[0], D.shape[0]), nz + nineq, nz + nineq),
                    dtype=dtype, device=device)
    H[:, :nz, :nz] = Q
    H[:, nz:, nz:] = D
    eye_m = torch.eye(nineq, dtype=dtype, device=device)
    bA = max(G.shape[0], A.shape[0]) if neq > 0 else G.shape[0]
    Abar = torch.zeros((bA, nineq + neq, nz + nineq), dtype=dtype,
                       device=device)
    Abar[:, :nineq, :nz] = G
    Abar[:, :nineq, nz:] = eye_m
    if neq > 0:
        Abar[:, nineq:, :nz] = A
        hvec = torch.cat([rz.expand(B, nineq), ry.expand(B, neq)], dim=1)
    else:
        hvec = rz
    g = torch.cat([rx.expand(B, nz), rs.expand(B, nineq)], dim=1)

    solveH = _lu_solver(H)
    invH_AT = solveH(Abar.transpose(-1, -2))          # (b, nz+m, m+p)
    invH_g = solveH(g)                                # (B, nz+m)
    S = bmm(Abar, invH_AT)
    if reg_eps:
        S = S - reg_eps * torch.eye(S.shape[-1], dtype=dtype, device=device)
    t = bmv(Abar, invH_g) - hvec
    w = _lu_solver(S)(-t)                             # (B, m+p) = [dz; dy]
    v = solveH(-g - btmv(Abar, w))
    dx, ds = v[:, :nz], v[:, nz:]
    dz = w[:, :nineq]
    dy = w[:, nineq:] if neq > 0 else None
    return dx, ds, dz, dy


def kkt_resid_reg(Q, D, G, A, eps, dx, ds, dz, dy, rx, rs, rz, ry):
    """Residual of the eps-regularized KKT system (upstream qpth's
    ``kkt_resid_reg``)."""
    resx = bmv(Q, dx) + btmv(G, dz) + rx
    if dy is not None:
        resx = resx + btmv(A, dy)
    ress = bmv(D, ds) + dz + rs
    resz = bmv(G, dx) + ds - eps * dz + rz
    resy = bmv(A, dx) - eps * dy + ry if dy is not None else None
    return resx, ress, resz, resy


def solve_kkt_ir(Q, D, G, A, rx, rs, rz, ry, eps: float = 1e-7,
                 niter: int = 1):
    """``KKTSolver.IR``: regularized saddle solve plus ``niter`` steps of
    iterative refinement on the unregularized system (upstream qpth's
    IR_UNOPT path)."""
    Q_t = Q + eps * torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    D_t = D + eps * torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    dx, ds, dz, dy = _factor_solve_saddle(Q_t, D_t, G, A, rx, rs, rz, ry,
                                          reg_eps=eps)
    for _ in range(niter):
        resx, ress, resz, resy = kkt_resid_reg(
            Q, D, G, A, eps, dx, ds, dz, dy, rx, rs, rz, ry)
        ddx, dds, ddz, ddy = _factor_solve_saddle(
            Q_t, D_t, G, A, -resx, -ress, -resz,
            -resy if resy is not None else None, reg_eps=eps)
        dx, ds, dz = dx + ddx, ds + dds, dz + ddz
        dy = dy + ddy if dy is not None else None
    return dx, ds, dz, dy
