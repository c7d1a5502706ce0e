"""Batched IPM for block-tridiagonal-Q QPs with separable or general
fixed-pattern sparse G (counterpart of ``qpth_tpu/core/banded.py``): the
banded and general structured tiers behind ``solve_qp_banded`` and
``SpQPFunction``.

With slack elimination, d = z/s, the Newton system collapses onto the
primal block

    H dx + A^T dy = rt,   A dx = -ry,     H = Q + G^T diag(d) G

and when Q is block-tridiagonal (nb stages of size bs) and G^T G lies in
the same band, H is block-tridiagonal too. H-solves are a block-Thomas
sweep: C_0 = H_0, C_i = H_i - E_{i-1} W_{i-1} E_{i-1}^T, W_i = C_i^-1, one
stage after another, each step batched over all B lanes. Every stage
inverse W_i is kernel A (``ops/kkt.py::_spd_inv``: Linv from
``kernels.factor_inv``, then Linv^T Linv by one batched product) on CUDA
at both dtypes, and its plain version on the CPU. The JAX package takes its
Pallas stage only in float32 on a TPU and XLA's Cholesky elsewhere.

Stage tensors are kept stage-major, (nb, B, bs, bs), so that each stage is
a contiguous slice: kernel A reads it without a copy.

Equality rows are handled as in the diagonal tier: M = A H^-1 A^T is
assembled from a multi-right-hand-side sweep and factored by kernel A where
it fits (``diag.use_kernels_m``), its solves in ``inv_solve``.

A general G (:class:`GeneralG`) is applied by gathers and ``index_add``
scatters, and G^T diag(d) G is scattered into the band by ``index_put_``
with accumulation. The JAX package turns these scatters into one-hot GEMMs
on a TPU, where XLA serialises scatters; here they stay scatters.

The loop is the dense tier's (``core/pdipm.py::ipm_loop``, with its
init shift, best-iterate tracking, window, Mehrotra predictor-corrector
with Gondzio corrections and NaN freeze); this tier supplies its residual
score, its step (with the general tier's d cap) and its post-loop Newton
refinement, and follows the reference line by line.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import QPSolution, SolverConfig, resolve_refine_steps
from ..ops import kkt as kkt_ops
from ..ops.linalg import bmv, btmv
from .diag import _bvec, _factor_spd, _m_solve, use_kernels_m
from .pdipm import (Score, _is_f64, _nan_lanes, _norm, damped_update,
                    finish_stats, ipm_loop, pc_direction,
                    resolve_improve_margin, start_point)


def _bt_mul_s(Qd_s, Qe_s, x_s):
    """y = Q x stage-major: Qd_s (nb, B, bs, bs), Qe_s (nb-1, B, bs, bs),
    x_s (nb, B, bs) -> (nb, B, bs)."""
    y = torch.matmul(Qd_s, x_s.unsqueeze(-1)).squeeze(-1)
    if Qe_s.shape[0]:
        y[1:] += torch.matmul(Qe_s, x_s[:-1].unsqueeze(-1)).squeeze(-1)
        y[:-1] += torch.matmul(Qe_s.transpose(-1, -2),
                               x_s[1:].unsqueeze(-1)).squeeze(-1)
    return y


def bt_mul(Qd, Qe, x):
    """y = Q x for block-tridiagonal Q.

    Qd: (B, nb, bs, bs) diagonal blocks; Qe: (B, nb-1, bs, bs) subdiagonal
    blocks (block (i+1, i)); x: (B, nb, bs)."""
    B = max(Qd.shape[0], x.shape[0])
    nb, bs = Qd.shape[1], Qd.shape[-1]
    Qd_s = Qd.expand(B, nb, bs, bs).transpose(0, 1)
    Qe_s = Qe.expand(B, max(nb - 1, 0), bs, bs).transpose(0, 1)
    return _bt_mul_s(Qd_s, Qe_s, x.transpose(0, 1)).transpose(0, 1)


class _BTFactor(NamedTuple):
    """Block-Thomas factorization of H = blocktridiag(Hd, Qe, Qe^T).

    W: (nb, B, bs, bs) stage-wise Schur-complement inverses C_i^-1;
    F: (nb, B, bs, bs) forward-sweep multipliers E_{i-1} W_{i-1} (zero at
    stage 0); Gt: (nb, B, bs, bs) backward-sweep multipliers W_i E_i^T
    (zero at the last stage)."""

    W: torch.Tensor
    F: torch.Tensor
    Gt: torch.Tensor


def _spd_inv_stage(C):
    """W = C^-1 for one stage, (B, bs, bs): kernel A on CUDA, its plain
    version on the CPU (``ops/kkt.py::_spd_inv``)."""
    return kkt_ops._spd_inv(C)


def _bt_factor_s(Hd_s, Qe_s) -> _BTFactor:
    """:func:`bt_factor` on stage-major blocks: Hd_s (nb, B, bs, bs),
    Qe_s (nb-1, B, bs, bs)."""
    nb = Hd_s.shape[0]
    W = [_spd_inv_stage(Hd_s[0])]
    F = [torch.zeros_like(W[0])]
    for i in range(1, nb):
        E = Qe_s[i - 1]
        F_i = torch.bmm(E, W[-1])
        # C_i = Hd_i - F_i E^T in one call.
        W.append(_spd_inv_stage(torch.baddbmm(Hd_s[i], F_i,
                                              E.transpose(-1, -2),
                                              alpha=-1.0)))
        F.append(F_i)
    W = torch.stack(W)
    if nb > 1:
        Gt = torch.matmul(W[:-1], Qe_s.transpose(-1, -2))
        Gt = torch.cat([Gt, torch.zeros_like(W[:1])], 0)
    else:
        Gt = torch.zeros_like(W)
    return _BTFactor(W=W, F=torch.stack(F), Gt=Gt)


def bt_factor(Hd, Qe) -> _BTFactor:
    """Factor the block-tridiagonal SPD H by the Schur-complement
    (block-Thomas) recursion

        C_0 = Hd_0,   C_i = Hd_i - E_{i-1} W_{i-1} E_{i-1}^T,
        W_i = C_i^-1.

    Hd: (B, nb, bs, bs); Qe: (B or 1, nb-1, bs, bs). Every stage inverse
    is :func:`_spd_inv_stage` (kernel A). The stage loop is the only
    sequential part; each step is batched over all B lanes."""
    B, nb, bs = Hd.shape[0], Hd.shape[1], Hd.shape[-1]
    Qe_s = Qe.expand(B, max(nb - 1, 0), bs, bs).transpose(0, 1)
    return _bt_factor_s(Hd.transpose(0, 1), Qe_s)


def _sweep(fac: _BTFactor, R_s):
    """Solve H X = R stage-major for R_s (nb, B, bs, k) -> (nb, B, bs, k):
    forward v_i = r_i - F_i v_{i-1}, u = W v for all stages in one product,
    backward x_i = u_i - Gt_i x_{i+1}."""
    nb = R_s.shape[0]
    v = [R_s[0]]
    for i in range(1, nb):
        v.append(torch.baddbmm(R_s[i], fac.F[i], v[-1], alpha=-1.0))
    u = torch.matmul(fac.W, torch.stack(v))
    x = [u[nb - 1]]
    for i in range(nb - 2, -1, -1):
        x.append(torch.baddbmm(u[i], fac.Gt[i], x[-1], alpha=-1.0))
    return torch.stack(x[::-1])


def bt_solve(fac: _BTFactor, r):
    """Solve H x = r given a :func:`bt_factor`. r: (B, nb, bs) ->
    (B, nb, bs)."""
    return _sweep(fac, r.transpose(0, 1).unsqueeze(-1)).squeeze(
        -1).transpose(0, 1)


def bt_solve_multi(fac: _BTFactor, R):
    """Multi-RHS variant: R (B, nb, bs, k) -> (B, nb, bs, k)."""
    return _sweep(fac, R.transpose(0, 1)).transpose(0, 1)


class GeneralG:
    """Arbitrary fixed-pattern sparse G for the general structured tier.

    Static COO pattern ``(rows, cols)``, ``cols`` in the (possibly
    RCM-permuted) variable order the banded solver runs in, with per-batch
    values given at call time as the solver's ``g`` of shape (B, nnz).
    Construction precomputes the scatter maps that assemble
    ``G^T diag(w) G`` into the block-tridiagonal band: every ordered
    within-row entry pair (k1, k2) lands in a diagonal-block slot
    (blk, r, c), or, when the two columns sit in adjacent blocks, a
    subdiagonal-block slot. Pairs spanning more than one block raise (the
    caller chooses ``bs`` from the bandwidth of Q ∪ G^T G). Hashable and
    comparable on the static pattern."""

    def __init__(self, m, n, bs, nb, rows, cols):
        self.m, self.n = int(m), int(n)
        self.bs, self.nb = int(bs), int(nb)
        self.rows = np.asarray(rows, np.int32).reshape(-1)
        self.cols = np.asarray(cols, np.int32).reshape(-1)
        byrow = {}
        for k, r in enumerate(self.rows):
            byrow.setdefault(int(r), []).append(k)
        hd, qe = [], []
        for ks in byrow.values():
            for k1 in ks:
                c1 = int(self.cols[k1])
                b1 = c1 // self.bs
                for k2 in ks:
                    c2 = int(self.cols[k2])
                    b2 = c2 // self.bs
                    if b1 == b2:
                        hd.append((k1, k2, b1, c1 % self.bs, c2 % self.bs))
                    elif b1 == b2 + 1:
                        qe.append((k1, k2, b2, c1 % self.bs, c2 % self.bs))
                    elif b1 == b2 - 1:
                        pass    # implied transpose of a qe pair
                    else:
                        raise ValueError(
                            "G^T G entry pair spans non-adjacent blocks; "
                            "bs must cover the bandwidth of Q ∪ G^T G")
        self.hd = np.asarray(hd, np.int32).reshape(-1, 5).T
        self.qe = np.asarray(qe, np.int32).reshape(-1, 5).T
        #: Row of each pair (for the diagonal-weight gather d[:, row]).
        self.hd_row = self.rows[self.hd[0]] if self.hd.size else self.hd[0]
        self.qe_row = self.rows[self.qe[0]] if self.qe.size else self.qe[0]
        self._key = (self.m, self.n, self.bs, self.nb,
                     self.rows.tobytes(), self.cols.tobytes())

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, GeneralG) and self._key == other._key


def _gen_ops(gen_g: GeneralG, g, B, n):
    """(gmul, gtmul, h_assemble) for a general sparse G with values g
    (B, nnz). h_assemble(Qd_s, Qe_s, d) returns the stage-major band
    (Hd_s, He_s) of Q + G^T diag(d) G, scattered out of place: Qd_s and
    Qe_s are not written."""
    dev = g.device

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    gr, gc = idx(gen_g.rows), idx(gen_g.cols)
    m = gen_g.m
    lanes = torch.arange(B, device=dev).unsqueeze(-1)

    def gmul(v):
        """G v: (B, n) -> (B, m): gather + row scatter-add."""
        return v.new_zeros((B, m)).index_add(1, gr, g * v[:, gc])

    def gtmul(w):
        """G^T w: (B, m) -> (B, n)."""
        return w.new_zeros((B, n)).index_add(1, gc, g * w[:, gr])

    # (k1, k2, blk, r, c, row) of the diagonal-block and the
    # subdiagonal-block pairs; None where there are none.
    pairs = [tuple(idx(t) for t in table) + (idx(row),)
             if np.asarray(table).size else None
             for table, row in ((gen_g.hd, gen_g.hd_row),
                                (gen_g.qe, gen_g.qe_row))]

    def scatter(blocks_s, tab, d):
        """A copy of blocks_s plus the pair weights g[k1] g[k2] d[row] at
        their (blk, lane, r, c) slots (the indices broadcast to
        (B, pairs); duplicate slots accumulate)."""
        if tab is None:
            return blocks_s
        k1, k2, blk, r, c, row = tab
        w = g[:, k1] * g[:, k2] * d[:, row]
        return blocks_s.clone().index_put_((blk, lanes, r, c), w,
                                           accumulate=True)

    def h_assemble(Qd_s, Qe_s, d):
        return scatter(Qd_s, pairs[0], d), scatter(Qe_s, pairs[1], d)

    return gmul, gtmul, h_assemble


#: Newton-system refinement passes of the general-G condensed solve (see
#: _Band.newton); 2 reaches the dtype floor in float64.
_GEN_IR_PASSES = 2


def _d_cap(dtype):
    """Cap of the slack weighting d = z/s in the general-G condensed
    system (the reference's sweep on a scrambled-band fixture: too low and
    the capped barrier's perturbation dominates, too high and the H-solve
    error amplified by d takes over even with refinement)."""
    return 1e10 if _is_f64(dtype) else 1e7


class _Band:
    """The fixed structure of one banded solve: stage-major blocks of Q,
    the G operators, the equality rows, and the factor and Newton solves
    built on them (shared by :func:`solve_banded` and
    :func:`solve_kkt_banded`)."""

    def __init__(self, Qd, Qe, g, A, B, g_cols, gen_g):
        nb, bs = Qd.shape[1], Qd.shape[-1]
        self.B, self.nb, self.bs, self.n = B, nb, bs, nb * bs
        n = self.n
        dev = g.device
        self.Qd_s = Qd.expand(B, nb, bs, bs).transpose(0, 1).contiguous()
        self.Qe_s = Qe.expand(B, max(nb - 1, 0), bs, bs).transpose(
            0, 1).contiguous()
        self.g = g
        self.A = A
        self.neq = A.shape[-2] if A is not None else 0
        if self.neq:
            # A^T in stage-major blocks: (nb, bA, bs, neq), expanded to B.
            self.AT_s = A.transpose(-1, -2).reshape(
                A.shape[0], nb, bs, self.neq).transpose(0, 1).expand(
                    nb, B, bs, self.neq)
        self.use_kernels_m = use_kernels_m(g.dtype, self.neq)
        self.general = gen_g is not None
        self.h_assemble = None
        if self.general:
            self.m = gen_g.m
            self.gmul, self.gtmul, self.h_assemble = _gen_ops(gen_g, g, B, n)
        elif g_cols is None:
            # Diagonal G: gather and scatter are elementwise products.
            self.m = g.shape[-1]
            if self.m != n:
                raise ValueError(f"diagonal G requires g of length n = {n}, "
                                 f"got {self.m}; pass g_cols for another G")
            self.gmul = self.gtmul = lambda v: g * v
        else:
            self.m = g.shape[-1]
            ci = torch.as_tensor(np.asarray(g_cols, np.int64), device=dev)
            self.gmul = lambda v: g * v[:, ci]
            self.gtmul = lambda w: w.new_zeros((B, n)).index_add(1, ci, g * w)

    def stage_major(self, v):
        """(B, n) -> (nb, B, bs) view."""
        return v.reshape(self.B, self.nb, self.bs).transpose(0, 1)

    def flat(self, v_s):
        """(nb, B, bs) -> (B, n)."""
        return v_s.transpose(0, 1).reshape(self.B, self.n)

    def qmul(self, x):
        """Q x for (B, n) x."""
        return self.flat(_bt_mul_s(self.Qd_s, self.Qe_s, self.stage_major(x)))

    def factor(self, d):
        """Complete and factor H = Q + G^T diag(d) G: (fac, X, Mfac) with
        X = H^-1 A^T as (B, n, neq) and Mfac the factor of
        M = A H^-1 A^T (both None without equality rows)."""
        if self.h_assemble is not None:
            Hd_s, He_s = self.h_assemble(self.Qd_s, self.Qe_s, d)
        else:
            Hd_s = self.Qd_s.clone()
            Hd_s.diagonal(0, -2, -1).add_(
                self.stage_major(self.gtmul(self.g * d)))
            He_s = self.Qe_s
        fac = _bt_factor_s(Hd_s, He_s)
        if not self.neq:
            return fac, None, None
        X = _sweep(fac, self.AT_s).transpose(0, 1).reshape(
            self.B, self.n, self.neq)
        M = torch.matmul(self.A, X)
        return fac, X, _factor_spd(M, self.use_kernels_m)

    def newton_base(self, fac, X, Mfac, rx, rs, rz, ry, d):
        """The condensed Newton solve; a residual block given as None is
        structurally zero. dx reuses X = H^-1 A^T, so the dy
        back-substitution is one product, not another sweep."""
        B, n = self.B, self.n
        rt = torch.zeros((B, n), dtype=d.dtype, device=d.device)
        if rx is not None:
            rt = rt - rx
        if rs is not None:
            rt = rt + self.gtmul(rs)
        if rz is not None:
            rt = rt - self.gtmul(d * rz)
        u = self.flat(_sweep(fac, self.stage_major(rt).unsqueeze(-1))
                      .squeeze(-1))
        if self.neq:
            rhs = bmv(self.A, u)
            if ry is not None:
                rhs = rhs + ry
            dy = _m_solve(Mfac, rhs)
            dx = u - bmv(X, dy)
        else:
            dy = None
            dx = u
        gdx = self.gmul(dx)
        ds = -gdx if rz is None else (-rz - gdx)
        dz = -d * ds if rs is None else (-rs - d * ds)
        return dx, ds, dz, dy

    def newton(self, fac, X, Mfac, rx, rs, rz, ry, d):
        """Newton solve; with a general G, followed by ``_GEN_IR_PASSES``
        refinement passes against the dual equation. Primal condensation
        recovers dz = -rs - d ds and so amplifies the H-solve error by d;
        the primal and complementarity equations hold by construction, so
        the error sits in the dual equation, and each pass on the cached
        factor contracts it by cond(H) eps (the separable tier's H is
        diagonally dominant and needs none)."""
        dx, ds, dz, dy = self.newton_base(fac, X, Mfac, rx, rs, rz, ry, d)
        if not self.general:
            return dx, ds, dz, dy
        for _ in range(_GEN_IR_PASSES):
            e_dual = self.gtmul(dz) + self.qmul(dx)
            if rx is not None:
                e_dual = e_dual + rx
            if self.neq:
                e_dual = e_dual + btmv(self.A, dy)
                e_y = bmv(self.A, dx)
                if ry is not None:
                    e_y = e_y + ry
            else:
                e_y = None
            cx, cs, cz, cy = self.newton_base(fac, X, Mfac, e_dual, None,
                                              None, e_y, d)
            dx, ds, dz = dx + cx, ds + cs, dz + cz
            if self.neq:
                dy = dy + cy
        return dx, ds, dz, dy


def _canon_blocks(Qd, Qe):
    Qd = Qd if Qd.dim() == 4 else Qd.unsqueeze(0)
    Qe = Qe if Qe.dim() == 4 else Qe.unsqueeze(0)
    return Qd, Qe


def solve_banded(Qd, Qe, p, g, h, A, b, config: SolverConfig,
                 init=None, g_cols=None, gen_g=None) -> QPSolution:
    """Batched IPM with block-tridiagonal Q and separable G (each
    inequality row involves exactly one variable), or, with ``gen_g``, an
    arbitrary fixed-pattern sparse G (:class:`GeneralG`; ``g`` is then the
    (B?, nnz) entry values).

    Qd: (B?, nb, bs, bs) symmetric diagonal blocks; Qe: (B?, nb-1, bs, bs)
    subdiagonal blocks ((i+1, i); the (i, i+1) blocks are the implied
    transposes); p: (B?, n) with n = nb*bs. Separable G is given row-wise:
    row r is ``g[r] * x[g_cols[r]] <= h[r]`` with ``g`` (B?, m) and
    ``g_cols`` a static (m,) column map (None: G = diag(g), m = n).
    A: (bA, neq, n) or None; b: (B?, neq). ``init``: a warm start
    (x, s, z, y), s and z clipped at ``config.warm_start_min``. Tensors on
    one device; call under ``ops.linalg.full_precision``."""
    Qd, Qe = _canon_blocks(Qd, Qe)
    p = p if p.dim() == 2 else p.unsqueeze(0)
    B = max(p.shape[0], h.shape[0] if h.dim() == 2 else 1, Qd.shape[0])
    dtype, device = p.dtype, p.device

    g, p, h = (_bvec(v, B) for v in (g, p, h))
    if A is not None:
        A = A if A.dim() == 3 else A.unsqueeze(0)
        b = _bvec(b, B)
    kkt_ops.no_library_path(config.use_pallas)
    sysb = _Band(Qd, Qe, g, A, B, g_cols, gen_g)
    neq, m = sysb.neq, sysb.m

    # ---- Init: d = 1, RHS (p, 0, -h, -b) ----
    def solve_init():
        ones = torch.ones((B, m), dtype=dtype, device=device)
        return sysb.newton(*sysb.factor(ones), p, None, -h,
                           -b if neq > 0 else None, ones)

    x, s, z, y = start_point(config, init, solve_init, B, dtype, device)

    def residuals(x, s, z, y):
        rx = sysb.qmul(x) + p + sysb.gtmul(z)
        if neq > 0:
            rx = rx + btmv(A, y)
            ry = bmv(A, x) - b
            y_resid = _norm(ry)
        else:
            ry = None
            y_resid = torch.zeros((B,), dtype=dtype, device=device)
        rz = sysb.gmul(x) + s - h
        mu = torch.abs((s * z).sum(dim=-1) / m)
        resids = y_resid + _norm(rz) + _norm(rx) + m * mu
        return rx, rz, ry, mu, resids

    def score(it, x, s, z, y):
        rx, rz, ry, mu, resids = residuals(x, s, z, y)
        return Score(resids, mu, res=(rx, rz, ry))

    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def predict(z, y, d, res):
        rx, rz, ry = res
        fac = sysb.factor(d)
        return (fac,) + sysb.newton(*fac, rx, z, rz, ry, d)

    def correct(fac, d, rs):
        return sysb.newton(*fac, None, rs, None, None, d)

    def step(x, s, z, y, mu, res):
        d = z / s
        if gen_g is not None:
            # General G only: the G^T diag(d) G cross terms cancel
            # catastrophically in the stage recursion once d >> 1/eps;
            # capping bounds cond(H) at an O(1/cap) barrier perturbation.
            d = torch.clamp(d, max=_d_cap(dtype))
        dirs = pc_direction(s, z, y, mu, d, res, predict, correct,
                            config.n_correctors, one)
        return damped_update(x, s, z, y, *dirs, one, zero)[:4]

    out = ipm_loop(config, (x, s, z, y), score, step,
                   resolve_improve_margin(config, dtype))
    (best_x, best_s, best_z, best_y), best_resids, mu = (
        out.best, out.best_resids, out.mu)

    # Post-loop linear KKT refinement (the reference's scheme): full Newton
    # steps toward mu = 0 with the complementarity diagonal clamped low,
    # the best iterate kept per lane. As in the reference, "auto" resolves
    # the budget but its batch-wide early exit is not applied here.
    refine_budget, _ = resolve_refine_steps(config, dtype)
    if refine_budget > 0:
        rc = config.refine_clamp
        if rc is None:
            rc = 1e-10 if _is_f64(dtype) else 1e-5
        x, s, z, y = best_x, best_s, best_z, best_y
        _, _, _, bmu, bscore = residuals(x, s, z, y)
        best = [x, s, z, y, bscore, bmu]
        for _ in range(refine_budget):
            rx, rz, ry, _, _ = residuals(x, s, z, y)
            s_hat = torch.clamp(s, min=rc)
            d_r = torch.clamp(z, min=rc) / s_hat
            rs_eff = z * (s / s_hat)
            fac_r = sysb.factor(d_r)
            dx, ds, dz, dy = sysb.newton(*fac_r, rx, rs_eff, rz, ry, d_r)
            msk = _nan_lanes(dx, ds, dz, dy).unsqueeze(-1)
            x = x + torch.where(msk, zero, dx)
            s = s + torch.where(msk, zero, ds)
            z = z + torch.where(msk, zero, dz)
            if neq > 0:
                y = y + torch.where(msk, zero, dy)
            _, _, _, mu_n, score_n = residuals(x, s, z, y)
            take = score_n < best[4]
            t_ = take.unsqueeze(-1)
            best = [torch.where(t_, x, best[0]), torch.where(t_, s, best[1]),
                    torch.where(t_, z, best[2]),
                    torch.where(t_, y, best[3]) if neq > 0 else best[3],
                    torch.minimum(score_n, best[4]),
                    torch.where(take, mu_n, best[5])]
        best_x, best_s, best_z, best_y, best_resids, mu = best

    stats = finish_stats(config, out.iterations, best_resids, mu)
    return QPSolution(z=best_x, nu=best_y, lam=best_z, s=best_s, stats=stats)


def solve_kkt_banded(Qd, Qe, g, A, d, rx, config: SolverConfig,
                     g_cols=None, gen_g=None):
    """One Newton solve of the banded-structure KKT system at a given
    diagonal d with RHS (rx, 0, 0, 0): the backward pass's one extra solve.
    Qd (B?, nb, bs, bs), Qe (B?, nb-1, bs, bs), g (B, m) with the
    separable column map g_cols (None: diagonal), or with ``gen_g`` g the
    (B, nnz) general-pattern values (then followed by the same refinement
    passes as the forward's solves, at the capped d); A (bA, neq, n) or
    None; d (B, m); rx (B, n). Returns (dx, ds, dz, dy)."""
    Qd, Qe = _canon_blocks(Qd, Qe)
    kkt_ops.no_library_path(config.use_pallas)
    sysb = _Band(Qd, Qe, g, A, rx.shape[0], g_cols, gen_g)
    if gen_g is not None:
        d = torch.clamp(d, max=_d_cap(rx.dtype))
    return sysb.newton(*sysb.factor(d), rx, None, None, None, d)
