#!/usr/bin/env python3
"""Write ``tests/data_torch_loop_golden.npz``: the port's outputs, bit for
bit, on one small problem per path of the IPM loop (the dense tier's fused
and composed steps under each backend and KKT solver, refinement, warm
starts, Gondzio corrections, a fail-soft lane; the diagonal, banded and
general tiers; two gradients). ``tests/test_torch_loop_golden.py`` holds
the loop to them with ``torch.equal``, so that a change of the loop's
structure that keeps its arithmetic keeps every bit. From the repository
root, on the CPU:

    PYTHONPATH=. python tests/make_torch_loop_golden.py

Every case runs on one thread. Each array is stored under
``<case>/<name>``: ``z``, ``lam``, ``s``, ``nu``, ``iterations``,
``best_resids``, ``mu``, ``converged`` of a full solve, ``grad_<i>`` of a
gradient case (the i-th input's gradient). Regenerate only where a change
is meant to alter the arithmetic, and say so where the change is recorded.
"""

import os

import numpy as np
import torch

import qpth_tpu_torch as qt

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data_torch_loop_golden.npz")
B, NZ, NINEQ, NEQ = 6, 10, 12, 3

KS = qt.KKTSolver


def _dense(seed, dtype, neq=0, shared=False):
    """A strictly feasible dense QP: Q = L L^T + I, h = G z0 + s0,
    b = A z0; ``shared`` gives Q and G without a batch dimension."""
    rng = np.random.RandomState(seed)
    bq = () if shared else (B,)
    L = rng.randn(*bq, NZ, NZ) / np.sqrt(NZ)
    Q = L @ np.swapaxes(L, -1, -2) + np.eye(NZ)
    G = rng.randn(*bq, NINEQ, NZ)
    z0 = rng.randn(B, NZ)
    s0 = rng.rand(B, NINEQ) + 0.1
    h = (G @ z0[..., None])[..., 0] + s0
    p = rng.randn(B, NZ)
    out = [Q, p, G, h]
    if neq:
        A = rng.randn(B, neq, NZ)
        out += [A, np.einsum("bmn,bn->bm", A, z0)]
    return [torch.tensor(v, dtype=dtype) for v in out]


def _cfg(**kw):
    return qt.SolverConfig(**{"verbose": -1, **kw})


def _dense_case(seed, dtype, neq=0, shared=False, warm=False, nan_lane=None,
                **kw):
    def run():
        args = _dense(seed, dtype, neq, shared)
        if nan_lane is not None:
            args[0] = args[0].clone()
            args[0][nan_lane] = -torch.eye(NZ, dtype=dtype)
        cfg = _cfg(**kw)
        init = None
        if warm:
            ws = qt.solve_qp_full(*args, config=_cfg(max_iter=3),
                                  device="cpu")
            init = (ws.z, ws.s, ws.lam, ws.nu if neq else None)
        return qt.solve_qp_full(*args, config=cfg, init=init, device="cpu")
    return run


def _diag(seed, dtype, neq=0):
    rng = np.random.RandomState(seed)
    q = rng.rand(B, NZ) + 0.5
    g = rng.randn(B, NZ)
    g = np.where(np.abs(g) < 0.3, 0.5, g)
    z0 = rng.randn(B, NZ)
    h = g * z0 + rng.rand(B, NZ) + 0.2
    p = rng.randn(B, NZ)
    A = b = None
    if neq:
        A = rng.randn(neq, NZ)
        b = z0 @ A.T
    return [None if v is None else torch.tensor(v, dtype=dtype)
            for v in (q, p, g, h, A, b)]


def _diag_case(seed, dtype, neq=0, **kw):
    def run():
        return qt.solve_qp_diag_full(*_diag(seed, dtype, neq),
                                     config=_cfg(**kw), device="cpu")
    return run


def _band(seed, dtype, nb=3, bs=4, neq=0, general=False):
    """Block-tridiagonal Q (nb blocks of bs) with a diagonal G, or with
    ``general`` a G of two entries a row in adjacent columns."""
    rng = np.random.RandomState(seed)
    n = nb * bs
    Ld = np.tril(rng.randn(B, nb, bs, bs) * 0.5
                 + np.eye(bs) * (1.5 + rng.rand(B, nb, 1, 1)))
    Le = 0.3 * rng.randn(B, nb - 1, bs, bs)
    Qd = np.einsum("bnij,bnkj->bnik", Ld, Ld)
    Qd[:, 1:] += np.einsum("bnij,bnkj->bnik", Le, Le)
    Qe = np.einsum("bnij,bnkj->bnik", Le, Ld[:, :-1])
    z0 = rng.randn(B, n)
    p = rng.randn(B, n)
    spec = None
    if general:
        rows = [r for r in range(n) for _ in range(2 if r < n - 1 else 1)]
        cols = [c for r in range(n) for c in ((r, r + 1) if r < n - 1
                                              else (r,))]
        g = rng.randn(B, len(rows))
        g = np.where(np.abs(g) < 0.3, 0.5, g)
        Gz = np.zeros((B, n))
        np.add.at(Gz, (slice(None), rows), g * z0[:, cols])
        spec = qt.GeneralG(n, n, bs, nb, rows, cols)
    else:
        g = rng.randn(B, n)
        g = np.where(np.abs(g) < 0.3, 0.5, g)
        Gz = g * z0
    h = Gz + rng.rand(B, n) + 0.2
    A = b = None
    if neq:
        A = rng.randn(neq, n)
        b = z0 @ A.T
    return [None if v is None else torch.tensor(v, dtype=dtype)
            for v in (Qd, Qe, p, g, h, A, b)], spec


def _band_case(seed, dtype, neq=0, general=False, **kw):
    def run():
        args, spec = _band(seed, dtype, neq=neq, general=general)
        return qt.solve_qp_banded_full(*args, config=_cfg(**kw),
                                       g_spec=spec, device="cpu")
    return run


def _grad_case(seed, dtype, neq=0, **kw):
    def run():
        args = [v.requires_grad_() for v in _dense(seed, dtype, neq)]
        z = qt.solve_qp(*args, config=_cfg(**kw), device="cpu")
        w = torch.linspace(-1.0, 1.0, z.numel(), dtype=z.dtype)
        (z * w.reshape(z.shape)).sum().backward()
        return [v.grad for v in args]
    return run


f32, f64 = torch.float32, torch.float64

#: name -> a callable returning a ``QPSolution`` (solve cases) or the
#: inputs' gradients (gradient cases).
CASES = {
    "dense_f32_xfree": _dense_case(1, f32),
    "dense_f32_xfree_shared": _dense_case(2, f32, shared=True),
    "dense_f32_direct_x": _dense_case(3, f32, resid_every=1),
    "dense_f32_coeff_x_false": _dense_case(4, f32, coeff_x=False),
    "dense_f32_eq": _dense_case(5, f32, neq=NEQ),
    "dense_f64_subst": _dense_case(6, f64),
    "dense_f64_subst_eq": _dense_case(7, f64, neq=NEQ),
    "dense_f64_equilibrated": _dense_case(8, f64, equilibrate=True),
    "dense_f32_blocked": _dense_case(9, f32, use_pallas="blocked"),
    "dense_f64_blocked": _dense_case(10, f64, use_pallas="blocked"),
    "dense_f32_hybrid": _dense_case(11, f32, use_pallas="hybrid"),
    "dense_f32_hybrid_direct_x": _dense_case(24, f32, use_pallas="hybrid",
                                             resid_every=1),
    "dense_f32_hybrid_eq": _dense_case(25, f32, neq=NEQ,
                                       use_pallas="hybrid"),
    "dense_f32_blocked_subst": _dense_case(26, f32, use_pallas="blocked",
                                           solve_method="subst"),
    "dense_f64_verbose": _dense_case(27, f64, neq=NEQ, verbose=1),
    "dense_f32_verbose": _dense_case(28, f32, verbose=1),
    "dense_f64_full": _dense_case(12, f64, kkt_solver=KS.FULL),
    "dense_f64_ir": _dense_case(13, f64, kkt_solver=KS.IR),
    "dense_f32_full_eq": _dense_case(14, f32, neq=NEQ, kkt_solver=KS.FULL),
    "dense_f32_refine_eps": _dense_case(15, f32, eps=1e-8),
    "dense_f64_refine_eps": _dense_case(16, f64, eps=1e-8),
    "dense_f32_warm": _dense_case(17, f32, warm=True),
    "dense_f64_warm_eq": _dense_case(18, f64, neq=NEQ, warm=True),
    "dense_f32_correctors": _dense_case(19, f32, n_correctors=2),
    "dense_f64_correctors": _dense_case(20, f64, n_correctors=2),
    "dense_f64_nan_lane": _dense_case(21, f64, nan_lane=2,
                                      check_Q_spd=False),
    "dense_f32_nan_lane": _dense_case(22, f32, nan_lane=2,
                                      check_Q_spd=False),
    "dense_f64_escalate": _dense_case(23, f64, max_iter=4,
                                      escalate="oracle"),
    "diag_f64": _diag_case(30, f64),
    "diag_f64_eq": _diag_case(31, f64, neq=NEQ),
    "diag_f32_eq_correctors": _diag_case(32, f32, neq=NEQ, n_correctors=2),
    "diag_f32_fused": _diag_case(33, f32, neq=NEQ, fused_diag_step=True),
    "diag_f64_fused_correctors": _diag_case(34, f64, neq=NEQ,
                                            fused_diag_step=True,
                                            n_correctors=1),
    "band_f64": _band_case(40, f64),
    "band_f64_eq_refine": _band_case(41, f64, neq=NEQ, refine_steps=2),
    "band_f32_refine": _band_case(42, f32, refine_steps=3),
    "general_f64_refine": _band_case(43, f64, general=True, refine_steps=2),
    "general_f32_eq": _band_case(44, f32, neq=NEQ, general=True),
    "grad_f32": _grad_case(50, f32),
    "grad_f64_eq": _grad_case(51, f64, neq=NEQ),
}

FIELDS = ("z", "lam", "s", "nu")
STATS = ("iterations", "best_resids", "mu", "converged")


def outputs(name):
    """The case's arrays, keyed by name within the case."""
    out = CASES[name]()
    if isinstance(out, list):
        return {f"grad_{i}": g for i, g in enumerate(out)}
    arrs = {k: getattr(out, k) for k in FIELDS}
    arrs.update({k: getattr(out.stats, k) for k in STATS})
    return arrs


def main():
    torch.set_num_threads(1)
    data = {}
    for name in CASES:
        for k, v in outputs(name).items():
            data[f"{name}/{k}"] = v.detach().numpy()
    np.savez_compressed(DATA, **data)
    print(f"wrote {DATA}: {len(CASES)} cases")


if __name__ == "__main__":
    main()
