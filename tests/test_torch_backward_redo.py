"""The dense backward's per-lane float64 redo (``qp._redo_broken_lanes``):
where R has rank at most nz - neq < nineq, a float32 lane whose T rounds
to not SPD is solved again from float64 factors at the same point, and
its gradients are those of the float64 KKT system there; the other lanes
keep theirs bit for bit (ROADMAP §3 D3)."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch import qp as qp_mod
from qpth_tpu_torch.ops import kkt as kkt_ops

from make_torch_d3_data import DATA, LANE, draw_lane
from test_torch_qp_eq import make_eq_problem

torch.set_num_threads(1)

BROKEN = 2          # the lane whose float32 factor is made to break


def _problem(kind, nz, nineq, neq):
    Q, p, G, h, A, b, z0 = make_eq_problem(4, nz, nineq, neq, seed=3,
                                           with_z0=True)
    if kind == "shared":
        Q, G, A = Q[0], G[0], A[0]
        h = np.einsum("mn,bn->bm", G, z0) + 0.5
        b = np.einsum("mn,bn->bm", A, z0)
    if neq == 0:
        A = b = None
    return Q, p, G, h, A, b


def _kkt_f64(Q, G, A, z, lam, s, w, clamp):
    """Directions of the backward's KKT system at (z, lam, s), dense in
    float64: [[Q, G^T, A^T], [G, -diag(1/d), 0], [A, 0, 0]] [dx; dlam;
    dnu] = [-w; 0; 0] with d = max(lam, c) / max(s, c)."""
    nz, nineq = Q.shape[-1], G.shape[-2]
    neq = 0 if A is None else A.shape[-2]
    d = np.maximum(lam, clamp) / np.maximum(s, clamp)
    K = np.zeros((nz + nineq + neq,) * 2)
    K[:nz, :nz] = Q
    K[:nz, nz:nz + nineq] = G.T
    K[nz:nz + nineq, :nz] = G
    K[nz:nz + nineq, nz:nz + nineq] = -np.diag(1.0 / d)
    if neq:
        K[:nz, nz + nineq:] = A.T
        K[nz + nineq:, :nz] = A
    rhs = np.concatenate([-w, np.zeros(nineq + neq)])
    x = np.linalg.solve(K, rhs)
    return x[:nz], x[nz:nz + nineq], x[nz + nineq:]


def _grads(args, w, config, before_backward=None):
    """z and the gradients of sum(z w) to every parameter;
    ``before_backward()`` runs between the forward and the backward."""
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in args]
    z = qt.solve_qp(*leaves, config=config, device="cpu")
    if before_backward is not None:
        before_backward()
    (z * w).sum().backward()
    return z.detach(), [None if a is None else a.grad for a in leaves]


def _break_float32_lane(monkeypatch):
    """The backward's float32 factor_solve returns NaN on lane BROKEN."""
    resolve = kkt_ops.resolve_backend

    def poisoned(*a, **k):
        be = resolve(*a, **k)

        def factor_solve(R, d, v):
            fac, x = be.factor_solve(R, d, v)
            if x.dtype == torch.float32:
                x = x.clone()
                x[BROKEN] = float("nan")
            return fac, x

        return be._replace(factor_solve=factor_solve)

    monkeypatch.setattr(kkt_ops, "resolve_backend", poisoned)


@pytest.mark.parametrize("shape", [(8, 10, 3), (8, 10, 0)],
                         ids=["eq", "no_eq"])
@pytest.mark.parametrize("kind", ["batched", "shared"])
@pytest.mark.parametrize("solve_method", ["inverse", "subst"])
def test_broken_lane_is_solved_again_in_float64(monkeypatch, shape, kind,
                                                solve_method):
    nz, nineq, neq = shape
    data = _problem(kind, nz, nineq, neq)
    args = [None if v is None else torch.tensor(v, dtype=torch.float32)
            for v in data]
    w = torch.tensor(np.random.RandomState(5).randn(4, nz),
                     dtype=torch.float32)
    cfg = qt.SolverConfig(check_Q_spd=False, solve_method=solve_method)
    _, clean = _grads(args, w, cfg)
    sol = qt.solve_qp_full(*args, config=cfg, device="cpu")
    _, redone = _grads(args, w, cfg,
                       lambda: _break_float32_lane(monkeypatch))

    for g in redone:
        assert g is None or bool(torch.isfinite(g).all())
    # The vectors' gradients are the directions lane by lane: dp = dx,
    # dh = -dlam, db = -dnu.
    vecs = [1, 3] + ([5] if neq else [])
    for i in vecs:
        keep = torch.arange(4) != BROKEN
        assert torch.equal(redone[i][keep], clean[i][keep])
    k = BROKEN
    Q, G = (data[i] if data[i].ndim == 2 else data[i][k] for i in (0, 2))
    A = None if neq == 0 else (data[4] if data[4].ndim == 2
                               else data[4][k])
    f64 = [None if M is None else M.astype(np.float32).astype(np.float64)
           for M in (Q, G, A)]
    dx, dlam, dnu = _kkt_f64(*f64, sol.z[k].double().numpy(),
                             sol.lam[k].double().numpy(),
                             sol.s[k].double().numpy(),
                             w[k].double().numpy(), cfg.grad_clamp)
    # Relative to the largest direction: at a vertex dx is ~0 and dlam
    # carries the answer.
    scale = max(np.abs(v).max() for v in (dx, dlam, dnu) if v.size)
    for i, want in zip(vecs, (dx, -dlam, -dnu)):
        got = redone[i][k].double().numpy()
        npt.assert_allclose(got, want.astype(np.float32), rtol=0,
                            atol=1e-6 * scale)


def test_full_rank_r_takes_no_host_read(monkeypatch):
    """With nineq <= nz - neq, R can have full rank: T is at least R, and
    the backward reads nothing back to check its lanes."""
    calls = []
    redo = qp_mod._redo_broken_lanes
    monkeypatch.setattr(qp_mod, "_redo_broken_lanes",
                        lambda *a: calls.append(1) or redo(*a))
    w = torch.ones(4, 8)
    for shape in ((8, 5, 3), (8, 8, 0)):
        args = [None if v is None else torch.tensor(v, dtype=torch.float32)
                for v in _problem("batched", *shape)]
        _grads(args, w, qt.SolverConfig(check_Q_spd=False))
    assert calls == []
    _grads([None if v is None else torch.tensor(v, dtype=torch.float32)
            for v in _problem("batched", 8, 6, 3)], w,
           qt.SolverConfig(check_Q_spd=False))
    assert calls == [1]


def test_stored_lane_is_path_1s_lane():
    d = np.load(DATA)
    for k, v in zip("QpGhAb", draw_lane(LANE)):
        npt.assert_array_equal(d[k], v.astype(np.float32), err_msg=k)


def test_path_1_lane_gradients_are_finite(monkeypatch):
    """chip_smoke.py path 1's lane 2106 in float32 inverse mode: its
    forward ends with more constraints pinned than R's rank of 50, and
    its float32 T is not SPD on the card. All six gradients are finite;
    where the float32 factor broke on this CPU, the lane's directions are
    the float64 KKT system's at the float32 point."""
    d = np.load(DATA)
    args = [torch.tensor(d[k]) for k in "QpGhAb"]
    cfg = qt.SolverConfig(check_Q_spd=False)
    dtypes = []
    directions = qp_mod._kkt_directions

    def spy(factors, *a):
        dtypes.append(factors.R.dtype)
        return directions(factors, *a)

    monkeypatch.setattr(qp_mod, "_kkt_directions", spy)
    z, g = _grads(args, 2 * qt.solve_qp_full(
        *args, config=cfg, device="cpu").z, cfg)
    assert all(bool(torch.isfinite(g_).all()) for g_ in g)
    assert dtypes[0] == torch.float32
    if len(dtypes) == 1:
        return
    assert dtypes[1:] == [torch.float64]
    sol = qt.solve_qp_full(*args, config=cfg, device="cpu")
    f64 = [d[k][0].astype(np.float64) for k in "QGA"]
    dx, dlam, dnu = _kkt_f64(*f64, *(v[0].double().numpy() for v in
                                     (sol.z, sol.lam, sol.s)),
                             2 * sol.z[0].double().numpy(), cfg.grad_clamp)
    scale = max(np.abs(v).max() for v in (dx, dlam, dnu))
    for got, want in ((g[1], dx), (g[3], -dlam), (g[5], -dnu)):
        npt.assert_allclose(got[0].double().numpy(), want, rtol=0,
                            atol=1e-5 * scale)

