"""The PyTorch port's QP layer with equality constraints against the JAX
package: forward solve, implicit-KKT gradients to all six parameters, the
closed-form solver for nineq = 0 and the OptNet sudoku pattern.

Float64 runs compare like with like: ``solve_method="inverse",
resid_every=7`` is the float32 defaults' algebra (the JAX package composes
the tracked iteration with packed x coefficients through XLA; the port
runs the fused ``ipm_step_eq`` step's plain version), and the float64
default is substitution mode with untracked residuals (the JAX package
substitutes on chol(T); the port applies inv(chol(T)) through kernel A's
and ``inv_solve``'s plain versions). The differences are rounding, so the
tolerances are tight: 1e-9 on the solution, 1e-8 on gradients, equal
iteration counts.

The float32 default runs against ``SolverConfig(use_pallas=True)``
(``ipm_step_eq_lanes`` in interpret mode) and is held by its error against
the float64 solve, as tests/test_torch_qp_f32.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu_torch import qp as qp_mod

torch.set_num_threads(1)

CONFIGS = {
    "inverse_tracked": dict(solve_method="inverse", resid_every=7),
    "f64_default": dict(),
}
NAMES = "QpGhAb"


def make_eq_problem(nbatch, nz, nineq, neq, seed=0, with_z0=False):
    """bench.py's generator with equality rows: A and b = A z0 are drawn
    after the other draws, so Q, p, G, h are those of the neq = 0 problem
    with the same seed. ``with_z0`` also returns the feasible point."""
    npr = np.random.RandomState(seed)
    L = npr.rand(nbatch, nz, nz)
    Q = np.matmul(L, L.transpose(0, 2, 1)) + 1e-3 * np.eye(nz)
    G = npr.randn(nbatch, nineq, nz)
    z0 = npr.randn(nbatch, nz)
    s0 = npr.rand(nbatch, nineq)
    p = npr.randn(nbatch, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + s0
    A = npr.randn(nbatch, neq, nz)
    b = np.einsum("bmn,bn->bm", A, z0)
    return (Q, p, G, h, A, b) + ((z0,) if with_z0 else ())


def _data(kind):
    """Every lane stays feasible at its own z0 (h = G z0 + slack,
    b = A z0) whichever matrices are shared."""
    Q, p, G, h, A, b, z0 = make_eq_problem(8, 12, 10, 4, seed=1,
                                           with_z0=True)
    if kind == "batched":
        return Q, p, G, h, A, b
    b_shared = np.einsum("mn,bn->bm", A[0], z0)
    if kind == "shared":
        # Shared matrices (factored once), batched vectors.
        return (Q[0], p, G[0], np.einsum("mn,bn->bm", G[0], z0) + 0.5,
                A[0], b_shared)
    # "mixed": shared Q and A, batched G: the equality operands of the
    # fused step then carry different batch dims (S11 shared, S21 batched).
    return Q[0], p, G, h, A[0], b_shared


def _solve_both(data, cj, ct, dtype=torch.float64, **kw):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v, jdt) for v in data),
                                config=cj, **kw)
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=dtype) for v in data),
                          config=ct, device="cpu", **kw)
    return sj, st


@pytest.mark.parametrize("kind", ["batched", "shared", "mixed"])
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_eq_slice_f64_matches_jax(mode, kind):
    data = _data(kind)
    sj, st = _solve_both(data, qpth_tpu.SolverConfig(**CONFIGS[mode]),
                         qt.SolverConfig(**CONFIGS[mode]))
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    npt.assert_allclose(st.stats.best_resids.numpy(),
                        np.asarray(sj.stats.best_resids), atol=1e-9)
    # and it is a solution: A z = b, G z <= h.
    Q, p, G, h, A, b = (torch.tensor(v) for v in data)
    Ab = A if A.dim() == 3 else A.unsqueeze(0)
    Gb = G if G.dim() == 3 else G.unsqueeze(0)
    assert (torch.einsum("bmn,bn->bm", Ab.expand(8, -1, -1), st.z)
            - b).abs().max() < 1e-8
    assert (torch.einsum("bmn,bn->bm", Gb.expand(8, -1, -1), st.z)
            - h).max() < 1e-8


def _grads_jax(data, w, cfg):
    def loss(*args):
        return jnp.sum(qpth_tpu.solve_qp(*args, config=cfg) * w)

    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(v) for v in data))


def _grads_torch(data, w, cfg):
    args = [torch.tensor(v, requires_grad=True) for v in data]
    z = qt.solve_qp(*args, config=cfg, device="cpu")
    (z * torch.tensor(w)).sum().backward()
    return [a.grad.numpy() for a in args]


@pytest.mark.parametrize("kind,reduction", [("batched", "sum"),
                                            ("shared", "sum"),
                                            ("shared", "mean"),
                                            ("mixed", "sum")])
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_eq_grads_f64_match_jax(mode, kind, reduction):
    """Gradients to all six parameters; shared matrices receive the
    batch-summed (or, upstream qpth's way, averaged) cotangent."""
    data = _data(kind)
    w = np.random.RandomState(9).randn(8, 12)
    kw = dict(CONFIGS[mode], broadcast_grad_reduction=reduction)
    gj = _grads_jax(data, w, qpth_tpu.SolverConfig(**kw))
    gt = _grads_torch(data, w, qt.SolverConfig(**kw))
    for name, a, b in zip(NAMES, gt, gj):
        assert a.shape == np.asarray(b).shape, name
        npt.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-8,
                            err_msg=name)


def test_unbatched_vectors_mean_reduction():
    """A, b and the other parameters passed without a batch dim, one
    batched p: 'mean' divides every broadcast cotangent by B."""
    Q, p, G, h, A, b = _data("shared")
    data = (Q, p, G, h.mean(0) + 1.0, A, b[0])
    w = np.random.RandomState(5).randn(8, 12)
    for reduction in ("sum", "mean"):
        kw = dict(solve_method="inverse", resid_every=7,
                  broadcast_grad_reduction=reduction)
        gj = _grads_jax(data, w, qpth_tpu.SolverConfig(**kw))
        gt = _grads_torch(data, w, qt.SolverConfig(**kw))
        for name, a, c in zip(NAMES, gt, gj):
            assert a.shape == np.asarray(c).shape, name
            npt.assert_allclose(a, np.asarray(c), rtol=1e-7, atol=1e-8,
                                err_msg=f"{name} {reduction}")


@pytest.mark.parametrize("option", [dict(n_correctors=2),
                                    dict(equilibrate=True),
                                    dict(resid_every=1, eps=1e-9,
                                         refine_steps=0),
                                    dict(coeff_x=False)],
                         ids=["gondzio_2", "equilibrate", "untracked",
                              "coeff_x_false"])
def test_eq_options_f64_match_jax(option):
    """Options on the inverse-mode path with equality constraints: Gondzio
    corrections (dy follows the accepted corrections), Ruiz equilibration
    with R_A (full branch), untracked residuals, the direct x recurrence.
    Untracked residuals score every iterate, so with the default eps =
    1e-12 the global window closes on float64 rounding noise; eps = 1e-9
    (refinement off, as the eps-driven dial would switch it on there) ends
    the solve on the eps test in both packages."""
    data = _data("batched")
    kw = dict(CONFIGS["inverse_tracked"], **option)
    sj, st = _solve_both(data, qpth_tpu.SolverConfig(**kw),
                         qt.SolverConfig(**kw))
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)


def test_eq_composed_step_matches_jax(monkeypatch):
    """Where the fused step does not fit a thread block the solver composes
    the iteration from kernel A and ``inv_solve`` and tracks x by packed
    coefficients [w | v | e | c]: the branch the JAX package takes through
    XLA. Forced here by refusing the fit."""
    from qpth_tpu_torch.ops import kkt as kkt_ops
    from qpth_tpu_torch.ops.cuda import kernels

    monkeypatch.setattr(kkt_ops, "fused_step_supported",
                        lambda *a, **k: False)
    called = []
    monkeypatch.setattr(kernels, "ipm_step_eq_plain",
                        lambda *a, **k: called.append(1))
    data = _data("batched")
    kw = dict(CONFIGS["inverse_tracked"], n_correctors=1)
    sj, st = _solve_both(data, qpth_tpu.SolverConfig(**kw),
                         qt.SolverConfig(**kw))
    assert not called
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)


def test_eq_slice_f32_matches_pallas():
    """The float32 defaults with equality constraints: the JAX package
    through ``ipm_step_eq_lanes`` (interpret mode), the port through
    ``ipm_step_eq``'s plain version. Both carry float32 rounding of the
    same size; the port's z error against the float64 solution is held to
    at most twice the reference's own. The exit iteration is decided by
    the tracked score falling below eps between checkpoints, 1000x per
    step at alpha = 0.999, so float32 rounding moves it by one step in
    either direction on most seeds; it is held to within one."""
    data = make_eq_problem(8, 9, 7, 3, seed=4)
    sj, st = _solve_both(data, qpth_tpu.SolverConfig(use_pallas=True),
                         qt.SolverConfig(), dtype=torch.float32)
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)),
                            atol=5e-4, rtol=2e-3, err_msg=name)
    assert abs(int(st.stats.iterations) - int(sj.stats.iterations)) <= 1
    z64 = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in data),
        config=qpth_tpu.SolverConfig(**CONFIGS["inverse_tracked"])).z)
    err_port = np.abs(st.z.numpy() - z64).max()
    err_ref = np.abs(np.asarray(sj.z) - z64).max()
    assert err_port <= 2.0 * err_ref + 1e-5, (err_port, err_ref)


def test_eq_f32_conditioning_limit_is_the_references():
    """bench.py's generator (Q = gram + 1e-3 I, condition 1e5-1e6) with
    equality rows is beyond float32 inverse mode in both packages: the
    Schur core R = G Q^-1 G^T - S21 S11^-1 S21^T cancels catastrophically
    and the relative z error against float64 is percents, not 1e-4. The
    port's error is the reference's (same order), and Q + 0.1 I brings
    both back under 1e-3. The width-100 equality workload of the on-card
    run (chip_smoke.py) shifts Q for this reason."""
    raw = make_eq_problem(8, 60, 60, 30, seed=0)
    med = {}
    for shift in (0.0, 0.1):
        data = (raw[0] + shift * np.eye(60),) + raw[1:]
        z64 = np.asarray(qpth_tpu.solve_qp_full(
            *(jnp.asarray(v) for v in data),
            config=qpth_tpu.SolverConfig(**CONFIGS["inverse_tracked"])).z)
        sj, st = _solve_both(
            data, qpth_tpu.SolverConfig(solve_method="inverse", verbose=-1),
            qt.SolverConfig(verbose=-1), dtype=torch.float32)
        for name, z in (("jax", np.asarray(sj.z)), ("port", st.z.numpy())):
            e = (np.linalg.norm(z - z64, axis=1)
                 / np.linalg.norm(z64, axis=1))
            med[name, shift] = float(np.median(e))
    assert med["jax", 0.0] > 1e-2 and med["port", 0.0] > 1e-2, med
    assert med["port", 0.0] < 5.0 * med["jax", 0.0], med
    assert med["jax", 0.1] < 1e-3 and med["port", 0.1] < 1e-3, med


def _sudoku_params(n, seed):
    """The OptNet sudoku layer's QP as ``qpth_tpu/nn.py`` builds it with
    ``structure="dense"``: nz = nineq = (n^2)^3, shared Q = 0.1 I, G = -I,
    h = 0, shared A ~ U(0, 1) with neq = 40 rows at n = 2. b = A z0 with
    z0 > 0: the layer's b = 1 leaves {x >= 0, A x = 1} empty for a random
    A, and an infeasible QP has no solution to compare."""
    nx = (n * n) ** 3
    neq = 40
    rng = np.random.RandomState(seed)
    A = rng.rand(neq, nx)
    z0 = rng.rand(nx) + 0.1
    return (0.1 * np.eye(nx), -np.eye(nx), np.zeros(nx), A, A @ z0)


def test_sudoku_pattern_matches_jax():
    """Shared Q, G, h, A, b and a batched p (the puzzle features), with
    gradients to A: the pattern of upstream qpth's sudoku notebook at
    n = 2. Float64, inverse mode with tracked residuals."""
    Q, G, h, A, b = _sudoku_params(2, seed=0)
    p = -np.random.RandomState(1).rand(4, 64)
    data = (Q, p, G, h, A, b)
    kw = CONFIGS["inverse_tracked"]
    sj, st = _solve_both(data, qpth_tpu.SolverConfig(**kw),
                         qt.SolverConfig(**kw))
    assert st.z.shape == (4, 64) and st.nu.shape == (4, 40)
    npt.assert_allclose(st.z.numpy(), np.asarray(sj.z), atol=1e-9)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    w = np.random.RandomState(2).randn(4, 64)
    gj = _grads_jax(data, w, qpth_tpu.SolverConfig(**kw))
    gt = _grads_torch(data, w, qt.SolverConfig(**kw))
    for name, a, c in zip(NAMES, gt, gj):
        assert a.shape == np.asarray(c).shape, name
        npt.assert_allclose(a, np.asarray(c), rtol=1e-7, atol=1e-8,
                            err_msg=name)


def test_sudoku_b_equal_1_is_infeasible_for_a_random_A():
    """Why the sudoku fixtures take b = A z0 and not the layer's b = 1:
    for A ~ U(0, 1) of 40 x 64 the set {x >= 0, A x = 1} is empty (a phase-1
    LP says so), while b = A z0 at an interior z0 is feasible. The draw is
    the on-card run's (chip_smoke.py, seed 0)."""
    from scipy.optimize import linprog

    nx, neq = 64, 40
    A = np.random.RandomState(0).rand(neq, nx)
    for b, status in ((np.ones(neq), 2), (A @ np.full(nx, 2.0 / nx), 0)):
        res = linprog(np.zeros(nx), A_eq=A, b_eq=b,
                      bounds=[(0, None)] * nx)
        assert res.status == status, res.message   # 2: infeasible, 0: solved


def test_sudoku_f32_default_grad_clamp_limit_is_the_references(monkeypatch):
    """The sudoku QP's Schur core R = G Q^-1 G^T - S21 W = 10 (I - P_A) is
    singular, so the backward's T = R + diag(s / lam) leans on its
    diagonal. At the default ``grad_clamp=1e-8`` that diagonal reaches
    1e-17 on degenerate coordinates and, in float32, the factor-inverse
    recurrence meets a negative pivot on some lanes. The JAX package's
    float32 path (its lanes kernels, here in interpret mode) gives a NaN
    gradient to A there and finite gradients on the others. The port's
    float32 factor breaks on lanes of the same draw, and it solves them
    again from float64 factors (``qp._redo_broken_lanes``): its gradients
    are finite on every lane, at either clamp. Lanes 41 and 97 of the
    on-card run's draw (seed 0) beside six healthy ones; A is given per
    lane so that each lane's gradient is seen on its own."""
    nx, neq, lanes = 64, 40, [41, 97, 0, 1, 2, 3, 4, 5]
    rng = np.random.RandomState(0)
    A = rng.rand(neq, nx)
    p = -(rng.rand(128, nx) < 0.25).astype(np.float64)[lanes]
    Ab = np.broadcast_to(A, (len(lanes), neq, nx)).copy()
    data = (0.1 * np.eye(nx), p, -np.eye(nx), np.zeros(nx), Ab,
            A @ np.full(nx, 2.0 / nx))

    def nan_lanes_jax(clamp):
        cfg = qpth_tpu.SolverConfig(use_pallas=True, grad_clamp=clamp,
                                    check_Q_spd=False, verbose=-1)
        args = [jnp.asarray(v, jnp.float32) for v in data]

        def loss(A_):
            z = qpth_tpu.solve_qp(*args[:4], A_, args[5], config=cfg)
            return jnp.sum(z * z)

        g = np.asarray(jax.grad(loss)(args[4]))
        return np.isnan(g).reshape(len(lanes), -1).any(axis=1)

    redone = []
    directions = qp_mod._kkt_directions

    def spy(factors, *a):
        if factors.R.dtype == torch.float64:
            redone.append(a[2].shape[0])
        return directions(factors, *a)

    def nan_lanes_port(clamp):
        args = [torch.tensor(v, dtype=torch.float32) for v in data]
        args[4].requires_grad_(True)
        z = qt.solve_qp(*args, config=qt.SolverConfig(grad_clamp=clamp,
                                                      check_Q_spd=False,
                                                      verbose=-1),
                        device="cpu")
        (z * z).sum().backward()
        return torch.isnan(args[4].grad).flatten(1).any(dim=1).numpy()

    bad_jax = nan_lanes_jax(1e-8)
    assert bad_jax[:2].any() and not bad_jax[2:].any(), bad_jax
    monkeypatch.setattr(qp_mod, "_kkt_directions", spy)
    assert not nan_lanes_port(1e-8).any()
    assert 1 <= sum(redone) <= 2, redone
    assert not nan_lanes_port(1e-5).any()


@pytest.mark.parametrize("with_A", [True, False], ids=["A", "no_A"])
def test_solve_qp_eq_matches_jax(with_A):
    """The closed-form solver for nineq = 0, reached directly and through
    the dispatch of ``solve_qp`` / ``solve_qp_full`` (G, h None or
    zero-sized), with autograd gradients against ``jax.grad``."""
    Q, p, _, _, A, b = _data("batched")
    if not with_A:
        A = b = None
    jargs = [None if v is None else jnp.asarray(v) for v in (Q, p, A, b)]
    xj = np.asarray(qpth_tpu.solve_qp_eq(*jargs))
    targs = [None if v is None else torch.tensor(v, requires_grad=True)
             for v in (Q, p, A, b)]
    x = qt.solve_qp_eq(*targs, device="cpu")
    npt.assert_allclose(x.detach().numpy(), xj, atol=1e-10)

    Qt, pt, At, bt = targs
    via = qt.solve_qp(Qt, pt, None, None, At, bt, device="cpu")
    npt.assert_array_equal(via.detach().numpy(), x.detach().numpy())
    full = qt.solve_qp_full(Qt, pt, torch.zeros(0), torch.zeros(0), At, bt,
                            device="cpu")
    fj = qpth_tpu.solve_qp_full(jargs[0], jargs[1], None, None, *jargs[2:])
    npt.assert_array_equal(full.z.numpy(), x.detach().numpy())
    npt.assert_allclose(full.nu.numpy(), np.asarray(fj.nu), atol=1e-9)
    assert full.lam.shape == (8, 0) and full.s.shape == (8, 0)
    assert int(full.stats.iterations) == 1 and bool(
        full.stats.converged.all())

    w = np.random.RandomState(3).randn(*xj.shape)
    (x * torch.tensor(w)).sum().backward()
    idx = [i for i, v in enumerate(jargs) if v is not None]
    gj = jax.grad(lambda *a: jnp.sum(qpth_tpu.solve_qp_eq(*a) * w),
                  argnums=tuple(range(len(idx))))(*(jargs[i] for i in idx))
    for i, g in zip(idx, gj):
        npt.assert_allclose(targs[i].grad.numpy(), np.asarray(g),
                            rtol=1e-8, atol=1e-9, err_msg="QpAb"[i])


def test_prefactor_with_A_reused_across_solves():
    """``prefactor_qp(Q, G, A)`` once, then solves with changing p, h, b
    through ``factors=`` equal fresh solves, in both modes."""
    Q, p, G, h, A, b = _data("batched")
    for mode, kw in CONFIGS.items():
        cfg = qt.SolverConfig(**kw)
        f = qt.prefactor_qp(*(torch.tensor(v) for v in (Q, G, A)),
                            config=cfg, device="cpu")
        assert (f.invQ is None) == (mode == "f64_default")
        for shift in (0.0, 0.3):
            args = [torch.tensor(v) for v in (Q, p + shift, G, h + shift,
                                              A, b)]
            own = qt.solve_qp_full(*args, config=cfg, device="cpu")
            got = qt.solve_qp_full(*args, config=cfg, factors=f,
                                   device="cpu")
            npt.assert_array_equal(got.z.numpy(), own.z.numpy())
            npt.assert_array_equal(got.nu.numpy(), own.nu.numpy())


def test_qpfunction_takes_equalities():
    Q, p, G, h, A, b = _data("batched")
    fn = qt.QPFunction(device="cpu", solve_method="inverse", resid_every=7)
    args = [torch.tensor(v) for v in (Q, p, G, h, A, b)]
    z = fn(*args)
    zj = qpth_tpu.QPFunction(solve_method="inverse", resid_every=7)(
        *(jnp.asarray(v) for v in (Q, p, G, h, A, b)))
    npt.assert_allclose(z.numpy(), np.asarray(zj), atol=1e-9)
    # zero-sized A, b mean "no equality constraints"
    z0 = fn(*args[:4], torch.zeros(0), torch.zeros(0))
    npt.assert_array_equal(z0.numpy(), fn(*args[:4]).numpy())
