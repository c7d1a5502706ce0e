"""The PyTorch port's solver modes beyond the float32 defaults, against the
JAX package: untracked residuals (``resid_every=1``), the direct x
recurrence (``coeff_x=False``), a single exact checkpoint
(``resid_every=0``), the float64 default (substitution mode, untracked
residuals, the global not-improved window at margin 0, no equilibration),
substitution mode on equilibrated data, and warm starts (``init=``).

Float64 on both sides; the differences are rounding (the port applies
inv(chol(T)) where the JAX package's XLA backend substitutes on chol(T)),
so solutions agree to 1e-9 and iteration counts are equal. Where a solve
would otherwise end on the global window closing at the float64 noise
floor, eps = 1e-9 ends it on the eps test in both packages."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from conftest import make_feasible_qp
from test_torch_qp import make_problem
from test_torch_qp_eq import make_eq_problem

torch.set_num_threads(1)

INV = dict(solve_method="inverse")
MODES = {
    "untracked_eps": dict(INV, resid_every=1, eps=1e-9, refine_steps=0),
    "coeff_x_false": dict(INV, resid_every=7, coeff_x=False),
    "untracked_gondzio": dict(INV, resid_every=1, n_correctors=2, eps=1e-9,
                              refine_steps=0),
    "single_checkpoint": dict(INV, resid_every=0),
    "f64_default": dict(),
    "f64_default_eps": dict(eps=1e-9, refine_steps=0),
    "f64_default_gondzio": dict(n_correctors=2, eps=1e-9, refine_steps=0),
    "subst_equilibrated": dict(solve_method="subst", equilibrate=True,
                               eps=1e-9, refine_steps=0),
    "subst_tracked_request": dict(solve_method="subst", resid_every=7,
                                  eps=1e-9, refine_steps=0),
}


def _data(kind):
    if kind == "batched":
        return make_problem(8, 12, 10, seed=1)
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(2), nz=12,
                                        nineq=10, nbatch=8)
    return Q, p, G[0], h[0]


def _both(data, kw, **call):
    jcall = {k: (tuple(None if v is None else jnp.asarray(v) for v in val)
                 if k == "init" else val) for k, val in call.items()}
    tcall = {k: (tuple(None if v is None else torch.tensor(v) for v in val)
                 if k == "init" else val) for k, val in call.items()}
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data),
                                config=qpth_tpu.SolverConfig(**kw), **jcall)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu",
                          **tcall)
    return sj, st


def _assert_same(sj, st, atol=1e-9):
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=atol,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    npt.assert_allclose(st.stats.best_resids.numpy(),
                        np.asarray(sj.stats.best_resids), atol=atol)


@pytest.mark.parametrize("kind", ["batched", "shared"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_f64_matches_jax(mode, kind):
    """neq = 0 in every mode. ``subst_tracked_request``: substitution mode
    has no cached products, so ``resid_every`` > 1 is not tracked (both
    packages score every iterate)."""
    sj, st = _both(_data(kind), MODES[mode])
    _assert_same(sj, st)


@pytest.mark.parametrize("mode", ["f64_default_eps", "subst_equilibrated",
                                  "untracked_eps"])
def test_mode_f64_with_equalities_matches_jax(mode):
    data = make_eq_problem(8, 12, 10, 4, seed=3)
    sj, st = _both(data, MODES[mode])
    _assert_same(sj, st)


def test_f64_default_window_is_global():
    """At float64 the improve margin is 0 and the not-improved window is
    upstream qpth's global one: the whole batch runs while any lane still
    improves. A batch holding one slow lane takes the slow lane's
    iteration count; that lane alone takes the same."""
    Q, p, G, h = make_problem(6, 10, 8, seed=5)
    p[3] *= 1e4                       # one lane far from its solution
    full = qt.solve_qp_full(*(torch.tensor(v) for v in (Q, p, G, h)),
                            device="cpu")
    alone = qt.solve_qp_full(*(torch.tensor(v[3:4]) for v in (Q, p, G, h)),
                             device="cpu")
    rest = qt.solve_qp_full(*(torch.tensor(np.delete(v, 3, 0))
                              for v in (Q, p, G, h)), device="cpu")
    assert int(full.stats.iterations) >= int(alone.stats.iterations)
    assert int(full.stats.iterations) >= int(rest.stats.iterations)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in (Q, p, G, h)))
    assert int(full.stats.iterations) == int(sj.stats.iterations)
    npt.assert_allclose(full.z.numpy(), np.asarray(sj.z), rtol=1e-8,
                        atol=1e-8)


@pytest.mark.parametrize("kw", [dict(INV, resid_every=7),
                                dict(INV, resid_every=7, equilibrate=True),
                                dict(INV, resid_every=1, eps=1e-9,
                                     refine_steps=0),
                                dict(eps=1e-9, refine_steps=0)],
                         ids=["tracked", "tracked_equilibrated",
                              "untracked", "f64_default"])
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq"])
def test_warm_start_matches_jax(eq, kw):
    """A receding-horizon re-solve: the first solution (z, s, lam, nu) as
    ``init`` of a solve with perturbed p. At the solution complementary
    entries of s and lam are ~0, so the clip at ``warm_start_min`` (in
    semantic coordinates under equilibration) acts on most of them."""
    data = (make_eq_problem(8, 12, 10, 4, seed=6) if eq
            else make_problem(8, 12, 10, seed=6))
    first = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                             config=qt.SolverConfig(**kw), device="cpu")
    init = (first.z.numpy(), first.s.numpy(), first.lam.numpy(),
            first.nu.numpy() if eq else None)
    assert (init[1] < 1e-3).any() and (init[2] < 1e-3).any()
    data2 = list(data)
    data2[1] = data[1] + 0.05 * np.random.RandomState(7).randn(8, 12)
    sj, st = _both(data2, kw, init=init)
    _assert_same(sj, st)
    cold = qt.solve_qp_full(*(torch.tensor(v) for v in data2),
                            config=qt.SolverConfig(**kw), device="cpu")
    # Warm and cold start stop at different iterates of the same solve:
    # they agree as far as eps = 1e-9 on the residuals pins z.
    npt.assert_allclose(st.z.numpy(), cold.z.numpy(), atol=1e-5)


def test_warm_start_clip_value():
    """``warm_start_min`` is the clip: an init of zeros in s and z is the
    same start as an init of warm_start_min."""
    data = make_problem(4, 8, 6, seed=8)
    cfg = qt.SolverConfig(solve_method="inverse", resid_every=7,
                          warm_start_min=0.25)
    args = [torch.tensor(v) for v in data]
    x0 = torch.zeros(4, 8, dtype=torch.float64)
    zeros = torch.zeros(4, 6, dtype=torch.float64)
    a = qt.solve_qp_full(*args, config=cfg, device="cpu",
                         init=(x0, zeros, zeros, None))
    b = qt.solve_qp_full(*args, config=cfg, device="cpu",
                         init=(x0, zeros + 0.25, zeros + 0.25, None))
    npt.assert_array_equal(a.z.numpy(), b.z.numpy())
    assert int(a.stats.iterations) == int(b.stats.iterations)


def test_warm_start_through_solve_qp_has_gradients():
    data = make_eq_problem(4, 8, 6, 2, seed=9)
    cfg = qt.SolverConfig(solve_method="inverse", resid_every=7)
    args = [torch.tensor(v, requires_grad=True) for v in data]
    cold = qt.solve_qp_full(*(a.detach() for a in args), config=cfg,
                            device="cpu")
    z = qt.solve_qp(*args, config=cfg, device="cpu",
                    init=(cold.z, cold.s, cold.lam, cold.nu))
    z.sum().backward()
    ref = [torch.tensor(v, requires_grad=True) for v in data]
    qt.solve_qp(*ref, config=cfg, device="cpu").sum().backward()
    for name, a, c in zip("QpGhAb", args, ref):
        npt.assert_allclose(a.grad.numpy(), c.grad.numpy(), atol=1e-7,
                            err_msg=name)


def test_direct_x_f32_matches_pallas():
    """float32 with untracked residuals: the JAX package through
    ``ipm_step_lanes`` (interpret mode), the port through ``ipm_step``'s
    plain version; the port's z error against the float64 solution is
    held to at most twice the reference's own. Every iterate is scored, so
    the solve ends when the per-lane windows close on float32 noise: the
    iteration counts are not comparable."""
    data = make_problem(8, 9, 7, seed=2)
    sj = qpth_tpu.solve_qp_full(
        *(jnp.asarray(v, jnp.float32) for v in data),
        config=qpth_tpu.SolverConfig(use_pallas=True, resid_every=1))
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                            for v in data),
                          config=qt.SolverConfig(resid_every=1),
                          device="cpu")
    for name in ("z", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)),
                            atol=5e-4, rtol=2e-3, err_msg=name)
    z64 = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in data),
        config=qpth_tpu.SolverConfig(solve_method="inverse",
                                     resid_every=7)).z)
    err_port = np.abs(st.z.numpy() - z64).max()
    err_ref = np.abs(np.asarray(sj.z) - z64).max()
    assert err_port <= 2.0 * err_ref + 1e-5, (err_port, err_ref)


def test_fail_soft_lane_in_composed_step():
    """A lane whose Q is not SPD gives NaN in the init solve; it restarts
    from the neutral point with the adaptive regularization armed, the
    composed step (float64 default) freezes it where it must, and the
    other lanes solve as if it were not there."""
    Q, p, G, h = make_problem(6, 8, 6, seed=4)
    Qbad = Q.copy()
    Qbad[2] = -np.eye(8)
    cfg = qt.SolverConfig(check_Q_spd=False, verbose=-1)
    bad = qt.solve_qp_full(*(torch.tensor(v) for v in (Qbad, p, G, h)),
                           config=cfg, device="cpu")
    good = qt.solve_qp_full(*(torch.tensor(np.delete(v, 2, 0))
                              for v in (Q, p, G, h)),
                            config=cfg, device="cpu")
    keep = [0, 1, 3, 4, 5]
    npt.assert_allclose(bad.z.numpy()[keep], good.z.numpy(), atol=1e-8)
    sj = qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in (Qbad, p, G, h)),
        config=qpth_tpu.SolverConfig(check_Q_spd=False, verbose=-1))
    npt.assert_allclose(bad.z.numpy()[keep], np.asarray(sj.z)[keep],
                        atol=1e-8)
