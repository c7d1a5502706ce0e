"""The PyTorch port's ``SpQPFunction`` against the JAX package's: the same
construction-time tier for every pattern, and on the diagonal and dense
tiers the same solutions and value-gradients (float64, 1e-8), and on the
banded and general tiers the same plans (blocking, scatter maps,
permutation, G pattern) and the same solutions (1e-9, equal iterations)
and value-gradients (1e-8). An automatically chosen general pattern below
float64 and n = 512 is densified, as in the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from test_sparse import (_banded_problem, _densify_np, _diag_problem,
                         _general_problem, _kkt_score)

torch.set_num_threads(1)


def _both(Qi, Qsz, Gi, Gsz, Ai, Asz, **kw):
    return (qpth_tpu.SpQPFunction(Qi, Qsz, Gi, Gsz, Ai, Asz, **kw),
            qt.SpQPFunction(Qi, Qsz, Gi, Gsz, Ai, Asz, device="cpu", **kw))


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    npt.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                        err_msg=err_msg)


def _values_and_grads(fj, ft, vals, w):
    """z and the gradients of sum(z * w) to all six value arrays, from the
    JAX and the port's SpQPFunction."""
    zj = fj(*map(jnp.asarray, vals))
    gj = jax.grad(lambda *a: jnp.sum(fj(*a) * w), argnums=tuple(range(6)))(
        *map(jnp.asarray, vals))
    tt = [torch.tensor(v, requires_grad=True) for v in vals]
    zt = ft(*tt)
    (zt * torch.tensor(w)).sum().backward()
    # Values the solve does not read (Av, b without equality rows) get no
    # gradient in PyTorch and zeros in JAX.
    return zj, gj, zt.detach(), [torch.zeros_like(a) if a.grad is None
                                 else a.grad for a in tt]


def test_reference_fixture_tier_values_and_grads():
    """The reference's sparse fixture (upstream qpth's test.py) with square
    diagonal G resolves to the diagonal tier in both packages."""
    rng = np.random.RandomState(11)
    (Qi, Qv, Qsz), (Gi, Gv, Gsz, h), (Ai, Av, Asz, b), p = _diag_problem(
        rng, nbatch=3, nx=5, nineq=5)
    fj, ft = _both(Qi, Qsz, Gi, Gsz, Ai, Asz)
    assert fj.structure == ft.structure == "diag"
    w = rng.randn(3, 5)
    zj, gj, zt, gt = _values_and_grads(fj, ft, (Qv, p, Gv, h, Av, b), w)
    _close(zt.numpy(), zj, 1e-8, "z")
    for name, a, e in zip(("Qv", "p", "Gv", "h", "Av", "b"), gt, gj):
        _close(a.numpy(), e, 1e-8, name)


def test_duplicate_entries_accumulate():
    """A repeated COO index adds its values (both packages), and each
    copy receives the gradient of the sum."""
    rng = np.random.RandomState(12)
    n, B = 4, 2
    Qi = np.array([[0, 1, 2, 3, 0], [0, 1, 2, 3, 0]])
    Qv = 0.5 + rng.rand(B, 5)
    Gi = np.stack([np.arange(n), np.arange(n)])
    Gv = -(0.5 + rng.rand(B, n))
    h = rng.rand(B, n) + 0.5
    Ai = np.array([[0, 0, 0], [0, 1, 1]])
    Av = rng.randn(B, 3)
    b = rng.randn(B, 1)
    fj, ft = _both(Qi, (n, n), Gi, (n, n), Ai, (1, n))
    assert ft.structure == "diag"
    w = rng.randn(B, n)
    zj, gj, zt, gt = _values_and_grads(fj, ft,
                                       (Qv, rng.randn(B, n), Gv, h, Av, b),
                                       w)
    _close(zt.numpy(), zj, 1e-8)
    for a, e in zip(gt, gj):
        _close(a.numpy(), e, 1e-8)
    npt.assert_allclose(gt[0][:, 0].numpy(), gt[0][:, 4].numpy())
    npt.assert_allclose(gt[4][:, 1].numpy(), gt[4][:, 2].numpy())


def test_solve_full_diag_tier_matches_jax():
    rng = np.random.RandomState(13)
    (Qi, Qv, Qsz), (Gi, Gv, Gsz, h), (Ai, Av, Asz, b), p = _diag_problem(
        rng, nbatch=3, nx=5, nineq=5)
    fj, ft = _both(Qi, Qsz, Gi, Gsz, Ai, Asz)
    vals = (Qv, p, Gv, h, Av, b)
    sj = fj.solve_full(*map(jnp.asarray, vals))
    st = ft.solve_full(*map(torch.tensor, vals))
    for name in ("z", "lam", "s", "nu"):
        _close(getattr(st, name).numpy(), getattr(sj, name), 1e-9, name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    init = tuple(getattr(st, k) for k in ("z", "s", "lam", "nu"))
    warm = ft.solve_full(*map(torch.tensor, vals), init=init)
    assert (warm.z - st.z).abs().max() < 1e-6


def test_forced_dense_matches_dense_port():
    """structure="dense" scatters the values and runs the dense layer:
    bit-identical to the port's solve_qp on the same dense operands, and
    the JAX package's within 1e-9."""
    rng = np.random.RandomState(14)
    (Qi, Qv, Qsz), (Gi, Gv, Gsz, h), (Ai, Av, Asz, b), p = _diag_problem(
        rng, nbatch=3, nx=5, nineq=5)
    fj, ft = _both(Qi, Qsz, Gi, Gsz, Ai, Asz, structure="dense")
    vals = (Qv, p, Gv, h, Av, b)
    zt = ft(*map(torch.tensor, vals))
    dense = (_densify_np(Qi, Qv, Qsz), p, _densify_np(Gi, Gv, Gsz), h,
             _densify_np(Ai, Av, Asz), b)
    npt.assert_array_equal(
        zt.numpy(), qt.solve_qp(*map(torch.tensor, dense),
                                device="cpu").numpy())
    _close(zt.numpy(), fj(*map(jnp.asarray, vals)), 1e-9)


def _plans_alike(fj, ft):
    """The port's construction-time plan is the reference's: the tier, the
    blocking, Q's scatter maps, the separable row -> column map, and the
    general tier's permutation and G pattern tables."""
    assert ft.structure == fj.structure
    assert ft._band == tuple(int(v) for v in fj._band)
    for k in ("_qd_sel", "_qe_sel"):
        npt.assert_array_equal(getattr(ft, k), getattr(fj, k), err_msg=k)
    for k in ("_qd_idx", "_qe_idx"):
        for a, e in zip(getattr(ft, k), getattr(fj, k)):
            npt.assert_array_equal(a, e, err_msg=k)
    if fj.structure == "banded":
        npt.assert_array_equal(ft._g_ci, fj._g_ci)
    else:
        for a, e in zip(ft._gen[:2], fj._gen[:2]):
            npt.assert_array_equal(a, e)
        st, sj = ft._gen[2], fj._gen[2]
        assert (st.m, st.n, st.bs, st.nb) == (sj.m, sj.n, sj.bs, sj.nb)
        for k in ("rows", "cols", "hd", "qe", "hd_row", "qe_row"):
            npt.assert_array_equal(getattr(st, k), getattr(sj, k),
                                   err_msg=k)


def _full_alike(fj, ft, vals, tol=1e-9):
    """solve_full: z, lam, s, nu within tol and equal iterations."""
    sj = fj.solve_full(*map(jnp.asarray, vals))
    st = ft.solve_full(*map(torch.tensor, vals))
    for name in ("z", "lam", "s", "nu"):
        _close(getattr(st, name).numpy(), getattr(sj, name), tol, name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    return st, sj


def _box_problem(rng, n=20, B=2):
    Qi = np.stack([np.arange(n), np.arange(n)])
    Qv = 1.0 + rng.rand(B, n)
    Gi = np.stack([np.arange(2 * n), np.tile(np.arange(n), 2)])
    Gv = np.concatenate([np.ones((B, n)), -np.ones((B, n))], axis=1)
    h, p = rng.rand(B, 2 * n) + 0.5, rng.randn(B, n)
    Ai, Av, b = np.zeros((2, 0), int), np.zeros((B, 0)), np.zeros((B, 0))
    return Qi, Qv, Gi, Gv, h, p, Ai, Av, b


@pytest.mark.parametrize("kind", ["banded", "box", "reference_fixture"])
def test_banded_patterns_resolve_alike_and_raise(kind):
    """Banded Q with diagonal G (n = 22: padded to 24), diagonal Q with box
    G, and the reference's sparse fixture with its 4 x 5 diagonal G (n = 5:
    padded to 6) take the banded tier in both packages, with the same plan.
    The port's banded solver runs them (it raised before it was ported):
    z and the gradients to all six value arrays against the JAX
    SpQPFunction (float64, 1e-9 and 1e-8), and solve_full's duals with
    equal iterations."""
    rng = np.random.RandomState(15)
    if kind == "banded":
        Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n) = _banded_problem(rng)
        m = n
    elif kind == "reference_fixture":
        (Qi, Qv, (n, _)), (Gi, Gv, (m, _), h), (Ai, Av, (neq, _), b), p = (
            _diag_problem(rng, nbatch=2, nx=5, nineq=4))
    else:
        Qi, Qv, Gi, Gv, h, p, Ai, Av, b = _box_problem(rng)
        n, m, neq = 20, 40, 0
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n))
    assert fj.structure == ft.structure == "banded"
    _plans_alike(fj, ft)
    vals = (Qv, p, Gv, h, Av, b)
    w = rng.randn(*p.shape)
    zj, gj, zt, gt = _values_and_grads(fj, ft, vals, w)
    _close(zt.numpy(), zj, 1e-9, "z")
    for name, a, e in zip(("Qv", "p", "Gv", "h", "Av", "b"), gt, gj):
        _close(a.numpy(), e, 1e-8, name)
    _full_alike(fj, ft, vals)


def test_general_pattern_f32_densifies_f64_raises():
    """An automatically chosen general pattern with n < 512: float32
    densifies (the dense port, bit-identical), float64 runs the general
    block-tridiagonal tier (it raised before it was ported), and an
    explicit structure="general" runs that tier in float32 too.

    This draw sits where the reference is not reproducible to rounding:
    lane 1 stalls at a residual of 4.5e-6 in both packages, and a one-ulp
    change of p moves the JAX package's own z by 3.5e-8 (12 iterations
    become 13, the port's count) and turns its lane-1 gradient
    non-finite. So float64 z is held to four times the reference's own
    one-ulp spread here, and the gradients on the two lanes below 1e-6 to
    1e-4 of their largest entry (lane 2 ends at 1.7e-10 in the port and
    5.5e-7 in the reference: two points of one stall); the tight
    comparisons are test_general_pattern_auto_dispatch and
    test_general_pattern_no_eq. Float32 holds the port's error against
    float64 to at most twice the reference's."""
    rng = np.random.RandomState(16)
    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(rng)
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n))
    assert fj.structure == ft.structure == "general"
    _plans_alike(fj, ft)
    vals32 = [torch.tensor(v, dtype=torch.float32)
              for v in (Qv, p, Gv, h, Av, b)]
    z32 = ft(*vals32)
    dense = [torch.tensor(v, dtype=torch.float32) for v in (
        _densify_np(Qi, Qv, (n, n)), p, _densify_np(Gi, Gv, (m, n)), h,
        _densify_np(Ai, Av, (neq, n)), b)]
    npt.assert_array_equal(z32.numpy(),
                           qt.solve_qp(*dense, device="cpu").numpy())

    vals = (Qv, p, Gv, h, Av, b)
    flip = np.random.RandomState(3).choice([-1.0, 1.0], p.shape)
    p_ulp = p * (1.0 + np.finfo(np.float64).eps * flip)
    zj = np.asarray(fj(*map(jnp.asarray, vals)))
    zj_ulp = np.asarray(fj(*map(jnp.asarray, (Qv, p_ulp, Gv, h, Av, b))))
    spread = float(np.abs(zj - zj_ulp).max())
    assert spread > 1e-9
    tt = [torch.tensor(v, requires_grad=True) for v in vals]
    zt = ft(*tt)
    assert float(np.abs(zt.detach().numpy() - zj).max()) <= 4 * spread
    gj = jax.grad(lambda *a: jnp.sum(fj(*a) ** 2),
                  argnums=tuple(range(6)))(*map(jnp.asarray, vals))
    (zt ** 2).sum().backward()
    st = ft.solve_full(*map(torch.tensor, vals))
    conv = st.stats.best_resids.numpy() < 1e-6
    assert conv.sum() == 2
    for name, a, e in zip(("Qv", "p", "Gv", "h", "Av", "b"), tt, gj):
        _close(a.grad.numpy()[conv], np.asarray(e)[conv], 1e-4, name)

    forced = qt.SpQPFunction(Qi, (n, n), Gi, (m, n), Ai, (neq, n),
                             structure="general", device="cpu")
    fjf = qpth_tpu.SpQPFunction(Qi, (n, n), Gi, (m, n), Ai, (neq, n),
                                structure="general",
                                config=qpth_tpu.SolverConfig(use_pallas=True))
    zf = forced(*vals32).numpy()
    zfj = np.asarray(fjf(*[jnp.asarray(v, jnp.float32) for v in vals]))
    z64 = zt.detach().numpy()
    assert np.abs(zf - z32.numpy()).max() > 0          # not densified
    assert (np.abs(zf - z64).max()
            <= 2 * max(np.abs(zfj - z64).max(), 1e-6))


def test_dense_pattern_stays_dense():
    n = 12
    Qi = np.stack(np.nonzero(np.ones((n, n))))
    Gi = np.stack([np.arange(n), np.arange(n)])
    fj, ft = _both(Qi, (n, n), Gi, (n, n), np.zeros((2, 0), int), (0, n))
    assert fj.structure == ft.structure == "dense"


def test_banded_detection_boundaries(rng):
    """A full-bandwidth pattern stays dense; banded Q with a non-separable
    (but narrow) G takes the general tier; both packages alike."""
    n = 24
    Qi_dense = np.stack(np.nonzero(np.ones((n, n))))
    Gi = np.stack([np.arange(n), np.arange(n)])
    none = np.zeros((2, 0), int)
    fj, ft = _both(Qi_dense, (n, n), Gi, (n, n), none, (0, n))
    assert fj.structure == ft.structure == "dense"
    Qi = _banded_problem(rng, n=n, neq=0)[0]
    fj, ft = _both(Qi, (n, n), np.array([[0, 0], [0, 1]]), (n, n), none,
                   (0, n))
    assert fj.structure == ft.structure == "general"
    _plans_alike(fj, ft)
    with pytest.raises(ValueError):
        qt.SpQPFunction(Qi_dense, (n, n), Gi, (n, n), none, (0, n),
                        structure="general", device="cpu")


@pytest.mark.parametrize("neq", [4, 0])
def test_general_pattern_auto_dispatch(rng, neq):
    """A scrambled banded pattern with non-separable G (tests/test_sparse.py's
    fixture) auto-dispatches to the general tier in both packages with the
    same plan; float64 z and the gradients to all six value arrays match
    the JAX SpQPFunction (1e-9, 1e-8) and its solve_full with equal
    iterations, and z the densified dense port to the reference's 1e-5."""
    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(
        rng, neq=neq)
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n))
    assert fj.structure == ft.structure == "general"
    _plans_alike(fj, ft)
    vals = (Qv, p, Gv, h, Av, b)
    w = rng.randn(*p.shape)
    zj, gj, zt, gt = _values_and_grads(fj, ft, vals, w)
    _close(zt.numpy(), zj, 1e-9, "z")
    for name, a, e in zip(("Qv", "p", "Gv", "h", "Av", "b"), gt, gj):
        _close(a.numpy(), e, 1e-8, name)
    _full_alike(fj, ft, vals)
    dense = [_densify_np(Qi, Qv, (n, n)), p, _densify_np(Gi, Gv, (m, n)), h]
    if neq:
        dense += [_densify_np(Ai, Av, (neq, n)), b]
    z_ref = qt.solve_qp(*map(torch.tensor, dense), device="cpu")
    npt.assert_allclose(zt.numpy(), z_ref.numpy(), atol=1e-5)


def test_general_newton_refinement_floor(rng, monkeypatch):
    """The general tier's per-solve Newton refinement: with the d cap and
    its 2 passes the float64 floor is below 1e-7 in both packages (the
    reference's regression test; the run spends its last iterations at the
    floor, where the two trajectories part by rounding, so z is not
    compared here), at the same iteration count; without the passes the
    port's floor is ten times higher (4.2e-8 against 2.9e-9 here)."""
    from qpth_tpu.bandqp import solve_qp_banded_full as jax_full

    from qpth_tpu_torch.core import banded as tband

    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(
        rng, neq=0)
    cfg = dict(not_improved_lim=50)
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (0, n),
                   config=None)
    fj.config = qpth_tpu.SolverConfig(**cfg)
    ft.config = qt.SolverConfig(**cfg)
    perm, _, spec = ft._gen
    Qd, Qe = ft._band_blocks(torch.tensor(Qv))
    args = (Qd, Qe, torch.tensor(p)[:, perm], torch.tensor(Gv),
            torch.tensor(h))
    sol = qt.solve_qp_banded_full(*args, None, None, config=ft.config,
                                  g_spec=spec, device="cpu")
    best = float(sol.stats.best_resids.max())
    assert best < 1e-7, best
    sj = jax_full(*(jnp.asarray(v.numpy()) for v in args), None, None,
                  config=fj.config, g_spec=fj._gen[2])
    assert float(np.asarray(sj.stats.best_resids).max()) < 1e-7
    assert int(sol.stats.iterations) == int(sj.stats.iterations)
    monkeypatch.setattr(tband, "_GEN_IR_PASSES", 0)
    raw = qt.solve_qp_banded_full(*args, None, None, config=ft.config,
                                  g_spec=spec, device="cpu")
    assert float(raw.stats.best_resids.max()) > 10 * best


def test_solve_full_banded_tier(rng):
    """solve_full on the banded tier: the KKT conditions of the densified
    problem to 1e-6, z equal to __call__'s, and the JAX package's
    solution with equal iterations; a warm start stays put."""
    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n) = _banded_problem(rng)
    fj, ft = _both(Qi, (n, n), Gi, (n, n), Ai, (neq, n))
    assert ft.structure == "banded"
    vals = (Qv, p, Gv, h, Av, b)
    st, _ = _full_alike(fj, ft, vals)
    sc = _kkt_score(_densify_np(Qi, Qv, (n, n)), p,
                    _densify_np(Gi, Gv, (n, n)), h,
                    _densify_np(Ai, Av, (neq, n)), b, st)
    assert sc.max() < 1e-6, sc
    z_call = ft(*map(torch.tensor, vals))
    npt.assert_allclose(st.z.numpy(), z_call.numpy(), atol=1e-12)
    init = (st.z, st.s, st.lam, st.nu)
    warm = ft.solve_full(*map(torch.tensor, vals), init=init)
    assert (warm.z - st.z).abs().max() < 1e-6


def test_solve_full_general_tier(rng):
    """solve_full on the general tier (forced): KKT to 1e-5, z equal to
    __call__'s, the JAX package's solution with equal iterations, and a
    warm start that goes through the permutation and padding and agrees
    with the JAX package's warm start."""
    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(rng)
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n),
                   structure="general")
    vals = (Qv, p, Gv, h, Av, b)
    st, sj = _full_alike(fj, ft, vals)
    sc = _kkt_score(_densify_np(Qi, Qv, (n, n)), p,
                    _densify_np(Gi, Gv, (m, n)), h,
                    _densify_np(Ai, Av, (neq, n)), b, st)
    assert sc.max() < 1e-5, sc
    z_call = ft(*map(torch.tensor, vals))
    npt.assert_allclose(st.z.numpy(), z_call.numpy(), atol=1e-12)
    init_t = (st.z, st.s, st.lam, st.nu)
    init_j = (sj.z, sj.s, sj.lam, sj.nu)
    wt = ft.solve_full(*map(torch.tensor, vals), init=init_t)
    wj = fj.solve_full(*map(jnp.asarray, vals), init=init_j)
    assert (wt.z - st.z).abs().max() < 1e-5
    _close(wt.z.numpy(), wj.z, 1e-9)
    assert int(wt.stats.iterations) == int(wj.stats.iterations)
