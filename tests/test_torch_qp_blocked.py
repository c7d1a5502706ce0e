"""``SolverConfig(use_pallas="blocked")``, the Cholesky-factor KKT backend
(``ops/kkt.py::blocked_backend``: T's factor by kernel C, every solve on it
by kernel D, and in substitution mode the factors of Q and S11 by kernel C
with their solves by kernel D), end to end against the JAX package.

* float64: the JAX package's float64 solve runs its XLA backend whatever
  ``use_pallas`` says: Cholesky factors and substitutions, the algebra of
  the blocked backend. Solutions agree to 1e-9 with equal iterations at
  eps = 1e-9, gradients to 1e-8 (batched, the OptNet pattern, with and
  without equality rows, ``SpQPFunction``'s dense tier).
* float32: against the same algebra in the JAX package, ``use_pallas=False``
  with ``solve_method`` set (its XLA backend substitutes w = x + z in the
  predictor, as the blocked backend does), and against its
  ``use_pallas="blocked"`` in interpret mode, to the JAX package's float32
  tolerance, each z error against float64 at most twice the reference's.
* the ``use_pallas`` table: each value and each error."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu_torch.ops import hybrid
from qpth_tpu_torch.ops import kkt as kkt_ops
from qpth_tpu_torch.ops.cuda import kernels

from conftest import make_feasible_qp
from test_torch_qp import make_problem
from test_torch_qp_eq import make_eq_problem

torch.set_num_threads(1)

BLOCKED = dict(use_pallas="blocked")
EPS9 = dict(eps=1e-9, refine_steps=0)


def _data(kind):
    """12 variables, 10 inequalities (4 equality rows for "eq_*"); every
    lane feasible at its own z0 whichever matrices are shared."""
    if kind == "batched":
        return make_problem(8, 12, 10, seed=1)
    if kind == "shared":
        # The OptNet pattern: shared Q, G and h, batched p.
        Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(2), nz=12,
                                            nineq=10, nbatch=8)
        return Q, p, G[0], h[0]
    Q, p, G, h, A, b, z0 = make_eq_problem(8, 12, 10, 4, seed=1,
                                           with_z0=True)
    if kind == "eq_batched":
        return Q, p, G, h, A, b
    return (Q[0], p, G[0], np.einsum("mn,bn->bm", G[0], z0) + 0.5, A[0],
            np.einsum("mn,bn->bm", A[0], z0))


def _solve_both(data, jkw, tkw, dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v, jdt) for v in data),
                                config=qpth_tpu.SolverConfig(**jkw))
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=dtype) for v in data),
                          config=qt.SolverConfig(**tkw), device="cpu")
    return sj, st


@pytest.mark.parametrize("kind", ["batched", "shared", "eq_batched",
                                  "eq_shared"])
def test_blocked_f64_matches_jax(kind):
    data = _data(kind)
    sj, st = _solve_both(data, EPS9, dict(BLOCKED, **EPS9))
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    npt.assert_allclose(st.stats.best_resids.numpy(),
                        np.asarray(sj.stats.best_resids), atol=1e-9)


def _grads(data, w, jkw, tkw):
    n = len(data)

    def loss(*args):
        return jnp.sum(qpth_tpu.solve_qp(*args,
                                         config=qpth_tpu.SolverConfig(**jkw))
                       * w)

    gj = jax.grad(loss, argnums=tuple(range(n)))(
        *(jnp.asarray(v) for v in data))
    args = [torch.tensor(v, requires_grad=True) for v in data]
    z = qt.solve_qp(*args, config=qt.SolverConfig(**tkw), device="cpu")
    (z * torch.tensor(w)).sum().backward()
    return gj, [a.grad.numpy() for a in args]


@pytest.mark.parametrize("kind", ["batched", "shared", "eq_batched",
                                  "eq_shared"])
def test_blocked_f64_grads_match_jax(kind):
    """Gradients to every parameter (all six with equality rows); the
    backward's one factor and solve run in kernel C, its Q and S11 solves
    in kernel D."""
    data = _data(kind)
    w = np.random.RandomState(9).randn(8, 12)
    gj, gt = _grads(data, w, EPS9, dict(BLOCKED, **EPS9))
    for name, a, b in zip("QpGhAb", gt, gj):
        assert a.shape == np.asarray(b).shape, name
        npt.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-8,
                            err_msg=name)


def test_blocked_f64_runs_the_cholesky_kernels(monkeypatch):
    """In substitution mode every T, Q and S11 solve goes through kernel D
    and every factor through kernel C: count the plain versions' calls."""
    calls = {"chol": 0, "cho_solve": 0, "factor_inv": 0, "inv_solve": 0}
    for name in calls:
        plain = getattr(kernels, f"{name}_plain")

        def counted(*a, _p=plain, _n=name, **k):
            calls[_n] += 1
            return _p(*a, **k)

        monkeypatch.setattr(kernels, f"{name}_plain", counted)
    data = _data("eq_batched")
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                          config=qt.SolverConfig(**BLOCKED, **EPS9),
                          device="cpu")
    its = int(st.stats.iterations)
    assert calls["factor_inv"] == 0 and calls["inv_solve"] == 0
    # Q, S11, then T once for the init and once per stepped iteration.
    assert calls["chol"] in (2 + its, 1 + its)
    assert calls["cho_solve"] > 4 * its


def test_spqp_dense_tier_blocked_matches_jax():
    from test_sparse import _diag_problem

    rng = np.random.RandomState(11)
    (Qi, Qv, Qsz), (Gi, Gv, Gsz, h), (Ai, Av, Asz, b), p = _diag_problem(
        rng, nbatch=3, nx=5, nineq=4)
    fj = qpth_tpu.SpQPFunction(Qi, Qsz, Gi, Gsz, Ai, Asz, structure="dense",
                               config=qpth_tpu.SolverConfig(**EPS9))
    ft = qt.SpQPFunction(Qi, Qsz, Gi, Gsz, Ai, Asz, structure="dense",
                         config=qt.SolverConfig(**BLOCKED, **EPS9),
                         device="cpu")
    vals = (Qv, p, Gv, h, Av, b)
    w = rng.randn(3, 5)
    zj = fj(*map(jnp.asarray, vals))
    gj = jax.grad(lambda *a: jnp.sum(fj(*a) * w), argnums=tuple(range(6)))(
        *map(jnp.asarray, vals))
    tt = [torch.tensor(v, requires_grad=True) for v in vals]
    zt = ft(*tt)
    (zt * torch.tensor(w)).sum().backward()
    npt.assert_allclose(zt.detach().numpy(), np.asarray(zj), atol=1e-9)
    for name, a, e in zip(("Qv", "p", "Gv", "h", "Av", "b"), tt, gj):
        npt.assert_allclose(a.grad.numpy(), np.asarray(e), rtol=1e-7,
                            atol=1e-8, err_msg=name)


def _f32_data(neq):
    """nz = 9, nineq = 7, the f32 tests' shape (tests/test_torch_qp_f32.py);
    with equality rows Q is shifted by I, as chip_smoke.py's path 1 does,
    since the generator's Q with equality rows is beyond float32."""
    if neq == 0:
        return make_problem(8, 9, 7, seed=2)
    data = make_eq_problem(8, 9, 7, neq, seed=2)
    return (data[0] + np.eye(9),) + data[1:]


def _hold_f32(data, sj, st, same_iterations):
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=2e-4,
                            rtol=1e-3, err_msg=name)
    if same_iterations:
        assert int(st.stats.iterations) == int(sj.stats.iterations)
    z64 = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in data),
        config=qpth_tpu.SolverConfig(**EPS9)).z)
    err_port = np.abs(st.z.numpy() - z64).max()
    err_ref = np.abs(np.asarray(sj.z) - z64).max()
    assert err_port <= 2.0 * err_ref + 1e-5, (err_port, err_ref)


@pytest.mark.parametrize("neq", [0, 3])
@pytest.mark.parametrize("method", ["inverse", "subst"])
def test_blocked_f32_matches_jax_algebra(method, neq):
    """The JAX package's XLA backend runs the blocked backend's algebra
    (Cholesky factor of T, substitutions, w = x + z). Substitution mode
    scores every iterate, so the per-lane windows close on float32 noise
    and the iteration counts are not compared there."""
    data = _f32_data(neq)
    sj, st = _solve_both(data, dict(use_pallas=False, solve_method=method),
                         dict(BLOCKED, solve_method=method), torch.float32)
    _hold_f32(data, sj, st, same_iterations=method == "inverse")


@pytest.mark.parametrize("neq", [0, 3])
def test_blocked_f32_matches_pallas_blocked(neq):
    """Against the JAX package's own blocked backend, its Pallas kernels
    ``factor_kkt_t_pallas`` and ``cho_solve_vec_t_pallas`` in interpret
    mode (inverse mode, the float32 default)."""
    data = _f32_data(neq)
    sj, st = _solve_both(data, BLOCKED, BLOCKED, torch.float32)
    _hold_f32(data, sj, st, same_iterations=True)


def _tiny():
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(4), nz=6,
                                        nineq=5, nbatch=4)
    return [torch.tensor(v) for v in (Q, p, G, h)]


@pytest.mark.parametrize("value", ["auto", True, "lanes"])
def test_kernels_backend_values_are_the_default(value):
    args = _tiny()
    z = qt.solve_qp(*args, config=qt.SolverConfig(use_pallas=value),
                    device="cpu")
    npt.assert_array_equal(z.numpy(),
                           qt.solve_qp(*args, device="cpu").numpy())
    assert kkt_ops.resolve_backend(value, torch.float32, 5,
                                   "cpu").fused


@pytest.mark.parametrize("value,match", [
    (False, "no library-only path"), ("xla", "no library-only path"),
    ("hybrid_xla", "item 22")])
def test_unported_values_raise(value, match):
    """The library-only values raise. "hybrid_xla" raised naming item 22
    until the tensor-parallel path was ported: it now runs the hybrid
    backend and agrees with "hybrid"."""
    cfg = qt.SolverConfig(use_pallas=value)
    if value == "hybrid_xla":
        z = qt.solve_qp_full(*_tiny(), config=cfg, device="cpu").z
        want = qt.solve_qp_full(*_tiny(), config=qt.SolverConfig(
            use_pallas="hybrid"), device="cpu").z
        npt.assert_array_equal(z.numpy(), want.numpy())
        assert kkt_ops.backend_kind(value) == "hybrid"
        return
    with pytest.raises(NotImplementedError, match=match):
        qt.solve_qp_full(*_tiny(), config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        kkt_ops.resolve_backend(value, torch.float64, 5, "cpu")


@pytest.mark.parametrize("value", [None, "pallas", 1, "Blocked"])
def test_unknown_value_is_a_value_error(value):
    with pytest.raises(ValueError, match="use_pallas"):
        qt.SolverConfig(use_pallas=value)


@pytest.mark.parametrize("value", [True, "lanes"])
def test_lanes_with_subst_raises_as_in_jax(value):
    """The JAX package's message; float64 (its backend there is XLA) and
    use_pallas="blocked" accept substitution mode."""
    Q, p, G, h = _tiny()
    cfg = qt.SolverConfig(use_pallas=value, solve_method="subst")
    with pytest.raises(ValueError, match="solve_method='subst' requires"):
        qt.solve_qp_full(Q.float(), p.float(), G.float(), h.float(),
                         config=cfg, device="cpu")
    with pytest.raises(ValueError, match="solve_method='subst' requires"):
        qpth_tpu.solve_qp_full(*(jnp.asarray(v.numpy(), jnp.float32)
                                 for v in (Q, p, G, h)),
                               config=qpth_tpu.SolverConfig(
                                   use_pallas=value, solve_method="subst"))
    assert bool(torch.isfinite(qt.solve_qp(Q, p, G, h, config=cfg,
                                           device="cpu")).all())
    assert bool(torch.isfinite(qt.solve_qp(
        Q.float(), p.float(), G.float(), h.float(),
        config=qt.SolverConfig(**BLOCKED, solve_method="subst"),
        device="cpu")).all())


def test_blocked_backend_has_no_fused_step_and_its_own_fit():
    be = kkt_ops.resolve_backend("blocked", torch.float32, 200, "cuda")
    assert not be.fused
    assert be.q_solve2 is not None
    with pytest.raises(NotImplementedError, match="solves past it"):
        kkt_ops.resolve_backend("blocked", torch.float32, 240, "cuda")
    # nineq = 238: kernel C's one tile and 4 m-vectors fit (float32 m <= 239),
    # the kernels backend's tile, 8 m-vectors and reduction scratch do not
    # (m <= 237): "auto" takes the hybrid backend there.
    kkt_ops.resolve_backend("blocked", torch.float32, 238, "cuda")
    be = kkt_ops.resolve_backend("auto", torch.float32, 238, "cuda")
    assert not be.fused and be.solve2 is hybrid.solve_hybrid


def test_diagonal_tier_treats_blocked_as_auto():
    r = np.random.RandomState(5)
    args = [torch.tensor(v) for v in (
        np.full(6, 0.5), r.randn(4, 6), np.full(6, -1.0), np.ones(6),
        r.rand(2, 6), r.rand(2))]
    z = qt.solve_qp_diag(*args, config=qt.SolverConfig(**BLOCKED),
                         device="cpu")
    npt.assert_array_equal(z.numpy(),
                           qt.solve_qp_diag(*args, device="cpu").numpy())
    with pytest.raises(NotImplementedError, match="no library-only path"):
        qt.solve_qp_diag(*args, config=qt.SolverConfig(use_pallas="xla"),
                         device="cpu")
