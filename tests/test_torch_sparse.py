"""The PyTorch port's ``SpQPFunction`` against the JAX package's: the same
construction-time tier for every pattern, and on the diagonal and dense
tiers the same solutions and value-gradients (float64, 1e-8). Patterns
that reach the banded or the block-tridiagonal general solver raise
``NotImplementedError`` naming their ROADMAP items; an automatically
chosen general pattern below float64 and n = 512 is densified, as in the
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from test_sparse import (_banded_problem, _densify_np, _diag_problem,
                         _general_problem)

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
    return zj, gj, zt.detach(), [a.grad for a in tt]


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


@pytest.mark.parametrize("kind", ["banded", "box", "reference_fixture"])
def test_banded_patterns_resolve_alike_and_raise(kind):
    """Banded Q with diagonal G, diagonal Q with box G, and the reference's
    sparse fixture with its 4 x 5 diagonal G take the banded tier in both
    packages; the port has no banded solver yet and says so instead of
    densifying."""
    rng = np.random.RandomState(15)
    if kind == "banded":
        Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n) = _banded_problem(rng)
        m = n
    elif kind == "reference_fixture":
        (Qi, Qv, (n, _)), (Gi, Gv, (m, _), h), (Ai, Av, (neq, _), b), p = (
            _diag_problem(rng, nbatch=2, nx=5, nineq=4))
    else:
        n, B = 20, 2
        m, neq = 2 * n, 0
        Qi = np.stack([np.arange(n), np.arange(n)])
        Qv = 1.0 + rng.rand(B, n)
        Gi = np.stack([np.arange(2 * n), np.tile(np.arange(n), 2)])
        Gv = np.concatenate([np.ones((B, n)), -np.ones((B, n))], axis=1)
        h, p = rng.rand(B, 2 * n) + 0.5, rng.randn(B, n)
        Ai, Av, b = np.zeros((2, 0), int), np.zeros((B, 0)), np.zeros((B, 0))
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n))
    assert fj.structure == ft.structure == "banded"
    vals = [torch.tensor(v) for v in (Qv, p, Gv, h, Av, b)]
    with pytest.raises(NotImplementedError, match="item 17"):
        ft(*vals)
    with pytest.raises(NotImplementedError, match="item 17"):
        ft.solve_full(*vals)


def test_general_pattern_f32_densifies_f64_raises():
    """An automatically chosen general pattern with n < 512: float32
    densifies (the dense port, bit-identical), float64 would need the
    general block-tridiagonal solver and raises."""
    rng = np.random.RandomState(16)
    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(rng)
    fj, ft = _both(Qi, (n, n), Gi, (m, n), Ai, (neq, n))
    assert fj.structure == ft.structure == "general"
    assert np.array_equal(ft._general_perm(ft.Qi, ft.Gi), fj._gen[0])
    vals32 = [torch.tensor(v, dtype=torch.float32)
              for v in (Qv, p, Gv, h, Av, b)]
    z32 = ft(*vals32)
    dense = [torch.tensor(v, dtype=torch.float32) for v in (
        _densify_np(Qi, Qv, (n, n)), p, _densify_np(Gi, Gv, (m, n)), h,
        _densify_np(Ai, Av, (neq, n)), b)]
    npt.assert_array_equal(z32.numpy(),
                           qt.solve_qp(*dense, device="cpu").numpy())
    with pytest.raises(NotImplementedError, match="items 17 and 18"):
        ft(*[torch.tensor(v) for v in (Qv, p, Gv, h, Av, b)])
    forced = qt.SpQPFunction(Qi, (n, n), Gi, (m, n), Ai, (neq, n),
                             structure="general", device="cpu")
    with pytest.raises(NotImplementedError, match="items 17 and 18"):
        forced(*vals32)


def test_dense_pattern_stays_dense():
    n = 12
    Qi = np.stack(np.nonzero(np.ones((n, n))))
    Gi = np.stack([np.arange(n), np.arange(n)])
    fj, ft = _both(Qi, (n, n), Gi, (n, n), np.zeros((2, 0), int), (0, n))
    assert fj.structure == ft.structure == "dense"
