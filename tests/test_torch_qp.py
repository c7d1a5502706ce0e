"""The PyTorch port's QP layer (``qpth_tpu_torch``) end to end at float64
against the JAX package: forward solve, implicit-KKT gradients to Q, p, G
and h, and the carried prefactorization.

Both packages run ``SolverConfig(solve_method="inverse", resid_every=7)``:
the tracked, x-free algebra of the float32 defaults, through XLA in the
JAX package and through the kernels' plain PyTorch versions in the port.
The only difference is rounding, so the tolerances are tight."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from conftest import make_feasible_qp

torch.set_num_threads(1)

CFG_J = qpth_tpu.SolverConfig(solve_method="inverse", resid_every=7)
CFG_T = qt.SolverConfig(solve_method="inverse", resid_every=7)


def make_problem(nbatch, nz, nineq, seed=0):
    """bench.py's generator: random dense QPs, fully batched."""
    npr = np.random.RandomState(seed)
    L = npr.rand(nbatch, nz, nz)
    Q = np.matmul(L, L.transpose(0, 2, 1)) + 1e-3 * np.eye(nz)
    G = npr.randn(nbatch, nineq, nz)
    z0 = npr.randn(nbatch, nz)
    s0 = npr.rand(nbatch, nineq)
    p = npr.randn(nbatch, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + s0
    return Q, p, G, h


def _data(kind):
    if kind == "batched":
        return make_problem(8, 12, 10, seed=1)
    # OptNet pattern: shared Q/G/h, batched p.
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(2), nz=12,
                                        nineq=10, nbatch=8)
    return Q, p, G[0], h[0]


@pytest.mark.parametrize("eps", [1e-12, 1e-9], ids=["eps_default",
                                                     "eps_1e-9"])
@pytest.mark.parametrize("kind", ["batched", "shared"])
def test_slice_f64_matches_jax(kind, eps):
    """With the default eps = 1e-12 the best scores sit at the float64
    floor (1e-12 to 1e-11), where rounding decides which side of eps a
    lane lands on, so ``converged`` is compared at eps = 1e-9 (refinement
    off, as the eps-driven dial would switch it on there)."""
    Q, p, G, h = _data(kind)
    cj = dataclasses.replace(CFG_J, eps=eps, refine_steps=0)
    ct = dataclasses.replace(CFG_T, eps=eps, refine_steps=0)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in (Q, p, G, h)),
                                config=cj)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in (Q, p, G, h)),
                          config=ct, device="cpu")
    for name in ("z", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    npt.assert_allclose(st.stats.best_resids.numpy(),
                        np.asarray(sj.stats.best_resids), atol=1e-9)
    if eps > 1e-10:
        npt.assert_array_equal(st.stats.converged.numpy(),
                               np.asarray(sj.stats.converged))


def _grads_jax(Q, p, G, h, w, cfg):
    def loss(Q, p, G, h):
        return jnp.sum(qpth_tpu.solve_qp(Q, p, G, h, config=cfg) * w)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (Q, p, G, h)))


def _grads_torch(Q, p, G, h, w, cfg, dtype=torch.float64):
    args = [torch.tensor(v, dtype=dtype, requires_grad=True)
            for v in (Q, p, G, h)]
    z = qt.solve_qp(*args, config=cfg, device="cpu")
    (z * torch.tensor(w, dtype=dtype)).sum().backward()
    return [a.grad.numpy() for a in args]


@pytest.mark.parametrize("kind,reduction", [("batched", "sum"),
                                            ("shared", "sum"),
                                            ("shared", "mean")])
def test_grads_f64_match_jax(kind, reduction):
    Q, p, G, h = _data(kind)   # shared: Q, G, h unbatched, p batched
    w = np.random.RandomState(9).randn(8, 12)
    cj = qpth_tpu.SolverConfig(solve_method="inverse", resid_every=7,
                               broadcast_grad_reduction=reduction)
    ct = qt.SolverConfig(solve_method="inverse", resid_every=7,
                         broadcast_grad_reduction=reduction)
    gj = _grads_jax(Q, p, G, h, w, cj)
    gt = _grads_torch(Q, p, G, h, w, ct)
    for name, a, b in zip("QpGh", gt, gj):
        assert a.shape == np.asarray(b).shape, name
        npt.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-9,
                            err_msg=name)


def _jax_factors_as_numpy(f):
    out = {k: np.array(v) for k, v in f._asdict().items()
           if v is not None and k not in ("scaling", "sem_scaling")}
    for k in ("scaling", "sem_scaling"):
        sc = getattr(f, k)
        if sc is not None:
            out[k] = {n: (None if v is None else np.array(v))
                      for n, v in sc._asdict().items()}
    return out


@pytest.mark.parametrize("equilibrate", [False, True])
def test_factors_from_numpy_match_own_prefactor(equilibrate):
    """qpth_tpu.prefactor_qp -> numpy -> factors_from_numpy gives the same
    solve as the port's own prefactorization."""
    Q, p, G, h = _data("batched")
    cj = qpth_tpu.SolverConfig(solve_method="inverse", resid_every=7,
                               equilibrate=equilibrate)
    ct = qt.SolverConfig(solve_method="inverse", resid_every=7,
                         equilibrate=equilibrate)
    fj = qpth_tpu.prefactor_qp(jnp.asarray(Q), jnp.asarray(G), config=cj)
    carried = qt.factors_from_numpy(_jax_factors_as_numpy(fj), "cpu")
    assert (carried.scaling is not None) == equilibrate
    args = [torch.tensor(v) for v in (Q, p, G, h)]
    own = qt.solve_qp_full(*args, config=ct, device="cpu")
    got = qt.solve_qp_full(*args, config=ct, factors=carried, device="cpu")
    # The two prefactorizations compute Q^-1 by different factorizations
    # (JAX: Cholesky solve against I; the port: factor inverse and Gram
    # product), so they agree to rounding, 1e-12 of each output's scale.
    for name in ("z", "lam", "s"):
        ref = getattr(own, name).numpy()
        npt.assert_allclose(getattr(got, name).numpy(), ref, rtol=0,
                            atol=1e-12 * np.abs(ref).max())
    assert int(got.stats.iterations) == int(own.stats.iterations)


@pytest.mark.parametrize("option", [dict(resid_every=0),
                                    dict(n_correctors=2),
                                    dict(improve_margin=1e-3),
                                    dict(equilibrate=True)],
                         ids=["resid_every_0", "gondzio_2",
                              "per_lane_window", "equilibrate"])
def test_solver_options_f64_match_jax(option):
    """Options of the ported branch: no in-loop checkpoint after the
    first, Gondzio correctors in the fused step, the per-lane latched
    window, and Ruiz equilibration (full branch: probe off)."""
    Q, p, G, h = _data("batched")
    cj = dataclasses.replace(CFG_J, **option)
    ct = dataclasses.replace(CFG_T, **option)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in (Q, p, G, h)),
                                config=cj)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in (Q, p, G, h)),
                          config=ct, device="cpu")
    for name in ("z", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9)
    assert int(st.stats.iterations) == int(sj.stats.iterations)


def test_grads_through_carried_factors():
    """Gradients with ``factors=`` (JAX-made, carried over) equal those of
    the port's own prefactorization."""
    Q, p, G, h = _data("batched")
    fj = qpth_tpu.prefactor_qp(jnp.asarray(Q), jnp.asarray(G), config=CFG_J)
    carried = qt.factors_from_numpy(_jax_factors_as_numpy(fj), "cpu")
    w = torch.tensor(np.random.RandomState(4).randn(8, 12))
    grads = []
    for factors in (None, carried):
        args = [torch.tensor(v, requires_grad=True) for v in (Q, p, G, h)]
        z = qt.solve_qp(*args, config=CFG_T, factors=factors, device="cpu")
        (z * w).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    for name, a, b in zip("QpGh", *grads):
        npt.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max(),
                            err_msg=name)
