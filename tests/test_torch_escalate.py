"""Escalation to the float64 CPU oracle (``SolverConfig(escalate=
"oracle")``, ``core/pdipm.py::_escalate_oracle``) and ``QPSolvers.
CPU_ORACLE`` (``qp.py::_oracle_forward``) in the PyTorch port, against the
JAX package on the CPU:

* the port's copy of the oracle (``qpth_tpu_torch/solvers/oracle.py``)
  gives the JAX package's answers bit for bit;
* ``tests/test_pdipm.py``'s three escalation fixtures (the rotated-spectrum
  cond ~1e8 Q, a healthy batch, ``tests/data_degenerate_eq.npz``): the same
  lanes flagged, the same double-word (hi + lo) solutions, a healthy batch
  bit-identical to the solve without escalation;
* refinement and escalation together (float64 z, float32 low words);
* ``CPU_ORACLE`` forward and backward (the backward builds the factors the
  oracle forward does not keep)."""

import os

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.solvers import oracle as jax_oracle
from qpth_tpu_torch.solvers import oracle as port_oracle

from conftest import make_feasible_qp
from test_torch_qp import make_problem

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


@pytest.mark.parametrize("neq", [0, 3])
def test_oracle_copy_matches_jax(neq):
    rng = np.random.RandomState(11)
    Q, p, G, h, A, b = make_feasible_qp(rng, nz=9, nineq=6, neq=neq,
                                        nbatch=4)
    for i in range(4):
        args = (Q, p[i], G[i], h[i]) + ((A[i], b[i]) if neq else ())
        got = port_oracle.solve_qp_np(*args, return_status=True)
        want = jax_oracle.solve_qp_np(*args, return_status=True)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                npt.assert_array_equal(g, w)
    got = port_oracle.solve_qp_batch_np(Q, p, G, h, A, b, return_status=True)
    want = jax_oracle.solve_qp_batch_np(Q, p, G, h, A, b, return_status=True)
    for g, w in zip(got, want):
        npt.assert_array_equal(g, w)


def _rotated_spectrum(B=8, n=48, m=48, cond_lanes=None):
    """``tests/test_pdipm.py``'s cond ~1e8 fixture: Q = U diag(logspace(0,
    -8)) U^T, shared; G per lane, h = G z0 + s0. With ``cond_lanes`` the
    other lanes get a well-conditioned Q instead (Q per lane)."""
    rng = np.random.RandomState(3)
    U, _ = np.linalg.qr(rng.randn(n, n))
    Q = (U * np.logspace(0, -8, n)) @ U.T
    Q = 0.5 * (Q + Q.T) + 1e-9 * np.eye(n)
    G = rng.randn(B, m, n)
    z0 = rng.randn(n)
    s0 = rng.rand(B, m)
    h = np.einsum("bmn,n->bm", G, z0) + s0
    p = rng.randn(B, n)
    if cond_lanes is not None:
        Qb = np.broadcast_to(U @ U.T + np.eye(n), (B, n, n)).copy()
        Qb[cond_lanes] = Q
        Q = Qb
    return Q, p, G, h


def _both(data, kw, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v, jdt) for v in data),
                                config=qpth_tpu.SolverConfig(**kw))
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=dtype) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu")
    return sj, st


def _dw(hi, lo):
    return np.float64(np.asarray(hi)) + np.float64(np.asarray(lo))


def test_escalate_rescues_cond_limited_lanes():
    """Beyond any float32 factorization (fail-soft keeps the lanes finite,
    far from converged): the lanes above escalate_tol re-solve on the host
    in float64. Both packages flag the same lanes and return the same
    double-word solution on them; the batch's median score is <= 1e-4,
    recomputed from hi + lo against the float32-representable problem."""
    data = _rotated_spectrum()
    kw = dict(check_Q_spd=False, verbose=-1, escalate="oracle")
    sj, st = _both(data, kw)
    esc = st.stats.escalated.numpy()
    assert esc.any()
    npt.assert_array_equal(esc, np.asarray(sj.stats.escalated))
    assert st.lo is not None and st.lo.z.dtype == torch.float32
    # The same oracle on the same float32 inputs: the same words, but XLA
    # on the CPU flushes float32 subnormals (~1e-39) to zero when it merges
    # them, and the port keeps them.
    for name in ("z", "lam", "s"):
        zt = _dw(getattr(st, name), getattr(st.lo, name))[esc]
        zj = _dw(getattr(sj, name), getattr(sj.lo, name))[esc]
        npt.assert_allclose(zt, zj, rtol=0, atol=1e-37, err_msg=name)
    # The scores are float64 residuals at the rounding floor (1e-11 to
    # 1e-8) of the same answer; the order of numpy's sums inside a host
    # callback moves their last digits.
    npt.assert_allclose(st.stats.best_resids.numpy()[esc],
                        np.asarray(sj.stats.best_resids)[esc], rtol=1e-3)
    assert np.median(st.stats.best_resids.numpy()) <= 1e-4
    Qf, pf, Gf, hf = (np.float64(np.float32(v)) for v in data)
    z, lam, sv = (_dw(getattr(st, k), getattr(st.lo, k))
                  for k in ("z", "lam", "s"))
    rx = np.einsum("nk,bk->bn", Qf, z) + pf + np.einsum("bmn,bm->bn", Gf,
                                                        lam)
    rz = np.einsum("bmn,bn->bm", Gf, z) + sv - hf
    score = (np.linalg.norm(rx, axis=-1) + np.linalg.norm(rz, axis=-1)
             + np.abs((sv * lam).sum(-1)))
    assert np.isfinite(score).all()
    assert np.median(score) <= 1e-4, score


def test_escalate_flags_exactly_the_lanes_above_tol():
    """Two planted cond ~1e8 lanes among well-conditioned ones: the mask is
    exactly score > escalate_tol of the solve without escalation, every
    other lane is bit-identical to that solve, and the planted lanes come
    back at the oracle's accuracy."""
    data = _rotated_spectrum(cond_lanes=[1, 5])
    kw = dict(check_Q_spd=False, verbose=-1)
    base = qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                              for v in data),
                            config=qt.SolverConfig(**kw), device="cpu")
    sj, st = _both(data, dict(kw, escalate="oracle"))
    esc = st.stats.escalated.numpy()
    npt.assert_array_equal(esc, base.stats.best_resids.numpy() > 1e-4)
    assert esc[[1, 5]].all()
    npt.assert_array_equal(esc, np.asarray(sj.stats.escalated))
    keep = ~esc
    for name in ("z", "lam", "s"):
        npt.assert_array_equal(getattr(st, name).numpy()[keep],
                               getattr(base, name).numpy()[keep])
        assert not getattr(st.lo, name).numpy()[keep].any()
    npt.assert_array_equal(st.stats.best_resids.numpy()[keep],
                           base.stats.best_resids.numpy()[keep])
    assert (st.stats.best_resids.numpy()[esc] < 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_escalate_noop_on_healthy_batch(dtype):
    """Escalation never perturbs a lane that converged on the device: the
    mask is score > escalate_tol of the solve without it, and every lane
    outside it is bit-identical to that solve (``tests/test_pdipm.py``'s
    fixture). In float64 no lane is flagged, in either package. In float32
    the scores sit at the float32 plateau, below 2e-4 but near
    escalate_tol, in both packages, so whether a lane crosses 1e-4 is
    rounding: at most one lane is flagged here."""
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(7), nz=8,
                                        nineq=5, nbatch=4)
    data = (Q, p, G, h)
    kw = dict(check_Q_spd=False, verbose=-1)
    base = qt.solve_qp_full(*(torch.tensor(v, dtype=dtype) for v in data),
                            config=qt.SolverConfig(**kw), device="cpu")
    sj, st = _both(data, dict(kw, escalate="oracle"), dtype)
    esc = st.stats.escalated.numpy()
    npt.assert_array_equal(esc, base.stats.best_resids.numpy() > 1e-4)
    keep = ~esc
    for name in ("z", "nu", "lam", "s"):
        npt.assert_array_equal(getattr(st, name).numpy()[keep],
                               getattr(base, name).numpy()[keep])
    npt.assert_array_equal(st.stats.best_resids.numpy()[keep],
                           base.stats.best_resids.numpy()[keep])
    if dtype == torch.float64:
        assert not esc.any()
        npt.assert_array_equal(esc, np.asarray(sj.stats.escalated))
        npt.assert_allclose(st.z.numpy(), np.asarray(sj.z), atol=1e-12)
    else:
        assert esc.sum() <= 1
        assert (base.stats.best_resids.numpy() < 2e-4).all()


def test_escalate_rescues_reference_shared_failure():
    """``tests/data_degenerate_eq.npz`` (shared Q at scale ~92, n = 9,
    neq = 3): the float64 loop stalls at a residual ~3.9 in both packages
    (and in upstream qpth), stats say so, and escalation recovers the
    solution on every lane, the JAX package's z to 1e-12."""
    d = np.load(os.path.join(HERE, "data_degenerate_eq.npz"))
    data = tuple(d[k] for k in ("Q", "p", "G", "h", "A", "b"))
    kw = dict(check_Q_spd=False, verbose=-1)
    bj, bt = _both(data, kw, torch.float64)
    assert float(bt.stats.best_resids.max()) > 1.0
    npt.assert_allclose(bt.z.numpy(), np.asarray(bj.z), atol=1e-9)
    sj, st = _both(data, dict(kw, escalate="oracle"), torch.float64)
    assert float(st.stats.best_resids.max()) < 1e-8
    assert bool(st.stats.escalated.all())
    npt.assert_array_equal(st.stats.escalated.numpy(),
                           np.asarray(sj.stats.escalated))
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-12,
                            err_msg=name)
    assert st.lo is not None and not st.lo.z.numpy().any()


def test_refine_and_escalate_together():
    """eps = 1e-8 (auto refinement) with escalation: the refined z is
    float64 and the low words float32, as in the JAX package; escalated
    lanes hold the oracle's float32 hi word in float64 plus their lo word,
    the others the refined float64 answer with lo = 0."""
    data = _rotated_spectrum(B=6, cond_lanes=[2])
    kw = dict(check_Q_spd=False, verbose=-1, eps=1e-8, escalate="oracle")
    sj, st = _both(data, kw)
    assert st.z.dtype == torch.float64 and st.lo.z.dtype == torch.float32
    assert np.asarray(sj.z).dtype == np.float64
    assert np.asarray(sj.lo.z).dtype == np.float32
    esc = st.stats.escalated.numpy()
    assert esc[2]
    npt.assert_array_equal(esc, np.asarray(sj.stats.escalated))
    hi = st.z.numpy()[esc]
    npt.assert_array_equal(hi, np.float64(np.float32(hi)))
    npt.assert_array_equal(_dw(st.z, st.lo.z)[esc],
                           _dw(sj.z, sj.lo.z)[esc])
    assert not st.lo.z.numpy()[~esc].any()
    z64 = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(np.float64(np.float32(v))) for v in data),
        config=qpth_tpu.SolverConfig(check_Q_spd=False, verbose=-1)).z)
    err = (np.linalg.norm(_dw(st.z, st.lo.z) - z64, axis=1)
           / np.linalg.norm(z64, axis=1))
    assert np.median(err) <= 1e-8, err


@pytest.mark.parametrize("neq", [0, 4])
def test_cpu_oracle_forward_backward(neq):
    """``QPSolvers.CPU_ORACLE``: the whole batch on the host in float64,
    returned on the input's device and dtype, 0 iterations and every lane
    converged; the JAX package's (native C++ twin of the same oracle) z to
    1e-9. The backward builds the factors and matches the JAX package's
    gradients to 1e-8."""
    if neq:
        from test_torch_qp_eq import make_eq_problem
        data = make_eq_problem(6, 10, 8, neq, seed=2)
    else:
        data = make_problem(6, 10, 8, seed=2)
    kw = dict(solver=qt.QPSolvers.CPU_ORACLE)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data),
                                config=qpth_tpu.SolverConfig(
                                    solver=qpth_tpu.QPSolvers.CPU_ORACLE))
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu")
    assert int(st.stats.iterations) == 0 and bool(st.stats.converged.all())
    assert st.nu.shape == (6, neq)
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    z64 = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                           config=qt.SolverConfig(eps=1e-9, refine_steps=0),
                           device="cpu").z
    npt.assert_allclose(st.z.numpy(), z64.numpy(), atol=1e-7)

    import jax

    w = np.random.RandomState(4).randn(6, 10)

    def loss(*args):
        return jnp.sum(qpth_tpu.solve_qp(*args, config=qpth_tpu.SolverConfig(
            solver=qpth_tpu.QPSolvers.CPU_ORACLE)) * w)

    gj = jax.grad(loss, argnums=tuple(range(len(data))))(
        *(jnp.asarray(v) for v in data))
    args = [torch.tensor(v, requires_grad=True) for v in data]
    z = qt.solve_qp(*args, config=qt.SolverConfig(**kw), device="cpu")
    (z * torch.tensor(w)).sum().backward()
    for name, a, c in zip("QpGhAb", args, gj):
        c = np.asarray(c)
        npt.assert_allclose(a.grad.numpy(), c, rtol=0,
                            atol=1e-8 * max(1.0, np.abs(c).max()),
                            err_msg=name)
