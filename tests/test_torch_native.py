"""The port's native C++ oracle (``qpth_tpu_torch.native``): its own copy
of the source, built on first use, against the port's numpy oracle, the
JAX package's native oracle, and through ``QPSolvers.CPU_ORACLE``."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu import native as jax_native
from qpth_tpu_torch import native
from qpth_tpu_torch.solvers.oracle import solve_qp_batch_np

from conftest import make_feasible_qp

pytestmark = pytest.mark.skipif(not native.is_available(),
                                reason="no C++ toolchain")


@pytest.mark.parametrize("neq", [0, 3])
def test_native_matches_numpy(rng, neq):
    Q, p, G, h, A, b = make_feasible_qp(rng, nz=10, nineq=6, neq=neq,
                                        nbatch=4)
    out_n = native.solve_qp_batch_native(Q, p, G, h, A, b)
    out_p = solve_qp_batch_np(Q, p, G, h, A, b)
    for got, want in zip(out_n, out_p):
        npt.assert_allclose(got, np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("neq", [0, 3])
def test_native_matches_the_jax_packages(rng, neq):
    """Bit for bit against ``qpth_tpu.native`` where both libraries come
    from the same compiler and flags (the first ones both try), else to
    1e-12."""
    if not jax_native.is_available():
        pytest.skip("the JAX package's native oracle did not build")
    Q, p, G, h, A, b = make_feasible_qp(rng, nz=10, nineq=6, neq=neq,
                                        nbatch=4)
    got = native.solve_qp_batch_native(Q, p, G, h, A, b,
                                       return_status=True)
    want = jax_native.solve_qp_batch_native(Q, p, G, h, A, b,
                                            return_status=True)
    same = native.built_with == ("g++", native.FLAG_SETS[0])
    for g, w in zip(got, want):
        if same:
            npt.assert_array_equal(g, w)
        else:
            npt.assert_allclose(g, w, atol=1e-12)


def _poison_lane(G, h, lane):
    """One lane's constraints contradictory: x0 <= -1 and -x0 <= -1."""
    G, h = np.array(G, copy=True), np.array(h, copy=True)
    G[lane, :2, :] = 0.0
    G[lane, 0, 0], G[lane, 1, 0] = 1.0, -1.0
    h[lane, :2] = -1.0
    return G, h


def test_per_lane_failure_isolation(rng):
    """One infeasible lane of 8: flagged and NaN-filled or unconverged, the
    other 7 solved as in a batch without it."""
    B, lane = 8, 3
    Q, p, G, h, _, _ = make_feasible_qp(rng, nz=6, nineq=4, nbatch=B)
    Gp, hp = _poison_lane(G, h, lane)
    x, nu, lam, s, status = native.solve_qp_batch_native(
        Q, p, Gp, hp, return_status=True)
    assert status[lane] != 0
    good = [i for i in range(B) if i != lane]
    assert all(status[i] == 0 for i in good)
    x_ref, _, _, _ = solve_qp_batch_np(Q, p, G, h)
    npt.assert_allclose(x[good], x_ref[good], atol=1e-8)
    assert np.isfinite(x[good]).all()
    if status[lane] == -1:
        assert np.isnan(x[lane]).all()


def test_native_shared_matrices(rng):
    """Batch-1 (shared) matrices with full-batch vectors."""
    Q, p, G, h, A, b = make_feasible_qp(rng, nz=8, nineq=5, neq=2)
    B = 3
    P = rng.randn(B, 8)
    bb = np.broadcast_to(b, (B, 2))
    got = native.solve_qp_batch_native(Q, P, G, h, A, bb)
    want = solve_qp_batch_np(Q, P, G, h, A, bb)
    for g, w in zip(got, want):
        npt.assert_allclose(g, np.asarray(w), atol=1e-9)


@pytest.mark.parametrize("neq", [0, 2])
def test_cpu_oracle_uses_native_and_matches_jax(rng, neq, monkeypatch):
    """``QPSolvers.CPU_ORACLE`` through the port runs the native oracle
    (the numpy copy is not called) and matches the JAX package's
    ``CPU_ORACLE`` to 1e-9."""
    import qpth_tpu_torch.solvers.oracle as oracle_mod

    Q, p, G, h, A, b = make_feasible_qp(rng, nz=8, nineq=5, neq=neq,
                                        nbatch=4)
    arrs = (Q, p, G, h, A, b)

    def refuse(*a, **k):
        raise AssertionError("the numpy oracle ran")

    monkeypatch.setattr(oracle_mod, "solve_qp_batch_np", refuse)
    cfg = qt.SolverConfig(solver=qt.QPSolvers.CPU_ORACLE)
    sol = qt.solve_qp_full(*(None if a is None else torch.tensor(a)
                             for a in arrs), config=cfg, device="cpu")
    want = qpth_tpu.solve_qp_full(
        *(None if a is None else jnp.asarray(a) for a in arrs),
        config=qpth_tpu.SolverConfig(solver=qpth_tpu.QPSolvers.CPU_ORACLE))
    npt.assert_allclose(sol.z.numpy(), np.asarray(want.z), atol=1e-9)
    npt.assert_allclose(sol.lam.numpy(), np.asarray(want.lam), atol=1e-9)
    if neq:
        npt.assert_allclose(sol.nu.numpy(), np.asarray(want.nu), atol=1e-9)


def test_cpu_oracle_failed_lane_is_the_jax_packages():
    """A conditioning-limited lane (cond(Q) ~ 1e8): the native oracle
    reports a numerical failure and NaN-fills it, in the port's
    ``CPU_ORACLE`` as in the JAX package's; the other lanes match to 1e-9.
    (The numpy copy returns a best-effort iterate there.)"""
    r = np.random.RandomState(3)
    B, n, m = 8, 20, 18
    L = r.rand(B, n, n)
    Q = L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(n)
    G = r.randn(B, m, n)
    h = np.einsum("bmn,bn->bm", G, r.randn(B, n)) + r.rand(B, m)
    p = r.randn(B, n)
    U, _ = np.linalg.qr(np.random.RandomState(7).randn(n, n))
    Q[2] = (U * np.logspace(0, -8, n)) @ U.T + 1e-9 * np.eye(n)
    _, _, _, _, status = native.solve_qp_batch_native(Q, p, G, h,
                                                      return_status=True)
    assert status[2] == -1 and (np.delete(status, 2) == 0).all()
    cfg = qt.SolverConfig(solver=qt.QPSolvers.CPU_ORACLE, check_Q_spd=False)
    z = qt.solve_qp_full(*(torch.tensor(a) for a in (Q, p, G, h)),
                         config=cfg, device="cpu").z.numpy()
    want = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(a) for a in (Q, p, G, h)),
        config=qpth_tpu.SolverConfig(solver=qpth_tpu.QPSolvers.CPU_ORACLE,
                                     check_Q_spd=False)).z)
    assert np.isnan(z[2]).all() and np.isnan(want[2]).all()
    npt.assert_allclose(np.delete(z, 2, 0), np.delete(want, 2, 0),
                        atol=1e-9)


def test_escalation_keeps_the_numpy_oracle(monkeypatch):
    """Escalation solves on the numpy copy (``solve_qp_np``), as the JAX
    package's does; the native library is not called."""
    def refuse(*a, **k):
        raise AssertionError("the native oracle ran")

    monkeypatch.setattr(native, "solve_qp_batch_native", refuse)
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(1), nz=6,
                                        nineq=4, nbatch=4)
    cfg = qt.SolverConfig(escalate="oracle", escalate_tol=0.0)
    sol = qt.solve_qp_full(*(torch.tensor(a) for a in (Q, p, G, h)),
                           config=cfg, device="cpu")
    assert bool(sol.stats.escalated.all())
    assert bool(torch.isfinite(sol.z).all())


def test_build_is_atomic_and_named_by_hash():
    """The library lives under build/qpth_tpu_torch/, named after a hash of
    its source and flags, and no temporary file is left beside it."""
    assert native.is_available()
    cxx, flags = native.built_with
    path = native._lib_path(cxx, flags)
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libqp_oracle_")
    assert not list(native.BUILD_DIR.glob("libqp_oracle_*.tmp"))
