"""The PyTorch port's diagonal structured tier (``solve_qp_diag``,
``solve_qp_diag_full``) against the JAX package.

Float64 compares like with like: both packages run the same loop, the JAX
package factoring M = A diag(1/H) A^T by XLA's Cholesky and the port by
kernel A's recurrence (its plain version here) with ``inv_solve``. The
differences are rounding: 1e-9 relative on the solution, 1e-8 on
gradients, equal iteration counts.

Float32 runs the same algorithm on both sides: the JAX package with
``use_pallas=True`` (``factor_inv_lanes``, ``inv_solve_lanes`` and, with
``fused_diag_step``, ``diag_step_lanes`` in interpret mode), the port with
its kernels' plain versions, at the reference's own fused-vs-composed
tolerance (atol 2e-4, rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu_torch.core import diag as diag_core
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)


def _diag_qp(rng, n=8, neq=0, nbatch=4, g_sign=-1.0, shared=False):
    """The reference's fixture (tests/test_diag.py): Q = diag(q),
    G = diag(g), feasible at x0."""
    q = 0.5 + rng.rand(nbatch, n)
    g = g_sign * (0.5 + rng.rand(nbatch, n))
    x0 = rng.randn(n)
    if shared:
        q, g = q[0], g[0]
    s0 = rng.rand(nbatch, n)
    h = g * x0 + s0
    p = rng.randn(nbatch, n)
    if neq > 0:
        A = rng.randn(*(((neq, n)) if shared else (nbatch, neq, n)))
        b = A @ x0 if shared else np.einsum("ben,n->be", A, x0)
    else:
        A = b = None
    return q, p, g, h, A, b


def _sudoku(rng, n=64, neq=40, B=8):
    """The sudoku layer's structure at full width: Q = 0.1 I, G = -I,
    h = 0, shared A, b = A x0 at an interior x0 > 0."""
    A = rng.rand(neq, n)
    x0 = rng.rand(B, n) + 0.1
    return (np.full(n, 0.1), -(rng.rand(B, n) < 0.25).astype(float),
            np.full(n, -1.0), np.zeros(n), A, np.einsum("en,bn->be", A, x0))


def _jax(args, dtype=jnp.float64):
    return [None if v is None else jnp.asarray(v, dtype) for v in args]


def _torch(args, dtype=torch.float64):
    return [None if v is None else torch.tensor(v, dtype=dtype)
            for v in args]


def _close(got, want, rtol, err_msg=""):
    """Within rtol of the reference's largest entry, elementwise."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    npt.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                        err_msg=err_msg)


def _match(st, sj, rtol=1e-9):
    for name in ("z", "lam", "s", "nu"):
        _close(getattr(st, name).numpy(), getattr(sj, name), rtol, name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    _close(st.stats.best_resids.numpy(), sj.stats.best_resids, rtol)


CASES = {f"neq{neq}_{'shared' if sh else 'batched'}": (8, neq, 4, sh)
         for neq in (0, 3) for sh in (False, True)}
CASES.update({f"odd_{n}_{neq}_{B}": (n, neq, B, False)
              for n, neq, B in ((1, 0, 1), (2, 1, 3), (9, 8, 2), (16, 7, 5))})


@pytest.mark.parametrize("case", list(CASES))
def test_diag_f64_matches_jax(case):
    n, neq, B, shared = CASES[case]
    args = _diag_qp(np.random.RandomState(3), n=n, neq=neq, nbatch=B,
                    shared=shared)
    sj = qpth_tpu.solve_qp_diag_full(*_jax(args))
    st = qt.solve_qp_diag_full(*_torch(args), device="cpu")
    _match(st, sj)


def test_diag_sudoku_shape_f64_matches_jax():
    args = _sudoku(np.random.RandomState(4))
    sj = qpth_tpu.solve_qp_diag_full(*_jax(args))
    st = qt.solve_qp_diag_full(*_torch(args), device="cpu")
    _match(st, sj)
    assert float(st.stats.best_resids.max()) < 1e-8
    assert float(st.z.min()) > -1e-8          # x >= 0


def test_diag_warm_start_f64_matches_jax():
    args = _diag_qp(np.random.RandomState(5), n=8, neq=2, nbatch=4)
    cold = qpth_tpu.solve_qp_diag_full(*_jax(args))
    init = (cold.z, cold.s, cold.lam, cold.nu)
    moved = list(args)
    moved[1] = args[1] + 0.01
    sj = qpth_tpu.solve_qp_diag_full(*_jax(moved), init=init)
    st = qt.solve_qp_diag_full(
        *_torch(moved), init=tuple(torch.tensor(np.asarray(v))
                                   for v in init), device="cpu")
    _match(st, sj)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_correctors", [0, 2])
def test_diag_f32_matches_jax_kernels(n_correctors, fused):
    """float32, the same algorithm: the JAX package's lanes kernels in
    interpret mode against the port's plain versions of kernels A, 5 and
    (fused) 11."""
    args = _diag_qp(np.random.RandomState(6), n=12, neq=5, nbatch=8,
                    shared=True)
    cj = qpth_tpu.SolverConfig(use_pallas=True, check_Q_spd=False,
                               max_iter=6, n_correctors=n_correctors,
                               fused_diag_step=fused)
    ct = qt.SolverConfig(check_Q_spd=False, max_iter=6,
                         n_correctors=n_correctors, fused_diag_step=fused)
    sj = qpth_tpu.solve_qp_diag_full(*_jax(args, jnp.float32), config=cj)
    st = qt.solve_qp_diag_full(*_torch(args, torch.float32), config=ct,
                               device="cpu")
    assert st.z.dtype == torch.float32
    for name in ("z", "lam", "s", "nu"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=2e-4,
                            rtol=1e-3, err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)


def test_fused_branch_runs_diag_step(monkeypatch):
    """With fused_diag_step, a shared A and a fit, every stepping iteration
    is one diag_step call (iterations - 1 when an exit fires); a batched A
    takes the composed step."""
    calls = []
    orig = kernels.diag_step

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "diag_step", counting)
    args = _diag_qp(np.random.RandomState(6), n=12, neq=5, nbatch=8,
                    shared=True)
    cfg = qt.SolverConfig(fused_diag_step=True)
    sol = qt.solve_qp_diag_full(*_torch(args), config=cfg, device="cpu")
    its = int(sol.stats.iterations)
    assert len(calls) == (its - 1 if its < cfg.max_iter else its) > 0
    calls.clear()
    batched = list(args)
    batched[4] = np.broadcast_to(args[4], (8,) + args[4].shape).copy()
    qt.solve_qp_diag_full(*_torch(batched), config=cfg, device="cpu")
    assert not calls


def test_m_factor_branch_follows_the_fit():
    """M's factor runs in kernel A where M fits a block, in torch.linalg
    beyond (the reference's XLA branch); no equality rows, no M."""
    assert diag_core.use_kernels_m(torch.float32, 40)
    # kernels.fits: 166^2 + 8 * 166 + 8 = 28892 of 29056 float64 words,
    # 167^2 + 8 * 167 + 8 = 29233 beyond.
    assert diag_core.use_kernels_m(torch.float64, 166)
    assert not diag_core.use_kernels_m(torch.float64, 167)
    assert not diag_core.use_kernels_m(torch.float32, 0)
    M = torch.eye(3, dtype=torch.float64).expand(2, 3, 3) * 4.0
    r = torch.ones(2, 3, dtype=torch.float64)
    for use in (True, False):
        fac = diag_core._factor_spd(M, use)
        assert fac[0] == ("inv" if use else "chol")
        npt.assert_allclose(diag_core._m_solve(fac, r).numpy(), 0.25)


def _loss_jax(w, cfg):
    def loss(*a):
        return jnp.sum(qpth_tpu.solve_qp_diag(*a, config=cfg) * w)
    return loss


GRAD_CASES = {
    "batched_neq0": dict(neq=0, shared=False),
    "batched_neq3": dict(neq=3, shared=False),
    "shared_sum": dict(neq=3, shared=True, mode="sum"),
    "shared_mean": dict(neq=3, shared=True, mode="mean"),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_diag_grads_f64_match_jax(case):
    """Gradients to q, p, g, h, A, b against jax.grad: batched parameters,
    and unbatched q, g, A, b (summed or averaged cotangents; the shared
    A's gradient summed over the batch)."""
    spec = GRAD_CASES[case]
    rng = np.random.RandomState(8)
    args = _diag_qp(rng, n=6, neq=spec["neq"], nbatch=3,
                    shared=spec["shared"])
    w = rng.randn(3, 6)
    mode = spec.get("mode", "sum")
    argn = tuple(range(6 if spec["neq"] else 4))
    gj = jax.grad(_loss_jax(w, qpth_tpu.SolverConfig(
        broadcast_grad_reduction=mode)), argnums=argn)(*_jax(args))
    tt = [torch.tensor(v, requires_grad=True) for v in args[:len(argn)]]
    z = qt.solve_qp_diag(*tt, *([None, None] if len(argn) == 4 else []),
                         config=qt.SolverConfig(
                             broadcast_grad_reduction=mode), device="cpu")
    (z * torch.tensor(w)).sum().backward()
    for name, a, g in zip("qpghAb", tt, gj):
        assert a.grad.shape == a.shape, name
        _close(a.grad.numpy(), g, 1e-8, name)


def test_no_equality_rows_is_elementwise():
    """neq = 0: no M (so no kernel); the solution satisfies the KKT
    conditions."""
    assert not diag_core.use_kernels_m(torch.float32, 0)
    assert not kernels.diag_step_fits(7, 0, torch.float32)
    q, p, g, h, _, _ = _diag_qp(np.random.RandomState(9), n=7, neq=0,
                                nbatch=5)
    sol = qt.solve_qp_diag_full(*_torch((q, p, g, h)), device="cpu")
    assert sol.nu.shape == (5, 0)
    z, lam, s = (v.numpy() for v in (sol.z, sol.lam, sol.s))
    npt.assert_allclose(q * z + p + g * lam, 0, atol=1e-8)
    npt.assert_allclose(g * z + s - h, 0, atol=1e-8)
