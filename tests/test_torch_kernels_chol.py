"""The port's Cholesky kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) on the same draws: kernel C
(``kernels.chol``: ``cholesky_t_pallas``, ``factor_kkt_t_pallas``,
``factor_kkt_lanes``, ``factor_solve_kkt_lanes``), kernel D
(``kernels.cho_solve``: ``cho_solve_vec_t_pallas``, ``cho_solve_lanes``)
and kernel E (``kernels.trinv``: ``trinv_pallas``, ``spd_inverse``),
through ``qpth_tpu_torch/ops/cholesky.py``, the functions the port names
after them.

float32 to the JAX package's own kernel tolerances (5e-5 on factors, 2e-4
absolute / 1e-3 relative on solves); float64 against numpy to 1e-12."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.cholesky import (cho_solve_vec_t_pallas,
                                          cholesky_t_pallas,
                                          factor_kkt_t_pallas, spd_inverse,
                                          trinv_pallas)
from qpth_tpu.ops.pallas.lanes import (cho_solve_lanes, factor_kkt_lanes,
                                       factor_solve_kkt_lanes,
                                       pad_spd_lanes)
from qpth_tpu_torch.ops import cholesky as chol_ops
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)


def _spd(rng, B, n, dtype=np.float32):
    L0 = rng.rand(B, n, n).astype(dtype)
    return L0 @ L0.transpose(0, 2, 1) + 5 * np.eye(n, dtype=dtype)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("B,n", [(16, 16), (8, 24), (4, 7), (2, 1)])
def test_cholesky_t_matches_pallas(rng, B, n):
    A = _spd(rng, B, n)
    want = np.asarray(cholesky_t_pallas(jnp.asarray(A), interpret=True))
    got = chol_ops.cholesky_t(_t(A)).numpy()
    npt.assert_allclose(got, want, atol=5e-5)
    # Exact zeros below the diagonal, as the Pallas kernel writes them.
    assert not np.tril(got, -1).any() and not np.tril(want, -1).any()
    npt.assert_array_equal(chol_ops.cholesky(_t(A)).numpy(),
                           got.transpose(0, 2, 1))


@pytest.mark.parametrize("shared", [False, True])
def test_factor_kkt_t_matches_pallas(rng, shared):
    B, n = 6, 12
    A = _spd(rng, 1 if shared else B, n)
    d = rng.rand(B, n).astype(np.float32) + 0.5
    want = factor_kkt_t_pallas(jnp.asarray(A), jnp.asarray(d),
                               interpret=True)
    got = chol_ops.factor_kkt_t(_t(A), _t(d))
    npt.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_cho_solve_vec_t_matches_pallas(rng, shared):
    B, n = 6, 16
    A = _spd(rng, 1 if shared else B, n)
    Lt = np.linalg.cholesky(A).transpose(0, 2, 1).copy()
    v = rng.randn(B, n).astype(np.float32)
    want = cho_solve_vec_t_pallas(jnp.asarray(Lt), jnp.asarray(v),
                                  interpret=True)
    got = chol_ops.cho_solve_vec_t(_t(Lt), _t(v))
    npt.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    # The lower layout of the cached Q / S11 factors: the same solve.
    low = kernels.cho_solve(_t(Lt.transpose(0, 2, 1).copy()), _t(v),
                            lower=True)
    npt.assert_array_equal(low.numpy(), got.numpy())


def test_trinv_and_spd_inverse_match_pallas(rng):
    B, n = 4, 20
    A = _spd(rng, B, n)
    Lt = np.linalg.cholesky(A).transpose(0, 2, 1).copy()
    want = np.asarray(trinv_pallas(jnp.asarray(Lt), interpret=True))
    got = chol_ops.trinv(_t(Lt)).numpy()
    npt.assert_allclose(got, want, atol=1e-5)
    assert not np.triu(got, 1).any()
    want = np.asarray(spd_inverse(jnp.asarray(A), interpret=True))
    npt.assert_allclose(chol_ops.spd_inverse(_t(A)).numpy(), want,
                        atol=1e-5)


def _lanes_problem(rng, B, n):
    L0 = rng.rand(B, n, n).astype(np.float32)
    R = L0 @ L0.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    dinv = (rng.rand(B, n) + 0.5).astype(np.float32)
    v = rng.randn(B, n).astype(np.float32)
    R_t = pad_spd_lanes(jnp.asarray(R.transpose(1, 2, 0)))
    return R, dinv, v, R_t


@pytest.mark.parametrize("B,n", [(8, 8), (4, 7), (8, 13)])
def test_lanes_factor_and_solves_match_pallas(rng, B, n):
    """The lanes kernels' layout (m_p, m_p, B), converted as
    tests/test_lanes_kernels.py does, against the port's batch-major
    functions."""
    R, dinv, v, R_t = _lanes_problem(rng, B, n)
    dinv_t, v_t = jnp.asarray(dinv.T), jnp.asarray(v.T)
    Lt_lanes = factor_kkt_lanes(R_t, dinv_t, interpret=True)
    want = np.triu(np.asarray(Lt_lanes).transpose(2, 0, 1)[:, :n, :n])
    got = chol_ops.factor_kkt(_t(R), _t(dinv))
    npt.assert_allclose(got.numpy(), want, atol=5e-5)

    Lt2, x_t = factor_solve_kkt_lanes(R_t, dinv_t, v_t, interpret=True)
    Lg, xg = chol_ops.factor_solve_kkt(_t(R), _t(dinv), _t(v))
    npt.assert_allclose(
        Lg.numpy(), np.triu(np.asarray(Lt2).transpose(2, 0, 1)[:, :n, :n]),
        atol=5e-5)
    npt.assert_allclose(xg.numpy(), np.asarray(x_t).T, atol=2e-4, rtol=1e-3)
    npt.assert_array_equal(Lg.numpy(), got.numpy())

    x_l = np.asarray(cho_solve_lanes(Lt_lanes, v_t, interpret=True)).T
    npt.assert_allclose(chol_ops.cho_solve(got, _t(v)).numpy(), x_l,
                        atol=2e-4, rtol=1e-3)


def test_non_spd_lane_yields_nan_alone(rng):
    """A lane that is not SPD comes back NaN in kernel C's factor and its
    first solve, and no other lane does (the Pallas kernel's behaviour)."""
    B, n = 4, 8
    A = _spd(rng, B, n)
    A[2] = -np.eye(n, dtype=np.float32)
    want = np.isnan(np.asarray(cholesky_t_pallas(jnp.asarray(A),
                                                 interpret=True))).any((1, 2))
    Lt, x = kernels.chol(_t(A), None, _t(rng.randn(B, n).astype(np.float32)))
    bad = torch.isnan(Lt).any(dim=(1, 2)).numpy()
    npt.assert_array_equal(bad, want)
    npt.assert_array_equal(bad, [False, False, True, False])
    npt.assert_array_equal(torch.isnan(x).any(dim=1).numpy(), bad)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", [1, 9, 23])
def test_f64_against_numpy(rng, n, shared):
    B = 5
    R = _spd(rng, 1 if shared else B, n, np.float64)
    dinv = rng.rand(B, n) + 0.5
    v = rng.randn(B, n)
    T = R + np.stack([np.diag(x) for x in dinv])
    L = np.linalg.cholesky(T)
    Lt, x = kernels.chol(_t(R), _t(dinv), _t(v))
    npt.assert_allclose(Lt.numpy(), L.transpose(0, 2, 1), atol=1e-12)
    xr = np.linalg.solve(T, v[..., None])[..., 0]
    npt.assert_allclose(x.numpy(), xr, atol=1e-12)
    npt.assert_allclose(kernels.chol(_t(R)).numpy(),
                        np.linalg.cholesky(R).transpose(0, 2, 1), atol=1e-12)
    # Kernel D on a shared factor: the OptNet pattern's L_Q.
    Lr = np.linalg.cholesky(R)
    xs = kernels.cho_solve(_t(Lr.transpose(0, 2, 1).copy()), _t(v))
    npt.assert_allclose(xs.numpy(), np.linalg.solve(
        np.broadcast_to(R, (B, n, n)), v[..., None])[..., 0], atol=1e-12)
    npt.assert_allclose(kernels.trinv(Lt).numpy(), np.linalg.inv(L),
                        atol=1e-12)


def test_wrappers_count_no_launch_on_cpu(rng):
    kernels.reset_launches()
    A = torch.tensor(_spd(rng, 3, 5, np.float64))
    Lt = kernels.chol(A, torch.ones(3, 5, dtype=torch.float64),
                      torch.ones(3, 5, dtype=torch.float64))[0]
    kernels.cho_solve(Lt, torch.ones(3, 5, dtype=torch.float64))
    kernels.trinv(Lt)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_chol_fit_predicate():
    """One m x m tile and 4 m-vectors within 227 KB of shared memory."""
    assert kernels.chol_fits(239, torch.float32)
    assert not kernels.chol_fits(240, torch.float32)
    assert kernels.chol_fits(168, torch.float64)
    assert not kernels.chol_fits(169, torch.float64)
