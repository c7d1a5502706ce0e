"""The PyTorch port's foundation modules against the JAX package's:
``utils.py``, ``ops/linalg.py`` and ``scaling.py`` (Ruiz scalings with and
without the probe, batched and shared), on the same float64 inputs."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu import scaling as jscaling
from qpth_tpu import utils as jutils
from qpth_tpu.ops import linalg as jlinalg
from qpth_tpu_torch import scaling as tscaling
from qpth_tpu_torch import utils as tutils
from qpth_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)


def _spd(rng, b, n):
    L = rng.rand(b, n, n)
    return L @ L.transpose(0, 2, 1) + np.eye(n)


@pytest.mark.parametrize("bM", [1, 6], ids=["shared", "batched"])
def test_linalg_matches_jax(bM):
    rng = np.random.RandomState(bM)
    M = rng.randn(bM, 5, 4)
    v, w = rng.randn(6, 4), rng.randn(6, 5)
    S = _spd(rng, bM, 5)
    d = rng.rand(6, 5) + 0.5
    tM, tS = torch.tensor(M), torch.tensor(S)
    npt.assert_allclose(tlinalg.bmv(tM, torch.tensor(v)).numpy(),
                        np.asarray(jlinalg.bmv(M, v)), atol=1e-13)
    npt.assert_allclose(tlinalg.btmv(tM, torch.tensor(w)).numpy(),
                        np.asarray(jlinalg.btmv(M, w)), atol=1e-13)
    npt.assert_allclose(tlinalg.add_diag(tS, torch.tensor(d)).numpy(),
                        np.asarray(jlinalg.add_diag(S, d)), atol=0)
    L = tlinalg.cholesky(tS)
    npt.assert_allclose(L.numpy(), np.asarray(jlinalg.cholesky(S)),
                        atol=1e-12)
    npt.assert_allclose(
        tlinalg.cho_solve_vec(L, torch.tensor(w)).numpy(),
        np.asarray(jlinalg.cho_solve_vec(jlinalg.cholesky(S), w)),
        atol=1e-12)


def test_cholesky_nan_lane_and_spd_check():
    rng = np.random.RandomState(0)
    S = _spd(rng, 4, 5)
    S[2] = -S[2]
    L = tlinalg.cholesky(torch.tensor(S)).numpy()
    assert np.isnan(L[2]).any() and not np.isnan(L[[0, 1, 3]]).any()
    npt.assert_allclose(L, np.asarray(jlinalg.cholesky(S)), atol=1e-12)
    with pytest.raises(RuntimeError, match="not SPD"):
        tlinalg.spd_check_eager(torch.tensor(S))
    tlinalg.spd_check_eager(torch.tensor(np.delete(S, 2, axis=0)))


def test_utils_match_jax():
    rng = np.random.RandomState(1)
    x, y = rng.randn(3, 4), rng.randn(3, 5)
    npt.assert_array_equal(tutils.bger(torch.tensor(x), torch.tensor(y)),
                           np.asarray(jutils.bger(x, y)))
    npt.assert_array_equal(tutils.bdiag(torch.tensor(x)),
                           np.asarray(jutils.bdiag(x)))
    Q, p, G = torch.ones(4, 4), torch.ones(7, 4), torch.ones(3, 4)
    assert tutils.extract_nbatch(Q, p, G, None, None, None) == 7
    assert tutils.extract_nbatch(Q, p[0], G, None, None, None) == 1
    assert tutils.as_batched(Q, 3)[0].shape == (1, 4, 4)
    assert tutils.as_batched(Q, 3)[1] is True
    with pytest.raises(ValueError):
        tutils.as_batched(torch.ones(2, 2, 2, 2), 3)
    assert tutils.normalize_constraints(torch.zeros(0, 4), None) == (None,
                                                                     None)


@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("case", ["well_scaled", "badly_scaled", "shared"])
def test_ruiz_scalings_match_jax(case, probe):
    """Same scalings and the same probe branch as the JAX package."""
    rng = np.random.RandomState(3)
    b = 1 if case == "shared" else 5
    Q = _spd(rng, b, 6)
    G = rng.randn(5, 4, 6)
    if case == "badly_scaled":
        G = G * np.array([1e4, 1.0, 1e-3, 1.0])[:, None]
        Q = Q * 1e3
    sj, okj = jscaling.ruiz_scalings(jnp.asarray(Q), jnp.asarray(G),
                                     probe=probe, return_ok=True)
    st, okt = tscaling.ruiz_scalings(torch.tensor(Q), torch.tensor(G),
                                     probe=probe)
    assert okt == (None if okj is None else bool(okj))
    if probe:
        assert okt == (case != "badly_scaled")
    for k in ("E", "RG", "c"):
        npt.assert_array_equal(getattr(st, k).numpy(),
                               np.asarray(getattr(sj, k)), err_msg=k)
    npt.assert_array_equal(tscaling.scale_Q(torch.tensor(Q), st).numpy(),
                           np.asarray(jscaling.scale_Q(Q, sj)))
    npt.assert_array_equal(tscaling.scale_G(torch.tensor(G), st).numpy(),
                           np.asarray(jscaling.scale_G(G, sj)))


@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("case", ["well_scaled", "badly_scaled",
                                  "shared_A"])
def test_ruiz_scalings_with_equalities_match_jax(case, probe):
    """With A: the equality row scaling R_A, A's columns in the variable
    scaling, A's row norms in the probe; then the vector and point maps."""
    rng = np.random.RandomState(4)
    Q, G = _spd(rng, 5, 6), rng.randn(5, 4, 6)
    A = rng.randn(1 if case == "shared_A" else 5, 3, 6)
    if case == "badly_scaled":
        A = A * np.array([1e4, 1.0, 1e-3])[:, None]
    sj, okj = jscaling.ruiz_scalings(jnp.asarray(Q), jnp.asarray(G),
                                     jnp.asarray(A), probe=probe,
                                     return_ok=True)
    st, okt = tscaling.ruiz_scalings(torch.tensor(Q), torch.tensor(G),
                                     torch.tensor(A), probe=probe)
    assert okt == (None if okj is None else bool(okj))
    if probe:
        assert okt == (case != "badly_scaled")
    for k in ("E", "RG", "RA", "c"):
        npt.assert_array_equal(getattr(st, k).numpy(),
                               np.asarray(getattr(sj, k)), err_msg=k)
    npt.assert_array_equal(tscaling.scale_A(torch.tensor(A), st).numpy(),
                           np.asarray(jscaling.scale_A(A, sj)))
    assert tscaling.scale_A(None, st) is None
    ident = tscaling.identity_like(st)
    assert bool((ident.RA == 1).all()) and ident.RA.shape == st.RA.shape

    p, h, b = rng.randn(5, 6), rng.randn(5, 4), rng.randn(5, 3)
    for got, want in zip(
            tscaling.scale_vecs(*(torch.tensor(v) for v in (p, h, b)), st),
            jscaling.scale_vecs(p, h, b, sj)):
        npt.assert_array_equal(got.numpy(), np.asarray(want))
    assert tscaling.scale_vecs(torch.tensor(p), torch.tensor(h), None,
                               st)[2] is None
    pt = (rng.randn(5, 6), rng.rand(5, 4), rng.rand(5, 4), rng.randn(5, 3))
    for got, want in zip(
            tscaling.scale_point(*(torch.tensor(v) for v in pt), st),
            jscaling.scale_point(*pt, sj)):
        npt.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bL", [1, 6], ids=["shared", "batched"])
def test_cho_solve_matches_jax(bL):
    """Cholesky solves with matrix and vector right-hand sides; a shared
    factor folds the batch into the columns of one solve."""
    rng = np.random.RandomState(bL)
    M = _spd(rng, bL, 5)
    rhs, v = rng.randn(6, 5, 3), rng.randn(6, 5)
    Lj, Lt = jlinalg.cholesky(jnp.asarray(M)), tlinalg.cholesky(
        torch.tensor(M))
    npt.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-13)
    npt.assert_allclose(tlinalg.cho_solve(Lt, torch.tensor(rhs)).numpy(),
                        np.asarray(jlinalg.cho_solve(Lj, jnp.asarray(rhs))),
                        atol=1e-12)
    npt.assert_allclose(tlinalg.cho_solve_vec(Lt, torch.tensor(v)).numpy(),
                        np.asarray(jlinalg.cho_solve_vec(Lj,
                                                         jnp.asarray(v))),
                        atol=1e-12)
    # one shared right-hand side against batched factors broadcasts
    if bL > 1:
        one = tlinalg.cho_solve(Lt, torch.tensor(rhs[:1]))
        assert one.shape == (6, 5, 3)
