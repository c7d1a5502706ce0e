"""The hybrid blocked path (``qpth_tpu_torch/ops/hybrid.py``: kernel A on
the diagonal blocks, batched GEMMs for the panels, the trailing updates and
the substitutions) against the JAX package's ``qpth_tpu.ops.hybrid``, and
its routing in ``ops/kkt.py``.

* The blocked functions at block = 16 and m in {16, 40, 57} (one block,
  several, a partial last block), float64, to 1e-9 against the JAX
  functions (``interpret=True``, as ``tests/test_hybrid.py`` calls them).
  On CPU tensors kernel A's plain version factors the diagonal blocks.
* The ``facQ`` prefactor (Q's blocked factor in place of Q^-1) against the
  explicit-inverse one, and ``factors_from_numpy`` with the JAX package's
  ``facQ``.
* ``use_pallas="hybrid"`` end to end against the JAX package's: float64 to
  1e-9 with equal iterations, float32 to the JAX package's own hybrid
  tolerance (``tests/test_hybrid.py``: atol 5e-4, rtol 1e-3).
* Routing past kernel A's fit, on the CPU, with ``kkt.past_fit`` patched to
  a small m (the fit is a CUDA fact; the plain versions take any size):
  "auto" takes the hybrid backend, ``_q_rep`` returns ``facQ``, refinement
  solves through ``factor_solve_hybrid``; "blocked" past kernel C's fit
  still raises, and "hybrid_xla" runs the hybrid backend.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.ops import hybrid as jax_hybrid
from qpth_tpu_torch.ops import hybrid
from qpth_tpu_torch.ops import kkt as kkt_ops

from conftest import make_feasible_qp
from test_torch_qp import _jax_factors_as_numpy, make_problem

torch.set_num_threads(1)

BLOCK = 16
M_SIZES = [16, 40, 57]


def _spd(m, B=3, seed=0):
    r = np.random.RandomState(seed + m)
    X = r.randn(B, m, m)
    return X @ X.transpose(0, 2, 1) + m * np.eye(m), r


def _close(got, want, tol=1e-9):
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                        atol=tol)


def _same_factor(fac, jfac):
    assert (fac.m, fac.block) == (jfac.m, jfac.block)
    assert len(fac.Gs) == len(jfac.Gs)
    for G, jG in zip(fac.Gs, jfac.Gs):
        _close(G, jG)
    for P, jP in zip(fac.Ps, jfac.Ps):
        assert (P is None) == (jP is None)
        if P is not None:
            _close(P, jP)


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "dinv"])
@pytest.mark.parametrize("m", M_SIZES)
def test_factor_and_factor_solve_match_jax(m, shift):
    T, r = _spd(m)
    v = r.randn(3, m)
    dinv = r.rand(3, m) + 0.1 if shift else None
    tdinv = torch.tensor(dinv) if shift else None
    jdinv = jnp.asarray(dinv) if shift else None
    fac = hybrid.factor_hybrid(torch.tensor(T), block=BLOCK, dinv=tdinv)
    jfac = jax_hybrid.factor_hybrid(jnp.asarray(T), interpret=True,
                                    block=BLOCK, dinv=jdinv)
    _same_factor(fac, jfac)
    fac2, x = hybrid.factor_solve_hybrid(torch.tensor(T), torch.tensor(v),
                                         block=BLOCK, dinv=tdinv)
    jfac2, jx = jax_hybrid.factor_solve_hybrid(
        jnp.asarray(T), jnp.asarray(v), interpret=True, block=BLOCK,
        dinv=jdinv)
    _same_factor(fac2, jfac2)
    _close(x, jx)
    want = np.linalg.solve(T + (np.apply_along_axis(np.diag, 1, dinv)
                                if shift else 0.0), v[..., None])[..., 0]
    _close(x, want)


@pytest.mark.parametrize("m", M_SIZES)
def test_solves_and_inverse_match_jax(m):
    T, r = _spd(m)
    v, V = r.randn(3, m), r.randn(3, m, 7)
    fac = hybrid.factor_hybrid(torch.tensor(T), block=BLOCK)
    jfac = jax_hybrid.factor_hybrid(jnp.asarray(T), interpret=True,
                                    block=BLOCK)
    _close(hybrid.solve_hybrid(fac, torch.tensor(v)),
           jax_hybrid.solve_hybrid(jfac, jnp.asarray(v)))
    _close(hybrid.solve_hybrid_mat(fac, torch.tensor(V)),
           jax_hybrid.solve_hybrid_mat(jfac, jnp.asarray(V)))
    _close(hybrid.spd_inv_hybrid(torch.tensor(T), block=BLOCK),
           jax_hybrid.spd_inv_hybrid(jnp.asarray(T), interpret=True,
                                     block=BLOCK))


def test_shared_matrix_with_batched_shift():
    """T of batch 1 (a shared R) with a per-lane shift: the same factor as
    the expanded T, and T itself is left as it was."""
    T, r = _spd(40, B=1)
    dinv = r.rand(4, 40) + 0.1
    Tt, v = torch.tensor(T), torch.ones(4, 40, dtype=torch.float64)
    keep = Tt.clone()
    fac1, x1 = hybrid.factor_solve_hybrid(Tt, v, block=BLOCK,
                                          dinv=torch.tensor(dinv))
    facB, xB = hybrid.factor_solve_hybrid(Tt.expand(4, 40, 40), v,
                                          block=BLOCK,
                                          dinv=torch.tensor(dinv))
    _close(x1, xB, 1e-12)
    for a, b in zip(fac1.Gs + fac1.Ps[:-1], facB.Gs + facB.Ps[:-1]):
        _close(a, b, 1e-12)
    assert torch.equal(Tt, keep)


def _eq_data(nz=45, m=40, neq=6, B=3, seed=3):
    Q, p, G, h, A, b = make_feasible_qp(np.random.RandomState(seed), nz=nz,
                                        nineq=m, neq=neq, nbatch=B)
    Q = np.broadcast_to(Q + 0.1 * nz * np.eye(nz), (B, nz, nz)).copy()
    return Q, p, G, h, A, b


@pytest.fixture
def small_fit(monkeypatch):
    """Kernel A's fit moved to m <= 30 and applied on the CPU, blocks of
    BLOCK columns."""
    monkeypatch.setattr(kkt_ops, "past_fit", lambda n, dt, dev: n > 30)
    monkeypatch.setattr(hybrid, "BLOCK", BLOCK)


def test_facq_prefactor_matches_explicit_inverse(small_fit):
    """``tests/test_hybrid.py``'s case on the port: Q's blocked factor and
    its substitution-built products against the explicit inverse's, and
    the facQ products against the JAX package's."""
    Q, p, G, h, A, b = _eq_data()
    Qt, Gt, At = (torch.tensor(v) for v in (Q, G, A))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kkt_ops, "past_fit", lambda n, dt, dev: False)
        ref = kkt_ops.pre_factor_kkt(Qt, Gt, At, inverse=True)
    assert ref.invQ is not None and ref.facQ is None
    got = kkt_ops.pre_factor_kkt(Qt, Gt, At, inverse=True)
    assert got.invQ is None and isinstance(got.facQ, hybrid.HybridFactor)
    for k in ("R", "invQ_GT", "invQ_AT", "GiGT", "S11", "S21", "W",
              "invS11"):
        _close(getattr(got, k), getattr(ref, k), 1e-8)
    v = torch.tensor(np.random.RandomState(4).randn(3, 45))
    _close(kkt_ops.apply_invQ(got, v), kkt_ops.apply_invQ(ref, v), 1e-8)

    jfacQ = jax_hybrid.factor_hybrid(jnp.asarray(Q), interpret=True,
                                     block=BLOCK)
    assert len(jfacQ.Gs) == 3
    _same_factor(got.facQ, jfacQ)
    _close(got.invQ_GT, jax_hybrid.solve_hybrid_mat(
        jfacQ, jnp.swapaxes(jnp.asarray(G), -1, -2)))


def test_factors_from_numpy_takes_jax_facq():
    """The JAX package's KKTFactors in its hybrid regime (facQ in place of
    invQ), carried over as numpy: a port ``HybridFactor`` whose solve equals
    the port's own."""
    Q, p, G, h, A, b = _eq_data()
    cj = qpth_tpu.SolverConfig(solve_method="inverse", resid_every=7)
    fj = qpth_tpu.prefactor_qp(jnp.asarray(Q), jnp.asarray(G),
                               jnp.asarray(A), config=cj)
    jfacQ = jax_hybrid.factor_hybrid(jnp.asarray(Q), interpret=True,
                                     block=BLOCK)
    arrays = _jax_factors_as_numpy(fj._replace(invQ=None))
    arrays["facQ"] = dict(
        Gs=[np.array(g) for g in jfacQ.Gs],
        Ps=[None if P is None else np.array(P) for P in jfacQ.Ps],
        m=jfacQ.m, block=jfacQ.block)
    carried = qt.factors_from_numpy(arrays, "cpu")
    assert carried.invQ is None
    _same_factor(carried.facQ, jfacQ)
    ct = qt.SolverConfig(solve_method="inverse", resid_every=7)
    args = [torch.tensor(v) for v in (Q, p, G, h, A, b)]
    own = qt.solve_qp_full(*args, config=ct, device="cpu")
    got = qt.solve_qp_full(*args, config=ct, factors=carried, device="cpu")
    _close(got.z, own.z)
    assert int(got.stats.iterations) == int(own.stats.iterations)


def _hybrid_data(dtype):
    """``tests/test_hybrid.py``'s solver case: nz = 60, nineq = 150 (the
    default blocks and a partial one), B = 2, Q tempered by 0.1 nz I."""
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(7), nz=60,
                                        nineq=150, neq=0, nbatch=2)
    Q = Q + 0.1 * 60 * np.eye(60)
    return [np.asarray(v, dtype) for v in (Q, p, G, h)]


def test_solver_on_hybrid_backend_matches_jax_f64():
    """float64: both packages' default (substitution mode); T through the
    port's hybrid backend and the JAX package's Cholesky. Forward to 1e-9
    with equal iterations, gradients of sum(z^2) to 1e-9."""
    data = _hybrid_data(np.float64)
    kw = dict(use_pallas="hybrid", check_Q_spd=False, eps=1e-9,
              refine_steps=0)
    cj, ct = qpth_tpu.SolverConfig(**kw), qt.SolverConfig(**kw)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data), config=cj)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data), config=ct,
                          device="cpu")
    _close(st.z, sj.z)
    _close(st.lam, sj.lam)
    assert int(st.stats.iterations) == int(sj.stats.iterations)

    import jax

    def loss_j(Q, p, G, h):
        z = qpth_tpu.solve_qp(Q, p, G, h, config=cj)
        return (z * z).sum()

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in data))
    args = [torch.tensor(v, requires_grad=True) for v in data]
    z = qt.solve_qp(*args, config=ct, device="cpu")
    (z * z).sum().backward()
    for a, g in zip(args, gj):
        _close(a.grad, g)


def test_solver_on_hybrid_backend_matches_jax_f32():
    """float32 at the JAX package's defaults: inverse mode, hybrid T on
    both sides (the JAX package's hybrid backend on the CPU), to its own
    hybrid tolerance, and both against the float64 oracle equally far."""
    data = _hybrid_data(np.float32)
    kw = dict(use_pallas="hybrid", check_Q_spd=False)
    zj = qpth_tpu.solve_qp(*(jnp.asarray(v) for v in data),
                           config=qpth_tpu.SolverConfig(**kw))
    zt = qt.solve_qp(*(torch.tensor(v) for v in data),
                     config=qt.SolverConfig(**kw), device="cpu")
    npt.assert_allclose(zt.numpy(), np.asarray(zj), atol=5e-4, rtol=1e-3)
    from qpth_tpu.solvers.oracle import solve_qp_batch_np

    x_ref = solve_qp_batch_np(*(v.astype(np.float64) for v in data),
                              None, None)[0]
    npt.assert_allclose(zt.numpy(), x_ref, atol=5e-3, rtol=1e-2)


def test_auto_past_the_fit_routes_to_hybrid(small_fit):
    be = kkt_ops.resolve_backend("auto", torch.float32, 40, "cpu")
    assert be.fused_step is None and be.solve2 is hybrid.solve_hybrid
    for value in (True, "lanes"):
        assert kkt_ops.resolve_backend(value, torch.float64, 40,
                                       "cpu").fused_step is None
    be = kkt_ops.resolve_backend("auto", torch.float32, 30, "cpu")
    assert be.fused_step is not None
    for m in (5, 300):
        for dev in ("cpu", "cuda"):
            assert kkt_ops.resolve_backend("hybrid", torch.float32, m,
                                           dev).fused_step is None
    invQ, facQ = kkt_ops._q_rep(torch.tensor(_spd(40, B=2)[0]))
    assert invQ is None and isinstance(facQ, hybrid.HybridFactor)
    assert [G.shape[-1] for G in facQ.Gs] == [16, 16, 8]
    invQ, facQ = kkt_ops._q_rep(torch.tensor(_spd(20, B=2)[0]))
    assert facQ is None and invQ.shape == (2, 20, 20)


def test_blocked_past_its_fit_and_hybrid_xla_raise():
    """"blocked" past kernel C's fit still raises; "hybrid_xla" (it raised
    naming item 22 until the tensor-parallel path was ported) is the
    hybrid backend and solves as "hybrid" does."""
    with pytest.raises(NotImplementedError, match="'hybrid' solves past"):
        kkt_ops.resolve_backend("blocked", torch.float64, 169, "cuda")
    be = kkt_ops.resolve_backend("hybrid_xla", torch.float32, 5, "cpu")
    assert be.solve2 is hybrid.solve_hybrid and be.fused_step is None
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(4), nz=6,
                                        nineq=5, nbatch=4)
    args = [torch.tensor(v, dtype=torch.float32) for v in (Q, p, G, h)]
    z = {v: qt.solve_qp_full(*args, config=qt.SolverConfig(use_pallas=v),
                             device="cpu").z for v in ("hybrid",
                                                       "hybrid_xla")}
    npt.assert_array_equal(z["hybrid_xla"].numpy(), z["hybrid"].numpy())


@pytest.mark.parametrize("neq", [0, 6])
def test_auto_past_the_fit_solves_as_within_it(small_fit, neq):
    """Path 8 on the CPU: nz = 45 and nineq = 40 past the moved fit, so Q
    is kept as facQ and T is factored by blocks, against the JAX package's
    float64 solve (inverse mode, tracked residuals) to 1e-9 with equal
    iterations; gradients to 1e-8."""
    Q, p, G, h, A, b = _eq_data(neq=neq)
    data = (Q, p, G, h) + ((A, b) if neq else ())
    kw = dict(solve_method="inverse", resid_every=7, check_Q_spd=False)
    cj, ct = qpth_tpu.SolverConfig(**kw), qt.SolverConfig(**kw)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data), config=cj)
    args = [torch.tensor(v, requires_grad=True) for v in data]
    st = qt.solve_qp_full(*(a.detach() for a in args), config=ct,
                          device="cpu")
    _close(st.z, sj.z)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    facs = qt.prefactor_qp(*(torch.tensor(v) for v in (Q, G)),
                           *((torch.tensor(A),) if neq else ()), config=ct,
                           device="cpu")
    assert facs.facQ is not None and facs.invQ is None

    import jax

    def loss_j(*a):
        z = qpth_tpu.solve_qp(*a, config=cj)
        return (z * z).sum()

    gj = jax.grad(loss_j, argnums=tuple(range(len(data))))(
        *(jnp.asarray(v) for v in data))
    z = qt.solve_qp(*args, config=ct, device="cpu")
    (z * z).sum().backward()
    for a, g in zip(args, gj):
        _close(a.grad, g, 1e-8)


def test_nz_past_the_fit_keeps_the_fused_steps(small_fit):
    """Path 8c on the CPU: nz = 45 past the moved fit, nineq = 20 within
    it. The fused steps run over the facQ products and give the explicit
    inverse's answer (float64)."""
    Q, p, G, h, _, _ = _eq_data(m=20)
    args = [torch.tensor(v) for v in (Q, p, G, h)]
    calls = {"n": 0}
    orig = kkt_ops.kernels.ipm_step_xfree

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    cfg = qt.SolverConfig(solve_method="inverse", resid_every=7)
    import unittest.mock as um

    with um.patch.object(kkt_ops.kernels, "ipm_step_xfree", counted):
        got = qt.solve_qp_full(*args, config=cfg, device="cpu")
    assert calls["n"] > 0
    with um.patch.object(kkt_ops, "past_fit", lambda n, dt, dev: False):
        want = qt.solve_qp_full(*args, config=cfg, device="cpu")
    _close(got.z, want.z, 1e-8)
    assert int(got.stats.iterations) == int(want.stats.iterations)


def test_refinement_past_the_fit_runs_factor_solve_hybrid(small_fit,
                                                          monkeypatch):
    """The eps dial (eps = 1e-8) on float32 data past the moved fit: every
    refinement step's factor and solve is ``factor_solve_hybrid``, and the
    refined z is as close to the float64 solve as within the fit."""
    Q, p, G, h = make_problem(4, 40, 40, seed=3)
    Q = Q + 0.1 * 40 * np.eye(40)
    f32 = [torch.tensor(v, dtype=torch.float32) for v in (Q, p, G, h)]
    calls = {"n": 0}
    orig = hybrid.factor_solve_hybrid

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(hybrid, "factor_solve_hybrid", counted)
    steps = {"n": 0, "calls": 0}
    from qpth_tpu_torch.core import pdipm as port_pdipm

    orig_refine = port_pdipm._refine

    def wrap(*a, **k):
        before = calls["n"]
        out = orig_refine(*a, **k)
        steps["n"] += out[3]
        steps["calls"] += calls["n"] - before
        return out

    monkeypatch.setattr(port_pdipm, "_refine", wrap)
    cfg = qt.SolverConfig(eps=1e-8, check_Q_spd=False)
    sol = qt.solve_qp_full(*f32, config=cfg, device="cpu")
    assert steps["n"] >= 1 and steps["calls"] == steps["n"]
    assert sol.z.dtype == torch.float64
    ref = qt.solve_qp_full(*(v.double() for v in f32),
                           config=qt.SolverConfig(eps=1e-12, refine_steps=0),
                           device="cpu")
    err = float(((sol.z - ref.z).norm(dim=1) / ref.z.norm(dim=1)).max())
    assert err <= 1e-6, err


def test_default_blocks_fit_kernel_a():
    """The default block width is one kernel A launch on CUDA in both
    dtypes, and the ``block`` argument overrides it."""
    from qpth_tpu_torch.ops.cuda import kernels

    for dtype in (torch.float32, torch.float64):
        assert kernels.fits(hybrid.BLOCK, dtype)
    T = torch.tensor(_spd(40, B=1)[0])
    assert hybrid.factor_hybrid(T).block == hybrid.BLOCK
    fac = hybrid.factor_hybrid(T, block=24)
    assert fac.block == 24 and [G.shape[-1] for G in fac.Gs] == [24, 16]


def test_auto_on_cpu_takes_any_size():
    """On the CPU "auto" keeps the kernels backend past the card's fits
    (nineq = 300 > THREADS): its plain versions take any m. Its answer and
    gradients equal the hybrid backend's on the same data to 1e-9."""
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(11), nz=30,
                                        nineq=300, neq=0, nbatch=2)
    data = [np.asarray(v, np.float64) for v in (Q + 3.0 * np.eye(30), p,
                                                G, h)]
    kw = dict(check_Q_spd=False, eps=1e-9, refine_steps=0)
    assert kkt_ops.resolve_backend("auto", torch.float64, 300,
                                   "cpu").fused_step is not None
    got = {}
    for value in ("auto", "hybrid"):
        args = [torch.tensor(v, requires_grad=True) for v in data]
        cfg = qt.SolverConfig(use_pallas=value, **kw)
        sol = qt.solve_qp_full(*(a.detach() for a in args), config=cfg,
                               device="cpu")
        z = qt.solve_qp(*args, config=cfg, device="cpu")
        (z * z).sum().backward()
        got[value] = (sol, [a.grad for a in args])
    (sa, ga), (sh, gh) = got["auto"], got["hybrid"]
    _close(sa.z, sh.z)
    assert int(sa.stats.iterations) == int(sh.stats.iterations)
    for a, b in zip(ga, gh):
        _close(a, b)
