"""The PyTorch port's banded and general structured tiers
(``qpth_tpu_torch.core.banded``, ``solve_qp_banded``,
``solve_qp_banded_full``) against the JAX package, case by case after
tests/test_banded.py, on the same seeded numpy inputs.

Float64 compares like with like: both packages run the same loop, the JAX
package inverting each stage by XLA's Cholesky and the port by kernel A's
recurrence (its plain version here). The differences are rounding: 1e-9 on
the solution with equal iteration counts, 1e-8 on gradients. The one
exception is the general tier at its floor, where d passes its cap and the
stage inverse's rounding decides the trajectory (see
test_general_floor_divergence_is_the_stage_inverse and ROADMAP.md §3).

Float32 runs the same algorithm on both sides: the JAX package with
``use_pallas=True`` (``factor_inv_lanes`` for every stage and
``inv_solve_lanes`` on M, in interpret mode), the port with kernel A's and
kernel 5's plain versions, at the reference's float32 tolerance of
tests/test_torch_diag.py (atol 2e-4, rtol 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.core import banded as jband
from qpth_tpu_torch.core import banded as tband
from qpth_tpu_torch.ops.cuda import kernels

from test_banded import densify, make_banded_qp

torch.set_num_threads(1)

CFG = dict(check_Q_spd=False, verbose=-1)


def _jax(args, dtype=jnp.float64):
    return [None if v is None else jnp.asarray(v, dtype) for v in args]


def _torch(args, dtype=torch.float64, grad=False):
    return [None if v is None else
            torch.tensor(v, dtype=dtype, requires_grad=grad) for v in args]


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    npt.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale,
                        err_msg=err_msg)


def _match(st, sj, tol=1e-9):
    """z, lam, s, nu within tol and equal iteration counts."""
    for name in ("z", "lam", "s", "nu"):
        _close(getattr(st, name).numpy(), getattr(sj, name), tol, name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)


def _jcfg(**kw):
    return qpth_tpu.SolverConfig(**CFG, **kw)


def _tcfg(**kw):
    return qt.SolverConfig(**CFG, **kw)


def test_bt_factor_solve_matches_jax():
    """The block-Thomas factor (W, F, Gt), the sweeps and the product
    against the JAX functions on the same shifted SPD band."""
    rng = np.random.RandomState(0)
    B, nb, bs = 3, 4, 4
    Qd, Qe, *_ = make_banded_qp(rng, nb=nb, bs=bs, nbatch=B)
    Hd = Qd + 3.0 * np.eye(bs)
    fj = jband.bt_factor(jnp.asarray(Hd), jnp.asarray(Qe),
                         jband._spd_inv_stage(False))
    ft = tband.bt_factor(torch.tensor(Hd), torch.tensor(Qe))
    for name in ("W", "F", "Gt"):
        _close(getattr(ft, name).numpy(), getattr(fj, name), 1e-12, name)
    r = rng.randn(B, nb, bs)
    _close(tband.bt_solve(ft, torch.tensor(r)).numpy(),
           jband.bt_solve(fj, jnp.asarray(r)), 1e-12, "bt_solve")
    R = rng.randn(B, nb, bs, 3)
    _close(tband.bt_solve_multi(ft, torch.tensor(R)).numpy(),
           jband.bt_solve_multi(fj, jnp.asarray(R)), 1e-12, "bt_solve_multi")
    _close(tband.bt_mul(torch.tensor(Qd), torch.tensor(Qe),
                        torch.tensor(r)).numpy(),
           jband.bt_mul(jnp.asarray(Qd), jnp.asarray(Qe), jnp.asarray(r)),
           1e-12, "bt_mul")
    # ... and the sweep solves H x = r.
    H = densify(Hd - 3.0 * np.eye(bs), Qe) + 3.0 * np.eye(nb * bs)
    want = np.linalg.solve(H, r.reshape(B, -1, 1))[..., 0]
    _close(tband.bt_solve(ft, torch.tensor(r)).numpy().reshape(B, -1), want,
           1e-10)


def test_stage_inverse_matches_jax_pallas_stage():
    """float32: the JAX package's Pallas stage (``_spd_inv_stage(True)``,
    ``factor_inv_lanes`` in interpret mode at B = 8) against the port's
    stage on kernel A's plain version."""
    rng = np.random.RandomState(1)
    B, bs = 8, 6
    L = rng.rand(B, bs, bs)
    C = (L @ L.transpose(0, 2, 1) / bs + np.eye(bs)).astype(np.float32)
    wj = jband._spd_inv_stage(True)(jnp.asarray(C))
    wt = tband._spd_inv_stage(torch.tensor(C))
    assert wt.dtype == torch.float32
    _close(wt.numpy(), wj, 2e-5)
    _close(wt.double().numpy(), np.linalg.inv(C.astype(np.float64)), 2e-5)


def test_stage_slices_reach_kernel_a_contiguous(monkeypatch):
    """The solver keeps its stage tensors stage-major: every stage kernel
    A inverts is a contiguous (B, bs, bs) block, so no copy is made for
    it."""
    seen = []
    orig = tband._spd_inv_stage

    def spy(C):
        seen.append((tuple(C.shape), C.is_contiguous()))
        return orig(C)

    monkeypatch.setattr(tband, "_spd_inv_stage", spy)
    args = make_banded_qp(np.random.RandomState(2), nb=4, bs=3, neq=2,
                          nbatch=3)
    qt.solve_qp_banded_full(*_torch(args), config=_tcfg(), device="cpu")
    assert seen and all(ok for _, ok in seen)
    assert {s for s, _ in seen} == {(3, 3, 3)}


@pytest.mark.parametrize("neq", [0, 5])
def test_banded_full_matches_jax(neq):
    args = make_banded_qp(np.random.RandomState(3), nb=5, bs=4, neq=neq)
    sj = qpth_tpu.solve_qp_banded_full(*_jax(args), config=_jcfg())
    kernels.reset_launches()
    st = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(), device="cpu")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    _match(st, sj)
    assert st.nu.shape == (args[2].shape[0], neq)


@pytest.mark.parametrize("neq", [0, 5])
def test_banded_f32_matches_jax_kernels(neq):
    """float32, the same algorithm on both sides (see the module
    docstring); z also within twice the reference's error against the
    float64 solve."""
    args = make_banded_qp(np.random.RandomState(4), nb=3, bs=4, neq=neq,
                          nbatch=8)
    cj = _jcfg(use_pallas=True, max_iter=8)
    sj = qpth_tpu.solve_qp_banded_full(*_jax(args, jnp.float32), config=cj)
    st = qt.solve_qp_banded_full(*_torch(args, torch.float32),
                                 config=_tcfg(max_iter=8), device="cpu")
    assert st.z.dtype == torch.float32
    for name in ("z", "lam", "s", "nu"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=2e-4,
                            rtol=1e-3, err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    ref = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(),
                                  device="cpu").z.numpy()
    e_t = np.abs(st.z.numpy() - ref).max()
    e_j = np.abs(np.asarray(sj.z) - ref).max()
    assert e_t <= max(2 * e_j, 1e-6), (e_t, e_j)


def _grads_jax(args, argnums, cfg, **kw):
    def loss(*a):
        z = qpth_tpu.solve_qp_banded(*a, config=cfg, **kw)
        return jnp.sum(z * z) + jnp.sum(z)

    return jax.grad(loss, argnums=argnums)(*_jax(args))


def _grads_torch(args, cfg, **kw):
    leaves = _torch(args, grad=True)
    z = qt.solve_qp_banded(*leaves, config=cfg, device="cpu", **kw)
    (z * z + z).sum().backward()
    return [None if v is None else v.grad for v in leaves]


@pytest.mark.parametrize("neq", [0, 4])
def test_banded_gradients_match_jax(neq):
    """Gradients to all seven inputs (Qd, Qe, p, g, h, A, b) against the
    JAX package's custom_vjp."""
    args = make_banded_qp(np.random.RandomState(5), nb=4, bs=3, neq=neq,
                          nbatch=2)
    argnums = (0, 1, 2, 3, 4) + ((5, 6) if neq else ())
    gj = _grads_jax(args, argnums, _jcfg())
    gt = _grads_torch(args, _tcfg())
    for k, name in zip(argnums, ("Qd", "Qe", "p", "g", "h", "A", "b")):
        assert gt[k] is not None and gt[k].shape == np.shape(args[k])
        _close(gt[k].numpy(), gj[argnums.index(k)], 1e-8, name)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_banded_shared_params_and_warmstart(reduction):
    """Shared (unbatched) blocks, g and A: forward, gradients (reduced
    over the batch by ``broadcast_grad_reduction``) and a warm start, all
    against the JAX package."""
    Qd, Qe, p, g, h, A, b = make_banded_qp(np.random.RandomState(6), nb=4,
                                           bs=3, neq=3, nbatch=3)
    args = (Qd[0], Qe[0], p, g[0], h, A, b)
    kw = dict(broadcast_grad_reduction=reduction)
    sj = qpth_tpu.solve_qp_banded_full(*_jax(args), config=_jcfg(**kw))
    st = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(**kw),
                                 device="cpu")
    _match(st, sj)
    assert st.z.shape == p.shape
    init_j = (sj.z, sj.s, sj.lam, sj.nu)
    init_t = (st.z, st.s, st.lam, st.nu)
    wj = qpth_tpu.solve_qp_banded_full(*_jax(args), config=_jcfg(**kw),
                                       init=init_j)
    wt = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(**kw),
                                 init=init_t, device="cpu")
    _match(wt, wj)
    assert int(wt.stats.iterations) <= int(st.stats.iterations)
    argnums = tuple(range(7))
    gj = _grads_jax(args, argnums, _jcfg(**kw))
    gt = _grads_torch(args, _tcfg(**kw))
    for k, name in zip(argnums, ("Qd", "Qe", "p", "g", "h", "A", "b")):
        assert gt[k].shape == np.shape(args[k]), name
        _close(gt[k].numpy(), gj[k], 1e-8, name)


def _box(neq, seed=7):
    Qd, Qe, p, _, _, _, _ = make_banded_qp(np.random.RandomState(seed),
                                           nb=4, bs=3, neq=0, nbatch=3)
    rng = np.random.RandomState(seed + 100)
    B, n = p.shape
    u = rng.rand(B, n) + 0.5
    lo = -(rng.rand(B, n) + 0.5)
    g = np.concatenate([np.ones((B, n)), -np.ones((B, n))], axis=1)
    h = np.concatenate([u, -lo], axis=1)
    if neq:
        z0 = lo + (u - lo) * rng.rand(B, n)
        A = rng.randn(neq, n)
        b = np.einsum("en,bn->be", A, z0)
    else:
        A = b = None
    return (Qd, Qe, p, g, h, A, b), list(range(n)) * 2, (lo, u)


@pytest.mark.parametrize("neq", [0, 4])
def test_banded_box_constraints_match_jax(neq):
    """Separable G (``g_cols``): box constraints [I; -I], m = 2n, forward
    and all gradients against the JAX package, and the box holds."""
    args, g_cols, (lo, u) = _box(neq)
    sj = qpth_tpu.solve_qp_banded_full(*_jax(args), config=_jcfg(),
                                       g_cols=g_cols)
    st = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(),
                                 g_cols=g_cols, device="cpu")
    _match(st, sj)
    z = st.z.numpy()
    assert (z <= u + 1e-7).all() and (z >= lo - 1e-7).all()
    argnums = (0, 1, 2, 3, 4) + ((5, 6) if neq else ())
    gj = _grads_jax(args, argnums, _jcfg(), g_cols=g_cols)
    gt = _grads_torch(args, _tcfg(), g_cols=g_cols)
    for k in argnums:
        _close(gt[k].numpy(), gj[argnums.index(k)], 1e-8, str(k))


def test_banded_rejects_g_cols_with_g_spec():
    args, g_cols, _ = _box(0)
    spec = qt.GeneralG(6, 12, 3, 4, [0], [0])
    with pytest.raises(ValueError, match="mutually exclusive"):
        qt.solve_qp_banded(*_torch(args), g_cols=g_cols, g_spec=spec,
                           device="cpu")


def test_diagonal_g_needs_g_of_length_n():
    Qd, Qe, p, g, h, _, _ = make_banded_qp(np.random.RandomState(8), nb=3,
                                           bs=2, nbatch=2)
    with pytest.raises(ValueError, match="g_cols"):
        qt.solve_qp_banded(*_torch((Qd, Qe, p, g[:, :-1], h[:, :-1])),
                           device="cpu")


@pytest.mark.parametrize("use_pallas", [False, "xla"])
def test_library_only_values_raise(use_pallas):
    args = make_banded_qp(np.random.RandomState(8), nb=3, bs=2, nbatch=2)
    with pytest.raises(NotImplementedError, match="no library-only path"):
        qt.solve_qp_banded_full(*_torch(args),
                                config=_tcfg(use_pallas=use_pallas),
                                device="cpu")


def _refine_fixture(rng):
    """tests/test_banded.py::test_banded_refine_separable's draws."""
    B, nb, bs = 8, 4, 4
    n = nb * bs
    Ld = np.tril(rng.randn(B, nb, bs, bs) * 0.3) + np.eye(bs) * 1.5
    Qd = np.einsum("bnij,bnkj->bnik", Ld, Ld)
    Qe = 0.2 * rng.randn(B, nb - 1, bs, bs)
    Qd[:, 1:] += np.einsum("bnij,bnkj->bnik", Qe, Qe)
    g = np.where(np.abs(rng.randn(B, n)) < 0.3, 0.7, rng.randn(B, n))
    z0 = rng.randn(B, n)
    h = g * z0 + rng.rand(B, n) + 0.2
    p = rng.randn(B, n)
    return Qd, Qe, p, g, h


def test_banded_refine_separable():
    """Post-loop refinement (refine_steps) on the separable tier, float32:
    the score drops below 1e-4 and not above the unrefined one, as in the
    JAX package, whose refined scores it matches to float32 rounding."""
    args = _refine_fixture(np.random.RandomState(9))
    base = qt.solve_qp_banded_full(*_torch(args, torch.float32),
                                   config=_tcfg(), device="cpu")
    ref = qt.solve_qp_banded_full(*_torch(args, torch.float32),
                                  config=_tcfg(refine_steps=3), device="cpu")
    rb = float(base.stats.best_resids.max())
    rr = float(ref.stats.best_resids.max())
    assert ref.z.dtype == torch.float32
    assert rr <= rb and rr < 1e-4, (rb, rr)
    sj = qpth_tpu.solve_qp_banded_full(*_jax(args, jnp.float32),
                                       config=_jcfg(refine_steps=3,
                                                    use_pallas=True))
    npt.assert_allclose(ref.z.numpy(), np.asarray(sj.z), atol=2e-4,
                        rtol=1e-3)
    assert float(np.asarray(sj.stats.best_resids).max()) < 1e-4


def _scrambled(rng, B, n, w):
    """tests/test_banded.py::test_general_tier_refine_breaks_f32_plateau's
    draws: a scrambled band of width w, two-entry G rows."""
    perm0 = rng.permutation(n)
    qi = [(i, j) for i in range(n) for j in range(n) if abs(i - j) <= w]
    Qi = np.array([(perm0[i], perm0[j]) for (i, j) in qi]).T
    gi = []
    for r in range(n):
        c = rng.randint(0, n - 1)
        gi.append((r, perm0[c]))
        gi.append((r, perm0[c + 1]))
    Gi = np.array(gi).T
    Qv = np.zeros((B, Qi.shape[1]), np.float32)
    look = {}
    for k, (i, j) in enumerate(zip(*Qi)):
        if i == j:
            Qv[:, k] = 2.0 * w + 1 + rng.rand(B)
        elif (int(j), int(i)) in look:
            Qv[:, k] = Qv[:, look[(int(j), int(i))]]
        else:
            Qv[:, k] = rng.randn(B) * 0.3
            look[(int(i), int(j))] = k
    Gv = rng.randn(B, Gi.shape[1]).astype(np.float32)
    p = rng.randn(B, n).astype(np.float32)
    G = np.zeros((B, n, n), np.float32)
    np.add.at(G, (np.arange(B)[:, None], Gi[0][None, :], Gi[1][None, :]),
              Gv)
    z0 = rng.randn(B, n)
    h = (np.einsum("bmn,bn->bm", G, z0) + rng.rand(B, n)
         + 0.2).astype(np.float32)
    return Qi, Qv, Gi, Gv, p, h


def _general_operands(B=16, n=64, w=4, seed=10):
    """The general tier's banded operands, built by both packages'
    SpQPFunction plans from the same pattern: (port operands, JAX
    operands, port GeneralG, JAX GeneralG)."""
    Qi, Qv, Gi, Gv, p, h = _scrambled(np.random.RandomState(seed), B, n, w)
    fj = qpth_tpu.SpQPFunction(Qi, (n, n), Gi, (n, n), np.zeros((2, 0), int),
                               (0, n), structure="general")
    ft = qt.SpQPFunction(Qi, (n, n), Gi, (n, n), np.zeros((2, 0), int),
                         (0, n), structure="general", device="cpu")
    n_, bs, nb, n_pad = ft._band
    perm, _, spec_t = ft._gen
    spec_j = qt.GeneralG(spec_t.m, spec_t.n, bs, nb, Gi[0],
                         ft._gen[1][Gi[1]])
    assert spec_j == spec_t and hash(spec_j) == hash(spec_t)
    Qd, Qe = ft._band_blocks(torch.tensor(Qv))
    pp = np.pad(p[:, perm], ((0, 0), (0, n_pad - n_)))
    ops = (Qd.numpy(), Qe.numpy(), pp, Gv, h)
    return ops, spec_t, fj._gen[2]


def test_general_g_tables_match_jax():
    """GeneralG's scatter tables are the JAX class's, pair for pair."""
    _, spec_t, spec_j = _general_operands(B=2)
    for name in ("rows", "cols", "hd", "qe", "hd_row", "qe_row"):
        npt.assert_array_equal(getattr(spec_t, name), getattr(spec_j, name),
                               err_msg=name)
    assert (spec_t.m, spec_t.n, spec_t.bs, spec_t.nb) == (
        spec_j.m, spec_j.n, spec_j.bs, spec_j.nb)


def test_general_tier_refine_breaks_f32_plateau():
    """The general tier's float32 plateau: post-loop refinement pushes the
    scrambled-band fixture's score below 1e-4 and ten times below the
    unrefined one, as in the JAX package (whose scores the port's match
    within a factor of 3)."""
    ops, spec_t, spec_j = _general_operands()
    got, want = {}, {}
    for steps in (0, 3):
        st = qt.solve_qp_banded_full(*_torch(ops, torch.float32), None, None,
                                     config=_tcfg(refine_steps=steps),
                                     g_spec=spec_t, device="cpu")
        sj = qpth_tpu.solve_qp_banded_full(*_jax(ops, jnp.float32), None,
                                           None, config=_jcfg(
                                               refine_steps=steps),
                                           g_spec=spec_j)
        got[steps] = float(st.stats.best_resids.max())
        want[steps] = float(np.asarray(sj.stats.best_resids).max())
    assert got[3] < 1e-4 and got[3] < got[0] / 10, got
    assert want[3] < 1e-4, want
    assert want[3] / 3 <= got[3] <= 3 * want[3], (got, want)


def test_general_refine_auto_runs_its_whole_budget(monkeypatch):
    """The reference's defect, matched: with refine_steps="auto" (eps =
    1e-8: a budget of 12 with a batch-wide early exit) the banded tiers
    run all 12 steps, the early exit unapplied. The port's refined
    solution equals refine_steps=12's bit for bit, and it matches the JAX
    package's "auto" in float64."""
    ops, spec_t, spec_j = _general_operands(B=4, seed=11)
    calls = []
    orig = tband._Band.factor

    def count(self, d):
        calls.append(1)
        return orig(self, d)

    monkeypatch.setattr(tband._Band, "factor", count)
    auto = qt.solve_qp_banded_full(*_torch(ops), None, None,
                                   config=_tcfg(eps=1e-8), g_spec=spec_t,
                                   device="cpu")
    n_auto = len(calls)
    calls.clear()
    loop_only = qt.solve_qp_banded_full(
        *_torch(ops), None, None, config=_tcfg(eps=1e-8, refine_steps=0),
        g_spec=spec_t, device="cpu")
    assert int(loop_only.stats.iterations) == int(auto.stats.iterations)
    assert n_auto - len(calls) == 12
    fixed = qt.solve_qp_banded_full(
        *_torch(ops), None, None, config=_tcfg(eps=1e-8, refine_steps=12),
        g_spec=spec_t, device="cpu")
    for name in ("z", "lam", "s"):
        assert torch.equal(getattr(auto, name), getattr(fixed, name)), name
    sj = qpth_tpu.solve_qp_banded_full(*_jax(ops), None, None,
                                       config=_jcfg(eps=1e-8), g_spec=spec_j)
    _match(auto, sj)


def test_banded_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _torch(make_banded_qp(np.random.RandomState(12), nb=3, bs=2,
                                 nbatch=2))
    for fn in (qt.solve_qp_banded, qt.solve_qp_banded_full):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args)
    assert bool(torch.isfinite(qt.solve_qp_banded(*args,
                                                  device="cpu")).all())


def test_config_fields_reach_the_banded_loop():
    """max_iter, n_correctors and improve_margin take effect as in the
    JAX package (float64, equal iterations and solutions)."""
    args = make_banded_qp(np.random.RandomState(13), nb=4, bs=3, neq=2,
                          nbatch=3)
    for kw in (dict(max_iter=4), dict(n_correctors=2),
               dict(improve_margin=1e-3, not_improved_lim=2)):
        sj = qpth_tpu.solve_qp_banded_full(*_jax(args), config=_jcfg(**kw))
        st = qt.solve_qp_banded_full(*_torch(args), config=_tcfg(**kw),
                                     device="cpu")
        _match(st, sj)


def test_inaccurate_solution_warns():
    """An infeasible box (lower bound above the upper) ends above a
    residual of 1: the RuntimeWarning of the dense and diagonal tiers."""
    args, g_cols, _ = _box(0, seed=14)
    Qd, Qe, p, g, h, _, _ = args
    n = p.shape[1]
    h = h.copy()
    h[:, n:] = -(h[:, :n] + 1.0)          # -x <= -(u + 1): x >= u + 1
    with pytest.warns(RuntimeWarning, match="inaccurate solution"):
        qt.solve_qp_banded_full(*_torch((Qd, Qe, p, g, h)),
                                config=dataclasses.replace(_tcfg(),
                                                           verbose=0),
                                g_cols=g_cols, device="cpu")


def test_general_floor_divergence_is_the_stage_inverse(monkeypatch):
    """Where the general tier's d passes its cap, a stage's Schur
    complement reaches a condition number of ~1e10, and the stage
    inverse's rounding decides which lanes' complements stay SPD. Kernel
    A's recurrence (its plain version here) is about twice as far from the
    exact inverse as the reference's Cholesky solve there (2.3e-7 against
    1.1e-7 at 1.2e10), so on some draws the two trajectories part at the
    floor (ROADMAP.md §3): on this one the port ends 1.4e-7 from the JAX
    package. With the reference's stage algorithm in its place the port
    reproduces the reference to 1e-9 with equal iterations: the stage
    inverse is the whole difference."""
    from qpth_tpu_torch.ops.linalg import cholesky

    from test_sparse import _general_problem

    Qi, Qv, Gi, Gv, h, p, Ai, Av, b, (neq, n, m) = _general_problem(
        np.random.RandomState(5), neq=0)
    vals = (Qv, p, Gv, h, Av, b)
    fj = qpth_tpu.SpQPFunction(Qi, (n, n), Gi, (m, n), Ai, (0, n))
    ft = qt.SpQPFunction(Qi, (n, n), Gi, (m, n), Ai, (0, n), device="cpu")
    sj = fj.solve_full(*map(jnp.asarray, vals))
    parted = float(np.abs(ft.solve_full(*map(torch.tensor, vals)).z.numpy()
                          - np.asarray(sj.z)).max())
    assert parted > 1e-8

    def cho_inv(C):
        eye = torch.eye(C.shape[-1], dtype=C.dtype).expand(C.shape)
        return torch.cholesky_solve(eye, cholesky(C))

    monkeypatch.setattr(tband, "_spd_inv_stage", cho_inv)
    _match(ft.solve_full(*map(torch.tensor, vals)), sj)
