"""``KKTSolver.FULL`` and ``KKTSolver.IR`` (``ops/kkt.py``: the full saddle
system by partial-pivot LU each solve, and its regularized form with
iterative refinement) and the per-iteration prints (``verbose >= 1``) of
the PyTorch port, against the JAX package on the CPU."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu_torch.ops import kkt as kkt_ops

from conftest import make_feasible_qp

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def _data(neq):
    """``tests/test_pdipm.py::test_alternate_kkt_paths``'s fixture."""
    Q, p, G, h, A, b = make_feasible_qp(np.random.RandomState(7), nz=8,
                                        nineq=5, neq=neq, nbatch=4)
    return (Q, p, G, h) + ((A, b) if neq else ())


def _both(data, kw, dtype=torch.float64):
    jkw = dict(kw)
    if "kkt_solver" in jkw:
        jkw["kkt_solver"] = qpth_tpu.KKTSolver[jkw["kkt_solver"].name]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v, jdt) for v in data),
                                config=qpth_tpu.SolverConfig(**jkw))
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=dtype) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu")
    return sj, st, jkw


@pytest.mark.parametrize("eps", [1e-12, 1e-9], ids=["eps_default",
                                                     "eps_1e-9_refined"])
@pytest.mark.parametrize("neq", [0, 2])
@pytest.mark.parametrize("solver", ["FULL", "IR"])
def test_kkt_variant_f64_matches_jax(solver, neq, eps):
    """z, the duals and the iterations of the JAX package to 1e-9; at
    eps = 1e-9 the eps dial refines through the same saddle solves. The
    gradients (the backward's partial-Cholesky algebra on the prefactored
    factors, whatever ``kkt_solver`` says, in both packages) to 1e-8."""
    data = _data(neq)
    kw = dict(kkt_solver=qt.KKTSolver[solver], eps=eps, check_Q_spd=False,
              verbose=-1)
    sj, st, jkw = _both(data, kw)
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), rtol=0,
                            atol=1e-9, err_msg=name)
    w = np.random.RandomState(3).randn(4, 8)

    def loss(*args):
        return jnp.sum(qpth_tpu.solve_qp(
            *args, config=qpth_tpu.SolverConfig(**jkw)) * w)

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


@pytest.mark.parametrize("solver", ["FULL", "IR"])
def test_kkt_variant_f32_equilibrated(solver):
    """Float32 with the probe's equilibration: the saddle systems read the
    iterate-coordinate matrices. Both packages' z within 1e-4 of the
    float64 solve, and of each other within the same."""
    data = tuple(np.float64(np.float32(v)) for v in _data(2))
    kw = dict(kkt_solver=qt.KKTSolver[solver], check_Q_spd=False,
              verbose=-1)
    sj, st, _ = _both(data, kw, torch.float32)
    z64 = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                           config=qt.SolverConfig(check_Q_spd=False,
                                                  verbose=-1),
                           device="cpu").z.numpy()
    for z in (st.z.numpy(), np.asarray(sj.z)):
        npt.assert_allclose(z, z64, rtol=0, atol=1e-4 * np.abs(z64).max())
    npt.assert_allclose(st.z.numpy(), np.asarray(sj.z), rtol=0,
                        atol=1e-4 * np.abs(z64).max())


@pytest.mark.parametrize("neq", [0, 2])
@pytest.mark.parametrize("shared", [False, True])
def test_saddle_solves_match_jax(neq, shared):
    """The saddle solves themselves, one right-hand side: FULL, and IR at
    ir_iters 0 and 2, against ``qpth_tpu.ops.kkt`` to 1e-10."""
    from qpth_tpu.ops import kkt as jkkt

    rng = np.random.RandomState(9)
    B, nz, m = 3, 7, 5
    L = rng.randn(1 if shared else B, nz, nz)
    Q = L @ L.transpose(0, 2, 1) + np.eye(nz)
    G = rng.randn(1 if shared else B, m, nz)
    A = rng.randn(1 if shared else B, neq, nz) if neq else None
    D = np.stack([np.diag(v) for v in rng.rand(B, m) + 0.1])
    rx, rs, rz = rng.randn(B, nz), rng.randn(B, m), rng.randn(B, m)
    ry = rng.randn(B, neq) if neq else None
    args = (Q, D, G, A, rx, rs, rz, ry)

    def j(v):
        return None if v is None else jnp.asarray(v)

    def t(v):
        return None if v is None else torch.tensor(v)

    cases = [(kkt_ops.factor_solve_kkt, jkkt.factor_solve_kkt, {})]
    cases += [(kkt_ops.solve_kkt_ir, jkkt.solve_kkt_ir,
               dict(eps=1e-7, niter=k)) for k in (0, 2)]
    for fn_t, fn_j, kw in cases:
        got = fn_t(*(t(v) for v in args), **kw)
        want = fn_j(*(j(v) for v in args), **kw)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            npt.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                atol=1e-10)


def test_verbose_prints_one_line_per_iteration(capsys):
    """``verbose=1``: one line per iteration in the JAX package's format,
    the iteration and the batch means of pri, dual and mu; the same lines
    as the JAX package's (float64, to 4 digits above the rounding
    floor)."""
    data = _data(2)
    kw = dict(verbose=1, check_Q_spd=False)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu")
    port = capsys.readouterr().out.splitlines()
    qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data),
                           config=qpth_tpu.SolverConfig(**kw))
    jax.effects_barrier()
    ref = capsys.readouterr().out.splitlines()
    pat = re.compile(r"^iter: (\d+), pri_resid: (\S+), dual_resid: (\S+), "
                     r"mu: (\S+)$")
    assert len(port) == int(st.stats.iterations) == len(ref)
    for k, (a, b) in enumerate(zip(port, ref)):
        ma, mb = pat.match(a), pat.match(b)
        assert ma and mb, (a, b)
        assert int(ma.group(1)) == k == int(mb.group(1))
        va = np.array([float(x) for x in ma.groups()[1:]])
        vb = np.array([float(x) for x in mb.groups()[1:]])
        npt.assert_allclose(va, vb, rtol=1e-4, atol=1e-10)


def test_inaccurate_warning_names_ir_and_the_oracle():
    """The INACC warning (best score > 1, ``tests/data_degenerate_eq.npz``)
    gives the JAX package's advice again: IR or the CPU oracle."""
    d = np.load(os.path.join(HERE, "data_degenerate_eq.npz"))
    data = [torch.tensor(d[k]) for k in ("Q", "p", "G", "h", "A", "b")]
    with pytest.warns(RuntimeWarning, match=r"KKTSolver\.IR\) or the CPU "
                      "oracle"):
        qt.solve_qp_full(*data, config=qt.SolverConfig(check_Q_spd=False),
                         device="cpu")
