"""Mixed-precision refinement in the PyTorch port (``SolverConfig(
refine_steps=...)`` and the eps dial, ``core/pdipm.py::_refine``) against
the JAX package's float64-residual refinement, on the CPU.

* the eps -> (budget, early exit) table of ``resolve_refine_steps``;
* float64 at eps = 1e-9 (auto refinement, 12 steps with the early exit):
  z, the duals and six gradients within 1e-9 of the JAX package, equal
  iterations and equal refinement steps;
* float32 at eps = 1e-8: float64 outputs held to the float64 solve of the
  float32-rounded data (the yardstick: rounding the data moves the solution
  by ~cond * eps_f32, which is not the solver's error). With the dial's
  early exit the median lane of both packages is within 1e-8 and a lane
  above it is one the batch-wide early exit stopped short; with the same
  budget and no early exit every lane of both packages is within 1e-8 of
  the yardstick and of each other; from one float32 start (the port's
  unrefined iterate as a warm start with no IPM iteration) the dial takes
  equal steps in both packages and each port lane is held to the JAX
  package's own error on it;
* gradients after a refined float32 forward: float32, within 1e-4 of the
  JAX package's;
* the n = 1 instance on which the Mehrotra loop stalls at mu ~ 5e-3.

The equality-constrained float32 data shift Q by I, as the on-card path 1
does: bench.py's Q (gram + 1e-3 I) with equality rows is beyond float32
inverse mode in both packages' kernel paths
(``test_torch_qp_eq.py::test_eq_f32_conditioning_limit_is_the_references``),
and refinement starts from the loop's best iterate."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.config import resolve_refine_steps as jax_resolve
from qpth_tpu.core import pdipm as jax_pdipm
from qpth_tpu_torch.config import resolve_refine_steps
from qpth_tpu_torch.core import pdipm as port_pdipm

from test_torch_qp import make_problem
from test_torch_qp_eq import make_eq_problem

torch.set_num_threads(1)

NAMES = "QpGhAb"


def count_steps(monkeypatch):
    """Count refinement steps in both packages: the port's ``_refine``
    returns its count; the JAX package's gets its factor-and-solve wrapped
    by a counter (a debug callback, since its steps run inside
    ``lax.while_loop``)."""
    calls = {"jax": 0, "port": 0}
    orig_j, orig_t = jax_pdipm._refine, port_pdipm._refine

    def bump_jax():
        calls["jax"] += 1

    def wrap_jax(*args, **kw):
        args = list(args)
        kfs = args[11]

        def counted(*a):
            jax.debug.callback(bump_jax)
            return kfs(*a)

        args[11] = counted
        return orig_j(*args, **kw)

    def wrap_port(*args, **kw):
        out = orig_t(*args, **kw)
        calls["port"] += out[3]
        return out

    monkeypatch.setattr(jax_pdipm, "_refine", wrap_jax)
    monkeypatch.setattr(port_pdipm, "_refine", wrap_port)
    return calls


@pytest.mark.parametrize("kw,dtype,want", [
    (dict(), "f64", (0, False)),
    (dict(), "f32", (0, False)),
    (dict(eps=1e-4), "f32", (0, False)),
    (dict(eps=1e-8), "f64", (12, True)),
    (dict(eps=1e-6), "f32", (6, True)),
    (dict(eps=1e-7), "f32", (6, True)),
    (dict(eps=1e-8), "f32", (12, True)),
    (dict(eps=1e-10), "f32", (12, True)),
    (dict(eps=1e-11), "f64", (12, True)),
    (dict(eps=1e-8, refine_steps=3), "f32", (3, False)),
    (dict(refine_steps=0), "f32", (0, False)),
])
def test_resolve_refine_steps_matches_jax(kw, dtype, want):
    """The eps dial (``tests/test_refine.py``'s table): accuracy demands in
    [1e-11, 1e-6] engage 6 or 12 steps with the early exit at any dtype;
    an explicit count runs as given."""
    tdt = torch.float64 if dtype == "f64" else torch.float32
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    got = resolve_refine_steps(qt.SolverConfig(**kw), tdt)
    assert got == want
    assert got == jax_resolve(qpth_tpu.SolverConfig(**kw), jdt)


def _f64_data(neq):
    if neq == 0:
        return make_problem(8, 12, 10, seed=1)
    return make_eq_problem(8, 12, 10, neq, seed=1)


def _grads_jax(data, w, cfg, dtype=jnp.float64):
    def loss(*args):
        return jnp.sum(qpth_tpu.solve_qp(*args, config=cfg) * w)

    args = [jnp.asarray(v, dtype) for v in data]
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _grads_port(data, w, cfg, dtype=torch.float64):
    args = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in data]
    z = qt.solve_qp(*args, config=cfg, device="cpu")
    (z * torch.tensor(w, dtype=z.dtype)).sum().backward()
    return z, [a.grad for a in args]


@pytest.mark.parametrize("neq", [0, 4])
def test_refine_f64_matches_jax(neq, monkeypatch):
    data = _f64_data(neq)
    kw = dict(check_Q_spd=False, verbose=-1, eps=1e-9)
    steps = count_steps(monkeypatch)
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data),
                                config=qpth_tpu.SolverConfig(**kw))
    jax.effects_barrier()
    st = qt.solve_qp_full(*(torch.tensor(v) for v in data),
                          config=qt.SolverConfig(**kw), device="cpu")
    assert steps["port"] == steps["jax"] > 0, steps
    assert int(st.stats.iterations) == int(sj.stats.iterations)
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), rtol=0,
                            atol=1e-9, err_msg=name)
    npt.assert_allclose(st.stats.best_resids.numpy(),
                        np.asarray(sj.stats.best_resids), rtol=1e-6,
                        atol=1e-13)
    w = np.random.RandomState(5).randn(8, 12)
    gj = _grads_jax(data, w, qpth_tpu.SolverConfig(**kw))
    _, gt = _grads_port(data, w, qt.SolverConfig(**kw))
    for name, a, c in zip(NAMES, gt, gj):
        c = np.asarray(c)
        npt.assert_allclose(a.numpy(), c, rtol=0,
                            atol=1e-9 * max(1.0, np.abs(c).max()),
                            err_msg=name)


def _f32_data(neq):
    """Float32-representable data (held as float64): the f32 solves and
    the float64 yardstick see the same problem."""
    if neq == 0:
        data = make_problem(8, 20, 20, seed=3)
    else:
        raw = make_eq_problem(8, 20, 20, neq, seed=3)
        data = (raw[0] + np.eye(20),) + raw[1:]
    return tuple(np.float64(np.float32(v)) for v in data)


def _lane_err(z, z64):
    return (np.linalg.norm(np.asarray(z, np.float64) - z64, axis=1)
            / np.linalg.norm(z64, axis=1))


def _yardstick(data):
    """The JAX package's float64 solve of the data (its default float64
    configuration: substitution mode, untracked residuals)."""
    return np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in data),
        config=qpth_tpu.SolverConfig(check_Q_spd=False, verbose=-1)).z)


def _solve_f32(data, tkw, jkw):
    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v, jnp.float32) for v in data),
                                config=qpth_tpu.SolverConfig(**jkw))
    jax.effects_barrier()
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                            for v in data),
                          config=qt.SolverConfig(**tkw), device="cpu")
    assert st.lo is None and sj.lo is None
    for name in ("z", "nu", "lam", "s"):
        assert getattr(st, name).dtype == torch.float64, name
    assert st.stats.best_resids.dtype == torch.float64
    return sj, st


def _check_f32_refined(data, tkw, jkw, monkeypatch, limit=1e-8):
    """Both packages' refined float32 solves against the float64 yardstick.

    With the eps dial (``refine_steps="auto"``, 12 steps and the early
    exit) the median lane is within ``limit`` in both packages. The early
    exit stops once a step does not halve the batch's max score, a test
    over the whole batch (the JAX package's, recorded in ROADMAP.md), so a
    lane whose float32 start was far can stop short: which lanes start far
    is float32 rounding, and the two packages' loops round differently
    (benchmarks/refine_witness.py). So a lane above ``limit`` under the
    dial must be one the early exit cut: its package stopped before the
    budget, and the same budget without the early exit
    (``refine_steps=12``) brings that lane within ``limit``. That budget
    brings every lane of both packages within ``limit`` of the yardstick
    and of each other.

    From one float32 start (the port's unrefined iterate, handed to both
    packages as a warm start with no IPM iteration) the loops' rounding no
    longer chooses which lanes start far: the dial takes the same steps in
    both, and each port lane is held to the JAX package's own error on it
    (within 1e-8, or within 1% of the JAX lane's error where that lane
    misses 1e-8)."""
    z64 = _yardstick(data)
    steps = count_steps(monkeypatch)
    sj, st = _solve_f32(data, tkw, jkw)
    dial = {"jax": (_lane_err(np.asarray(sj.z), z64), steps["jax"]),
            "port": (_lane_err(st.z.numpy(), z64), steps["port"])}

    t32 = [torch.tensor(v, dtype=torch.float32) for v in data]
    base = qt.solve_qp_full(*t32, config=qt.SolverConfig(
        **dict(tkw, refine_steps=0)), device="cpu")
    init = (base.z, base.s, base.lam, base.nu)
    start = dict(max_iter=0, warm_start_min=0.0)
    steps["jax"] = steps["port"] = 0
    st0 = qt.solve_qp_full(*t32, config=qt.SolverConfig(**tkw, **start),
                           init=init, device="cpu")
    sj0 = qpth_tpu.solve_qp_full(
        *(jnp.asarray(v, jnp.float32) for v in data),
        config=qpth_tpu.SolverConfig(**jkw, **start),
        init=tuple(jnp.asarray(v.numpy()) for v in init))
    jax.effects_barrier()
    assert steps["port"] == steps["jax"] > 0, steps
    e_j = _lane_err(np.asarray(sj0.z), z64)
    e_t = _lane_err(st0.z.numpy(), z64)
    assert (e_t <= np.maximum(limit, 1.01 * e_j)).all(), (e_t, e_j)

    full = dict(refine_steps=12)
    sj, st = _solve_f32(data, dict(tkw, **full), dict(jkw, **full))
    fixed = {"jax": _lane_err(np.asarray(sj.z), z64),
             "port": _lane_err(st.z.numpy(), z64)}
    for name, (e, n) in dial.items():
        assert np.median(e) <= limit, (name, e)
        assert (e <= limit).all() or n < 12, (name, n, e)
        assert (fixed[name] <= limit).all(), (name, fixed[name])
    e_tj = _lane_err(st.z.numpy(), np.asarray(sj.z))
    assert (e_tj <= limit).all(), e_tj
    return dial["port"][0], z64


@pytest.mark.parametrize("backend", ["auto", "blocked"])
@pytest.mark.parametrize("equilibrate", ["auto", False])
@pytest.mark.parametrize("neq", [0, 4])
def test_refine_f32_reaches_f64_of_rounded_data(neq, equilibrate, backend,
                                                monkeypatch):
    data = _f32_data(neq)
    kw = dict(check_Q_spd=False, verbose=-1, eps=1e-8,
              equilibrate=equilibrate)
    e_t, z64 = _check_f32_refined(data, dict(kw, use_pallas=backend), kw,
                                  monkeypatch)
    # The unrefined float32 solve is 1e-6 to 1e-3 away: the dial's median
    # lane gains >= 100x.
    base = qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                              for v in data),
                            config=qt.SolverConfig(
                                check_Q_spd=False, verbose=-1,
                                equilibrate=equilibrate,
                                use_pallas=backend), device="cpu")
    e_b = _lane_err(base.z.numpy(), z64)
    assert np.median(e_t) * 100 <= np.median(e_b), (e_t, e_b)


def test_refine_f32_full_equilibration_maps(monkeypatch):
    """Columns scaled by 10^±2 and ``equilibrate=True`` (the full branch:
    the factors and iterates in scaled coordinates): the refined residuals
    are the original problem's, mapped by the exact pow2 scalings."""
    Q, p, G, h, A, b = _f32_data(4)
    s = 10.0 ** np.random.RandomState(8).uniform(-2, 2, size=20)
    data = (Q * s[:, None] * s[None, :], p * s, G * s, h, A * s, b)
    data = tuple(np.float64(np.float32(v)) for v in data)
    kw = dict(check_Q_spd=False, verbose=-1, eps=1e-8, equilibrate=True)
    _check_f32_refined(data, kw, kw, monkeypatch)


def test_grads_after_refined_f32_forward():
    """The backward of a refined forward runs in the inputs' dtype: float32
    cotangents, within 1e-4 of the JAX package's (relative to each
    gradient's largest entry)."""
    data = tuple(v.astype(np.float32) for v in _f32_data(4))
    kw = dict(check_Q_spd=False, verbose=-1, eps=1e-8)
    w = np.random.RandomState(6).randn(8, 20)
    gj = _grads_jax(data, w, qpth_tpu.SolverConfig(**kw), jnp.float32)
    z, gt = _grads_port(data, w, qt.SolverConfig(**kw), torch.float32)
    assert z.dtype == torch.float64
    for name, a, c in zip(NAMES, gt, gj):
        c = np.asarray(c)
        assert a.dtype == torch.float32 and c.dtype == np.float32, name
        npt.assert_allclose(a.numpy(), c, rtol=0,
                            atol=1e-4 * np.abs(c).max(), err_msg=name)


def test_refine_recovers_the_mu_stall():
    """``tests/test_refine.py``'s fuzz-found instance (n = 1, seven
    inequalities, interior optimum): the float64 loop stalls at mu ~ 5e-3
    and returns z = 1.23110031 where the solution is 1.19520246, and says
    so in best_resids; eps = 1e-8 (auto refinement) recovers it, as in the
    JAX package."""
    Q = np.array([[[1.0727172351886847]]])
    p = np.array([[-1.2821142806660437]])
    G = np.array([[[1.27765179], [-0.84154692], [0.04059288],
                   [-0.42196205], [0.70045125], [-0.46241431],
                   [-2.30122133]]])
    h = np.array([[2.18995165, -0.90222387, 0.90901951, 0.48930716,
                   0.8633719, 0.12413917, -1.88189942]])
    data = (Q, p, G, h)
    out = {}
    for eps in (1e-12, 1e-8):
        kw = dict(check_Q_spd=False, verbose=-1, eps=eps)
        out[eps] = (
            qt.solve_qp_full(*(torch.tensor(v) for v in data),
                             config=qt.SolverConfig(**kw), device="cpu"),
            qpth_tpu.solve_qp_full(*(jnp.asarray(v) for v in data),
                                   config=qpth_tpu.SolverConfig(**kw)))
    base, base_j = out[1e-12]
    assert float(base.stats.best_resids[0]) > 1e-4
    npt.assert_allclose(base.z.numpy(), np.asarray(base_j.z), atol=1e-12)
    ref, ref_j = out[1e-8]
    assert abs(float(ref.z[0, 0]) - 1.19520246) < 1e-5
    assert float(ref.stats.best_resids[0]) < 1e-5
    npt.assert_allclose(ref.z.numpy(), np.asarray(ref_j.z), atol=1e-9)
