"""Intra-QP tensor parallelism of the PyTorch port (``qpth_tpu_torch.
parallel.intra``) on two gloo ranks on the CPU, and ``use_pallas=
"hybrid_xla"`` in one process, against the JAX package and the port's
single-process functions (tests/test_intra_tp.py's cases).

The two ranks start once for the file (``tests/_torch_parallel_worker.py``
runs every case and writes each rank's results); the tests read them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.sharding import Mesh

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.ops.hybrid import factor_solve_hybrid as jax_factor_solve
from qpth_tpu.parallel import prefactor_qp_tp as jax_prefactor_qp_tp
from qpth_tpu_torch.ops import hybrid

from conftest import make_feasible_qp

import _torch_parallel_worker as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.launch("intra", tmp_path_factory.mktemp("intra"))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("dt,tol", [("float64", 1e-10), ("float32", 1e-5)])
def test_factor_solve_hybrid_tp(ranks, dt, tol):
    """The distributed blocked factor and its solve at m = 256 (two block
    rows per rank): x on both ranks against the JAX package's
    ``factor_solve_hybrid`` and the port's, relative to max |x|."""
    T, v, dinv = W.tp_matrix(dt)
    _, want = jax.jit(lambda T_, v_, d_: jax_factor_solve(T_, v_, dinv=d_))(
        jnp.asarray(T), jnp.asarray(v), jnp.asarray(dinv))
    _, port = hybrid.factor_solve_hybrid(torch.tensor(T), torch.tensor(v),
                                         dinv=torch.tensor(dinv))
    for res in ranks:
        x = res[f"fs_{dt}_x"]
        assert x.dtype == np.dtype(dt)
        assert _rel(x, want) <= tol
        assert _rel(x, port.numpy()) <= tol


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_tp_factor_bytes_per_rank(ranks, dt):
    """Each rank holds only its block rows of the factor: at most 0.75 of
    the single-process factor's bytes (0.3 and 0.7 at m = 256, P = 2)."""
    T, _, _ = W.tp_matrix(dt)
    fac = hybrid.factor_hybrid(torch.tensor(T))
    full = sum(t.numel() * t.element_size()
               for t in fac.Gs + [P for P in fac.Ps if P is not None])
    for res in ranks:
        assert int(res[f"fs_{dt}_bytes"]) <= 0.75 * full


def test_tp_misaligned_raises(ranks):
    for res in ranks:
        assert "divisible" in str(res["misaligned"])


@pytest.mark.parametrize("neq", [0, 4])
def test_tp_prefactor_matches_plain(ranks, neq):
    """``prefactor_qp_tp`` against ``prefactor_qp``, field by field, 1e-9,
    the same fields None."""
    Q, _, G, _, A, _ = W.prefactor_args(neq)
    want = qt.prefactor_qp(*(None if a is None else torch.tensor(a)
                             for a in (Q, G, A)), device="cpu")
    for res in ranks:
        none = set(res[f"pf{neq}_none"].tolist())
        for name, val in want._asdict().items():
            if val is None or not isinstance(val, torch.Tensor):
                assert (val is None) == (name in none), name
                continue
            npt.assert_allclose(res[f"pf{neq}_{name}"], val.numpy(),
                                atol=1e-9, err_msg=name)


def test_tp_factors_solve_and_differentiate(ranks):
    """A solve and a p gradient with the tensor-parallel factors against
    the JAX package's ``prefactor_qp_tp`` on a 4 x 2 mesh (1e-9 / 1e-8)."""
    args = [jnp.asarray(a) for a in W.prefactor_args(4, nz=24, nineq=12)]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("batch", "model"))
    f_tp = jax_prefactor_qp_tp(args[0], args[2], args[4], mesh=mesh)

    @jax.jit
    def run(f, *a):
        z = qpth_tpu.solve_qp_full(*a, factors=f).z
        g = jax.grad(lambda p_: jnp.sum(qpth_tpu.solve_qp(
            a[0], p_, *a[2:], factors=f) ** 2))(a[1])
        return z, g

    z, gp = run(f_tp, *args)
    for res in ranks:
        npt.assert_allclose(res["tpf_z"], np.asarray(z), atol=1e-9)
        npt.assert_allclose(res["tpf_dp"], np.asarray(gp), atol=1e-8)


@pytest.mark.parametrize("tag,n,neq,dt,its,tol", [
    ("f32", W.N_QP_TP, 0, "float32", 8, 1e-5),
    ("f32_eq", W.N_QP_TP, W.NEQ_QP_TP, "float32", 6, 1e-5),
    ("f64", W.N_QP_TP64, 0, "float64", 8, 1e-10)])
def test_solve_qp_tp_matches_single_process(ranks, tag, n, neq, dt, its,
                                            tol):
    """``solve_qp_tp`` (n = m = 256, B = 1, float32, without and with 16
    equality rows; float64 in substitution mode at n = m = 128) against the
    port's single-process ``"hybrid_xla"`` solve, relative to max |z|,
    with the same iterations on both ranks."""
    args = [None if a is None else torch.tensor(a)
            for a in W.huge_qp(n, neq, dt)]
    cfg = qt.SolverConfig(check_Q_spd=False, verbose=-1, max_iter=its,
                          use_pallas="hybrid_xla")
    want = qt.solve_qp_full(*args, config=cfg, device="cpu")
    for res in ranks:
        assert _rel(res[f"tp_{tag}_z"], want.z.numpy()) <= tol
        assert int(res[f"tp_{tag}_its"]) == int(want.stats.iterations)
        if neq:
            assert np.isfinite(res[f"tp_{tag}_nu"]).all()


@pytest.mark.parametrize("neq", [0, 3])
def test_hybrid_xla_matches_jax(neq):
    """``use_pallas="hybrid_xla"`` in one process (the hybrid backend,
    float64, inverse mode) against the JAX package's, 1e-9, with equal
    iterations (at eps = 1e-10: the default 1e-12 is the score's rounding
    floor, where the exit iteration is set by rounding; ROADMAP.md §3). In
    substitution mode (the float64 default) the JAX
    package's value fails: its hybrid backend's ``solve2`` is handed Q's
    Cholesky factor (ROADMAP.md §3); the port's runs, and equals
    ``"hybrid"``."""
    Q, p, G, h, A, b = make_feasible_qp(np.random.RandomState(3), nz=10,
                                        nineq=6, neq=neq, nbatch=4)
    arrs = (Q, p, G, h, A, b)
    targs = [None if a is None else torch.tensor(a) for a in arrs]
    sol = qt.solve_qp_full(*targs, config=qt.SolverConfig(
        eps=1e-10, use_pallas="hybrid_xla", solve_method="inverse"),
        device="cpu")
    cfg = qpth_tpu.SolverConfig(eps=1e-10, use_pallas="hybrid_xla",
                                solve_method="inverse")
    want = jax.jit(lambda *a: qpth_tpu.solve_qp_full(*a, config=cfg))(
        *(None if a is None else jnp.asarray(a) for a in arrs))
    npt.assert_allclose(sol.z.numpy(), np.asarray(want.z), atol=1e-9)
    assert int(sol.stats.iterations) == int(want.stats.iterations)
    sub = qt.solve_qp_full(*targs, config=qt.SolverConfig(
        use_pallas="hybrid_xla"), device="cpu")
    ref = qt.solve_qp_full(*targs, config=qt.SolverConfig(
        use_pallas="hybrid"), device="cpu")
    npt.assert_array_equal(sub.z.numpy(), ref.z.numpy())
    npt.assert_allclose(sub.z.numpy(), np.asarray(want.z), atol=1e-9)


def test_hybrid_xla_is_the_hybrid_backend():
    """In one process "hybrid_xla" resolves to the hybrid backend, with
    inverse-mode products below float64, as "hybrid" does."""
    from qpth_tpu_torch.ops import kkt as kkt_ops

    for dt in (torch.float32, torch.float64):
        be = kkt_ops.resolve_backend("hybrid_xla", dt, 300, "cuda")
        assert be.solve2 is hybrid.solve_hybrid and be.fused_step is None
        cfg = qt.SolverConfig(use_pallas="hybrid_xla")
        assert (kkt_ops.resolve_prefactor_modes(cfg, dt)
                == kkt_ops.resolve_prefactor_modes(
                    dataclasses.replace(cfg, use_pallas="hybrid"), dt))
