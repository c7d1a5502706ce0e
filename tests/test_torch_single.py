"""``qpth_tpu_torch.solve_single`` (``core/single.py``), the unbatched
solver, against ``qpth_tpu.core.single.solve_single`` on the same inputs:
float64 to 1e-9 with equal iterations, with and without equality rows."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.core.single import solve_single as jax_solve_single
from qpth_tpu_torch.core.single import SingleSolution

from conftest import make_feasible_qp

torch.set_num_threads(1)


def _qp(neq, nz=12, nineq=9, seed=1):
    Q, p, G, h, A, b = make_feasible_qp(np.random.RandomState(seed), nz=nz,
                                        nineq=nineq, neq=neq)
    return Q + np.eye(nz), p, G, h, A, b


def _both(data, **kw):
    cj = qpth_tpu.SolverConfig(**kw)
    ct = qt.SolverConfig(**kw)
    sj = jax_solve_single(*(None if v is None else jnp.asarray(v)
                            for v in data), config=cj)
    st = qt.solve_single(*(None if v is None else torch.tensor(v)
                           for v in data), config=ct, device="cpu")
    return sj, st


@pytest.mark.parametrize("neq", [0, 3])
def test_solve_single_matches_jax(neq):
    sj, st = _both(_qp(neq))
    assert isinstance(st, SingleSolution)
    assert st._fields == sj._fields
    for name in ("z", "nu", "lam", "s", "resid"):
        want = np.asarray(getattr(sj, name))
        got = getattr(st, name)
        assert tuple(got.shape) == want.shape, name
        npt.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9,
                            err_msg=name)
    assert int(st.iterations) == int(sj.iterations)
    assert st.iterations.dtype == torch.int32


@pytest.mark.parametrize("max_iter", [0, 3])
def test_solve_single_iteration_cap_matches_jax(max_iter):
    """The loop's exit (max_iter, then eps) as the JAX while_loop's."""
    sj, st = _both(_qp(3, nz=20, nineq=15, seed=4), max_iter=max_iter)
    assert int(st.iterations) == int(sj.iterations) == max_iter
    npt.assert_allclose(st.z.numpy(), np.asarray(sj.z), rtol=1e-9,
                        atol=1e-9)


def test_solve_single_agrees_with_the_batched_solver():
    """One lane of the batched solver at float64 gives the same z."""
    data = _qp(3)
    st = qt.solve_single(*(torch.tensor(v) for v in data), device="cpu")
    batched = qt.solve_qp_full(*(torch.tensor(v)[None] for v in data),
                               config=qt.SolverConfig(eps=1e-12,
                                                      refine_steps=0),
                               device="cpu")
    npt.assert_allclose(st.z.numpy(), batched.z[0].numpy(), atol=1e-8)


def test_solve_single_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qt.solve_single(*(torch.tensor(v) for v in _qp(0)[:4]))
