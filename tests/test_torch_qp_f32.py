"""The PyTorch port's float32 default path against the JAX package's
float32 Pallas path (``use_pallas=True``, interpret mode on the CPU): the
forward solve (gradients: tests/test_torch_grads_f32.py). The JAX run
goes through the TPU kernels ``factor_inv_lanes`` (prefactor),
``factor_inv_solve_rz_lanes`` (init) and ``ipm_step_xfree_lanes`` (every
iteration); the port through its kernels' plain versions.

Both sides carry float32 rounding of the same size, so the
port-vs-reference gap is the sum of two float32 errors; each test also
holds the port's z error against the float64 solution to at most twice
the reference's own. The exit iteration can flip when the checkpoint
residual (a float32 noise floor near 1e-3) straddles a power of 1000 of
eps, since the tracked score falls 1000x per step at alpha = 0.999; the
fixtures below are clear of that boundary."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from conftest import make_feasible_qp
from test_torch_qp import make_problem

torch.set_num_threads(1)

CFG_PALLAS = qpth_tpu.SolverConfig(use_pallas=True)
CFG_F64 = qpth_tpu.SolverConfig(solve_method="inverse", resid_every=7)


def _data(kind):
    """nz = 9, nineq = 7 (the shape of tests/test_fused_step.py): the
    Pallas interpret-mode trace grows with m, so small m keeps this fast."""
    if kind == "batched":
        return make_problem(8, 9, 7, seed=2)
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(2), nz=9,
                                        nineq=7, nbatch=8)
    return Q, p, G[0], h[0]


@pytest.mark.parametrize("kind", ["batched", "shared"])
def test_slice_f32_matches_pallas(kind):
    data = _data(kind)
    sj = qpth_tpu.solve_qp_full(
        *(jnp.asarray(v, jnp.float32) for v in data), config=CFG_PALLAS)
    st = qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                            for v in data), device="cpu")
    for name in ("z", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)),
                            atol=2e-4, rtol=1e-3, err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)

    z64 = np.asarray(qpth_tpu.solve_qp_full(
        *(jnp.asarray(v) for v in data), config=CFG_F64).z)
    err_port = np.abs(st.z.numpy() - z64).max()
    err_ref = np.abs(np.asarray(sj.z) - z64).max()
    assert err_port <= 2.0 * err_ref + 1e-5, (err_port, err_ref)

