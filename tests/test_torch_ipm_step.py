"""Kernel B of the PyTorch port (``qpth_tpu_torch/ops/cuda/kernels.py::
ipm_step_xfree``) against the TPU kernel it replaces,
``ipm_step_xfree_lanes``, in Pallas interpret mode. On a CPU tensor the
wrapper takes its plain PyTorch version, which is what runs here.

Every batch has one lane whose R + diag(s/z) is not SPD: both versions
must freeze it (alpha = 0, s' = s, z' = z, zeta = z) and leave the other
lanes alone."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.lanes import ipm_step_xfree_lanes, pad_spd_lanes
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

B = 8
BAD = 3  # the lane whose T is not SPD


def _problem(seed, m, shared):
    """R = A A^T - 2 I, so T = R + diag(s/z) is SPD for s/z in [3, 4] and
    not SPD for s/z in [0.5, 1] (lane BAD). s, z > 0 throughout."""
    rng = np.random.RandomState(seed)
    bR = 1 if shared else B
    A = rng.rand(bR, m, m).astype(np.float32) / np.sqrt(m)
    R = (A @ A.transpose(0, 2, 1) - 2.0 * np.eye(m)).astype(np.float32)
    z = (rng.rand(B, m) + 0.5).astype(np.float32)
    ratio = rng.rand(B, m) + 3.0
    ratio[BAD] = rng.rand(m) * 0.5 + 0.5
    s = (z * ratio).astype(np.float32)
    q = rng.randn(B, m).astype(np.float32)
    return R, s, z, q


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("m", [7, 13])
def test_ipm_step_xfree_matches_pallas(m, n_correctors, shared):
    R, s, z, q = _problem(10 * m + n_correctors, m, shared)
    R_t = pad_spd_lanes(jnp.asarray(R.transpose(1, 2, 0)))
    zeta_j, s_j, z_j, a_j = (
        np.asarray(o) for o in ipm_step_xfree_lanes(
            R_t, jnp.asarray(s.T), jnp.asarray(z.T), jnp.asarray(q.T),
            n_correctors=n_correctors, interpret=True))
    zeta, s1, z1, alpha = (o.numpy() for o in kernels.ipm_step_xfree(
        torch.tensor(R), torch.tensor(s), torch.tensor(z), torch.tensor(q),
        n_correctors))

    npt.assert_allclose(zeta, zeta_j.T, atol=2e-4, rtol=1e-3)
    npt.assert_allclose(s1, s_j.T, atol=2e-4, rtol=1e-3)
    npt.assert_allclose(z1, z_j.T, atol=2e-4, rtol=1e-3)
    npt.assert_allclose(alpha, a_j[0], atol=1e-5)

    ok = np.arange(B) != BAD
    assert alpha[BAD] == 0.0 and a_j[0, BAD] == 0.0
    npt.assert_array_equal(s1[BAD], s[BAD])
    npt.assert_array_equal(z1[BAD], z[BAD])
    npt.assert_array_equal(zeta[BAD], z[BAD])
    assert (alpha[ok] > 0).all()
