"""Kernel A of the PyTorch port (``qpth_tpu_torch/ops/cuda/kernels.py::
factor_inv``) against the TPU kernels it replaces, run in Pallas interpret
mode: ``factor_inv_lanes`` and ``factor_inv_solve_lanes`` here, the R z
variant ``factor_inv_solve_rz_lanes`` in tests/test_torch_kernels_rz.py.
On a CPU tensor the wrapper takes its plain PyTorch version, which is what
runs here. Tolerances are those of tests/test_lanes_kernels.py
(float32)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.lanes import (factor_inv_lanes,
                                       factor_inv_solve_lanes,
                                       pad_spd_lanes)
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

B = 8


def _problem(seed, n, shared, dtype=np.float32):
    rng = np.random.RandomState(seed)
    bR = 1 if shared else B
    L0 = rng.rand(bR, n, n).astype(dtype)
    R = L0 @ L0.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)
    dinv = (rng.rand(B, n) + 0.5).astype(dtype)
    v = rng.randn(B, n).astype(dtype)
    z = rng.randn(B, n).astype(dtype)
    return R, dinv, v, z


def _lanes(R):
    return pad_spd_lanes(jnp.asarray(R.transpose(1, 2, 0)))


def _unlanes(G, n):
    return np.asarray(G).transpose(2, 0, 1)[:, :n, :n]


CASES = pytest.mark.parametrize("shared", [False, True],
                                ids=["batched", "shared"])
SIZES = pytest.mark.parametrize("n", [7, 10, 13])


@CASES
@SIZES
def test_factor_inv_matches_pallas(n, shared):
    R, dinv, _, _ = _problem(n, n, shared)
    G = factor_inv_lanes(_lanes(R), jnp.asarray(dinv.T), interpret=True)
    Linv = kernels.factor_inv(torch.tensor(R), torch.tensor(dinv))
    npt.assert_allclose(Linv.numpy(), _unlanes(G, n), atol=2e-5)


@CASES
@SIZES
def test_factor_inv_solve_matches_pallas(n, shared):
    R, dinv, v, _ = _problem(100 + n, n, shared)
    G, x = factor_inv_solve_lanes(_lanes(R), jnp.asarray(dinv.T),
                                  jnp.asarray(v.T), interpret=True)
    Linv, xt = kernels.factor_inv(torch.tensor(R), torch.tensor(dinv),
                                  torch.tensor(v))
    npt.assert_allclose(Linv.numpy(), _unlanes(G, n), atol=2e-5)
    npt.assert_allclose(xt.numpy(), np.asarray(x).T, atol=2e-4, rtol=1e-3)
