"""Kernel A of the PyTorch port in its R z variant
(``factor_inv(R, dinv, rhs, z)``) against the TPU kernel
``factor_inv_solve_rz_lanes`` in Pallas interpret mode, plus the float64
recurrence against numpy, NaN on a non-SPD lane, and operand checks. On a
CPU tensor the wrapper takes its plain PyTorch version, which is what runs
here."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.lanes import factor_inv_solve_rz_lanes
from qpth_tpu_torch.ops.cuda import kernels

from test_torch_kernels import (B, CASES, SIZES, _lanes, _problem,
                                _unlanes)

torch.set_num_threads(1)


@CASES
@SIZES
def test_factor_inv_solve_rz_matches_pallas(n, shared):
    R, dinv, v, z = _problem(200 + n, n, shared)
    G, x = factor_inv_solve_rz_lanes(_lanes(R), jnp.asarray(dinv.T),
                                     jnp.asarray(v.T), jnp.asarray(z.T),
                                     interpret=True)
    Linv, xt = kernels.factor_inv(torch.tensor(R), torch.tensor(dinv),
                                  torch.tensor(v), torch.tensor(z))
    npt.assert_allclose(Linv.numpy(), _unlanes(G, n), atol=2e-5)
    npt.assert_allclose(xt.numpy(), np.asarray(x).T, atol=2e-3)


@CASES
@SIZES
def test_factor_inv_f64_exact(n, shared):
    """At float64 the recurrence is inv(cholesky(T)) to rounding, and the
    rz variant solves T x = rhs - R z."""
    R, dinv, v, z = _problem(300 + n, n, shared, np.float64)
    T = R + np.stack([np.diag(d) for d in dinv])
    Linv, x = kernels.factor_inv(torch.tensor(R), torch.tensor(dinv),
                                 torch.tensor(v), torch.tensor(z))
    npt.assert_allclose(Linv.numpy(), np.linalg.inv(np.linalg.cholesky(T)),
                        atol=1e-12)
    rhs = v - np.einsum("bij,bj->bi", np.broadcast_to(R, T.shape), z)
    npt.assert_allclose(x.numpy(), np.linalg.solve(T, rhs[..., None])[..., 0],
                        atol=1e-12, rtol=1e-12)


def test_factor_inv_non_spd_lane_is_nan():
    """A lane whose T is not SPD comes back NaN (and only that lane), so
    the solver can freeze it."""
    R, dinv, _, _ = _problem(7, 9, shared=False)
    R[2] = -R[2]
    Linv = kernels.factor_inv(torch.tensor(R), torch.tensor(dinv))
    bad = torch.isnan(Linv).flatten(1).any(dim=1)
    assert bad.tolist() == [i == 2 for i in range(B)]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "z_alone"])
def test_factor_inv_rejects_bad_operands(case):
    R, dinv, v, z = (torch.tensor(a) for a in _problem(1, 6, shared=False))
    if case == "dtype":
        with pytest.raises(TypeError):
            kernels.factor_inv(R.half(), dinv.half())
    elif case == "shape":
        with pytest.raises(ValueError):
            kernels.factor_inv(R[:3], dinv)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            kernels.factor_inv(R.transpose(1, 2), dinv)
    else:
        with pytest.raises(ValueError):
            kernels.factor_inv(R, dinv, z=z)
