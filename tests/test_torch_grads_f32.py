"""Gradients of the PyTorch port's float32 default path against the JAX
package's float32 Pallas path (``use_pallas=True``, interpret mode on the
CPU), to Q, p, G and h. The JAX backward goes through the TPU kernel
``factor_inv_solve_lanes``; the port's through its kernel A's plain
version (rhs variant)."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from test_torch_qp_f32 import CFG_PALLAS, _data

torch.set_num_threads(1)


def test_grads_f32_match_pallas():
    """Both sides' gradients carry float32 rounding of the size of their
    gap to the float64 gradients; the tolerance is 5e-4 of each
    gradient's largest entry."""
    Q, p, G, h = (v.astype(np.float32) for v in _data("batched"))
    w = np.random.RandomState(9).randn(8, 9).astype(np.float32)

    def loss(Q, p, G, h):
        z = qpth_tpu.solve_qp(Q, p, G, h, config=CFG_PALLAS)
        return jnp.sum(z * w)

    gj = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (Q, p, G, h)))
    args = [torch.tensor(v, requires_grad=True) for v in (Q, p, G, h)]
    z = qt.solve_qp(*args, device="cpu")
    (z * torch.tensor(w)).sum().backward()
    for name, a, b in zip("QpGh", args, gj):
        b = np.asarray(b)
        npt.assert_allclose(a.grad.numpy(), b, rtol=0,
                            atol=5e-4 * np.abs(b).max(), err_msg=name)
