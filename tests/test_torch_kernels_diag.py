"""Kernel 11's plain version (``kernels.diag_step_plain``, what the CUDA
``diag_step`` is held against on the card) against the TPU kernel
``qpth_tpu.ops.pallas.diagstep.diag_step_lanes`` in interpret mode, on one
step's inputs. The test builds the lanes layout itself: M (q_p, q_p, B)
and A (q_p, n_p, 1) padded to multiples of 8, g (n, 1) shared or (n, B),
the vectors (n, B) / (q, B).

Interpret mode takes float64 (the kernel body has no dtype cast), so the
float64 case runs the same algorithm in both packages to 1e-12 of the
outputs' scale; float32 to 1e-5."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.diagstep import diag_step_lanes
from qpth_tpu.ops.pallas.lanes import pad_up
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _step_inputs(rng, B, n, neq, g_batched, nan_lane=None):
    """One interior iterate of a diagonal-tier QP: the operands of a step
    and M = A diag(1/H) A^T from them. ``nan_lane`` gets a non-SPD M."""
    A = rng.randn(neq, n)
    g = -(0.5 + rng.rand(B if g_batched else 1, n))
    s = 0.5 + rng.rand(B, n)
    z = 0.5 + rng.rand(B, n)
    H = 0.5 + rng.rand(B, n) + g * g * z / s
    M = np.einsum("in,bn,jn->bij", A, 1.0 / H, A)
    if nan_lane is not None:
        M[nan_lane] = -M[nan_lane]
    vec = dict(rx=rng.randn(B, n), rz=rng.randn(B, n), ry=rng.randn(B, neq),
               x=rng.randn(B, n), s=s, z=z, y=rng.randn(B, neq))
    return M, A, g, H, vec


def _lanes(M, A, g, H, vec, dtype, n_correctors):
    """diag_step_lanes on the batch-major inputs; batch-major outputs."""
    B, neq, _ = M.shape
    n = A.shape[1]
    q_p, n_p = pad_up(neq), pad_up(n)
    M_t = np.zeros((q_p, q_p, B))
    M_t[:neq, :neq] = M.transpose(1, 2, 0)
    A_t = np.zeros((q_p, n_p, 1))
    A_t[:neq, :n, 0] = A

    def t(v):
        return jnp.asarray(np.ascontiguousarray(v.T), dtype)

    out = diag_step_lanes(
        jnp.asarray(M_t, dtype), jnp.asarray(A_t, dtype), t(g), t(H),
        t(vec["rx"]), t(vec["rz"]), t(vec["ry"]), t(vec["x"]), t(vec["s"]),
        t(vec["z"]), t(vec["y"]), n_correctors=n_correctors, interpret=True)
    return [np.asarray(o).T for o in out]


def _plain(M, A, g, H, vec, dtype, n_correctors):
    def t(v):
        return torch.tensor(v, dtype=dtype)

    return [o.numpy() for o in kernels.diag_step(
        t(M), t(A[None]), t(g), t(H), t(vec["rx"]), t(vec["rz"]),
        t(vec["ry"]), t(vec["x"]), t(vec["s"]), t(vec["z"]), t(vec["y"]),
        n_correctors)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("g_batched", [False, True],
                         ids=["g_shared", "g_batched"])
@pytest.mark.parametrize("n_correctors", [0, 2])
def test_diag_step_plain_matches_pallas(n_correctors, g_batched, dtype):
    B, n, neq = 8, 13, 5
    M, A, g, H, vec = _step_inputs(np.random.RandomState(0), B, n, neq,
                                   g_batched, nan_lane=3)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    kernels.reset_launches()
    got = _plain(M, A, g, H, vec, tdt, n_correctors)
    assert kernels.LAUNCHES["diag_step"] == 0      # the CPU launches none
    want = _lanes(M, A, g, H, vec, dtype, n_correctors)
    for name, a, b in zip(("x", "s", "z", "y"), got, want):
        assert a.dtype == dtype and np.isfinite(a).all(), name
        scale = max(1.0, float(np.abs(b).max()))
        npt.assert_allclose(a, b, rtol=0, atol=TOL[dtype] * scale,
                            err_msg=name)
    # Lane 3's M is not SPD: both freeze it; the others move.
    for a, key in zip(got, ("x", "s", "z", "y")):
        npt.assert_array_equal(a[3], vec[key][3].astype(dtype))
        assert np.abs(a[[0, 1, 2, 4]] - vec[key][[0, 1, 2, 4]]).max() > 0


def test_diag_step_checks_its_operands():
    B, n, neq = 4, 6, 2
    M, A, g, H, vec = _step_inputs(np.random.RandomState(1), B, n, neq,
                                   False)
    args = [torch.tensor(v) for v in (M, A[None], g, H, vec["rx"],
                                      vec["rz"], vec["ry"], vec["x"],
                                      vec["s"], vec["z"], vec["y"])]
    with pytest.raises(ValueError, match="g must be"):
        kernels.diag_step(*args[:2], args[2][:, :5], *args[3:])
    with pytest.raises(ValueError, match="matrix must be"):
        kernels.diag_step(args[0], args[1][:, :, :5], *args[2:])
    assert kernels.diag_step_fits(64, 40, torch.float32)
    # One neq x neq tile, 5 neq-vectors, 10 n-vectors and 8 words of
    # reduction scratch: at neq = 40, 40^2 + 5 * 40 + 8 = 1808 words leave
    # (58112 - 1808) / 10 = 5630.4 n-vectors' worth in float32 and
    # (29056 - 1808) / 10 = 2724.8 in float64.
    assert kernels.diag_step_fits(5630, 40, torch.float32)
    assert not kernels.diag_step_fits(5631, 40, torch.float32)
    assert kernels.diag_step_fits(2724, 40, torch.float64)
    assert not kernels.diag_step_fits(2725, 40, torch.float64)
    assert not kernels.diag_step_fits(64, 0, torch.float32)
    assert not kernels.diag_step_fits(300, 257, torch.float32)
