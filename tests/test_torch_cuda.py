"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; these tests import only the port.)
"""

import numpy as np
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch.ops.cuda import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _spd(bR, m, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    L = torch.rand(bR, m, m, generator=g, dtype=torch.float64)
    R = L @ L.transpose(1, 2) / m + torch.eye(m, dtype=torch.float64)
    return R.to(dtype=dtype, device=device)


def _vecs(B, m, dtype, device, seed=1, lo=0.5):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(B, m, generator=g, dtype=torch.float64) + lo).to(
        dtype=dtype, device=device) for _ in range(3)]


TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", ["inv", "solve", "solve_rz"])
def test_factor_inv_kernel_matches_plain(cuda, variant, shared, dtype):
    B, m = 64, 37
    R = _spd(1 if shared else B, m, dtype, cuda)
    dinv, rhs, z = _vecs(B, m, dtype, cuda)
    args = {"inv": (R, dinv), "solve": (R, dinv, rhs),
            "solve_rz": (R, dinv, rhs, z)}[variant]
    got = kernels.factor_inv(*args)
    torch.cuda.synchronize()
    want = kernels.factor_inv_plain(*args)
    got, want = ((got,), (want,)) if variant == "inv" else (got, want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n_correctors", [0, 2])
def test_ipm_step_kernel_matches_plain(cuda, n_correctors, shared, dtype):
    B, m = 64, 37
    R = _spd(1 if shared else B, m, dtype, cuda)
    s, z, q = _vecs(B, m, dtype, cuda)
    got = kernels.ipm_step_xfree(R, s, z, q - 1.0, n_correctors)
    torch.cuda.synchronize()
    want = kernels.ipm_step_xfree_plain(R, s, z, q - 1.0, n_correctors)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10


def test_solve_on_card_matches_cpu(cuda):
    r = np.random.RandomState(0)
    L = r.rand(16, 20, 20)
    Q = L @ L.transpose(0, 2, 1) + np.eye(20)
    G = r.randn(16, 18, 20)
    h = G @ r.randn(16, 20)[..., None]
    h = h[..., 0] + r.rand(16, 18)
    p = r.randn(16, 20)
    cfg = qt.SolverConfig(solve_method="inverse", resid_every=7)
    args = [torch.tensor(v) for v in (Q, p, G, h)]
    kernels.reset_launches()
    on_card = qt.solve_qp_full(*args, config=cfg)
    assert kernels.LAUNCHES["ipm_step_xfree"] > 0
    on_cpu = qt.solve_qp_full(*args, config=cfg, device="cpu")
    assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < 1e-8
