"""OptNet layers as ``torch.nn.Module``s (counterpart of
``qpth_tpu/nn.py``): upstream qpth's example models with the
differentiable QP layer inside, for PyTorch training loops.

Parameters are made on ``device`` (CUDA unless asked for the CPU) in
``dtype``, drawn from ``generator`` when given. To start from a JAX model's
parameters use :func:`qpth_tpu_torch.convert.optnet_params_from_numpy`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .config import SolverConfig
from .diagqp import solve_qp_diag
from .qp import _device, solve_qp


def _uniform(shape, lo, hi, device, dtype, generator):
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device if generator is not None
                   else device)
    return (lo + (hi - lo) * u).to(device)


def _linear(n_in, n_out, device, dtype, generator):
    """A ``torch.nn.Linear`` with its weight drawn from ``generator``
    (U(-1/sqrt(n_in), 1/sqrt(n_in)), torch's default bound) and a zero
    bias."""
    lin = nn.Linear(n_in, n_out, device=device, dtype=dtype)
    bound = 1.0 / math.sqrt(n_in)
    with torch.no_grad():
        lin.weight.copy_(_uniform((n_out, n_in), -bound, bound, device,
                                  dtype, generator))
        lin.bias.zero_()
    return lin


class OptNetClassifier(nn.Module):
    """FC-ReLU-FC-ReLU-QP-log_softmax classifier (upstream qpth's
    classification example).

    Learns ``L, G, z0, s0``; builds ``Q = (M*L)(M*L)^T + eps*I`` (M a
    lower-triangular mask) and ``h = G z0 + s0``, so the QP is SPD and
    strictly feasible by construction. No equality constraints; Q, G and h
    are shared across the batch, p is the features."""

    def __init__(self, n_features: int, n_hidden: int, n_cls: int,
                 n_ineq: int = 200, eps: float = 1e-4,
                 qp_config: SolverConfig = SolverConfig(verbose=-1),
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        dev = _device(device)
        self.eps, self.qp_config = eps, qp_config
        self.fc1 = _linear(n_features, n_hidden, dev, dtype, generator)
        self.fc2 = _linear(n_hidden, n_cls, dev, dtype, generator)
        self.L = nn.Parameter(torch.tril(_uniform(
            (n_cls, n_cls), 0.0, 1.0, dev, dtype, generator)))
        self.G = nn.Parameter(_uniform((n_ineq, n_cls), -1.0, 1.0, dev,
                                       dtype, generator))
        self.z0 = nn.Parameter(torch.zeros(n_cls, device=dev, dtype=dtype))
        self.s0 = nn.Parameter(torch.ones(n_ineq, device=dev, dtype=dtype))

    def forward(self, x):
        B = x.shape[0]
        x = torch.relu(self.fc1(x.reshape(B, -1)))
        x = torch.relu(self.fc2(x))
        n_cls = self.L.shape[0]
        M = torch.tril(torch.ones(n_cls, n_cls, dtype=x.dtype,
                                  device=x.device))
        Lm = (M * self.L).to(x.dtype)
        Q = Lm @ Lm.T + self.eps * torch.eye(n_cls, dtype=x.dtype,
                                             device=x.device)
        h = self.G @ self.z0 + self.s0
        z = solve_qp(Q, x, self.G.to(x.dtype), h.to(x.dtype),
                     config=self.qp_config, device=x.device)
        return torch.log_softmax(z, dim=-1)


class OptNetSudoku(nn.Module):
    """Sudoku layer (upstream qpth's sudoku example): fixed Q = eps*I,
    G = -I, h = 0 and b = 1; learns the equality-constraint matrix A
    through the implicit-KKT gradient dA.

    Q and G are diagonal, so by default (``structure="diag"``) the layer
    runs on the diagonal structured solver (one (n_eq x n_eq) factor per
    iteration); ``structure="dense"`` forces the dense layer."""

    def __init__(self, n: int = 2, q_penalty: float = 0.1, n_eq: int = 40,
                 structure: str = "diag",
                 qp_config: SolverConfig = SolverConfig(verbose=-1),
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        if structure not in ("diag", "dense"):
            raise ValueError(structure)
        dev = _device(device)
        self.n, self.q_penalty, self.n_eq = n, q_penalty, n_eq
        self.structure, self.qp_config = structure, qp_config
        nx = (n ** 2) ** 3
        self.A = nn.Parameter(_uniform((n_eq, nx), 0.0, 1.0, dev, dtype,
                                       generator))

    def forward(self, puzzles):
        B = puzzles.shape[0]
        nx = self.A.shape[-1]
        p = -puzzles.reshape(B, -1)
        dt, dev = p.dtype, p.device
        b = torch.ones(self.n_eq, dtype=dt, device=dev)
        h = torch.zeros(nx, dtype=dt, device=dev)
        A = self.A.to(dt)
        if self.structure == "diag":
            q = torch.full((nx,), self.q_penalty, dtype=dt, device=dev)
            g = torch.full((nx,), -1.0, dtype=dt, device=dev)
            z = solve_qp_diag(q, p, g, h, A, b, config=self.qp_config,
                              device=dev)
        else:
            Q = self.q_penalty * torch.eye(nx, dtype=dt, device=dev)
            G = -torch.eye(nx, dtype=dt, device=dev)
            z = solve_qp(Q, p, G, h, A, b, config=self.qp_config,
                         device=dev)
        return z.reshape(puzzles.shape)
