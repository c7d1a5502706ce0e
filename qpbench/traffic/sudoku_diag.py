"""The QP of the OptNet sudoku layer (arXiv:1703.00443 section 5.3; upstream
qpth's sudoku example at n = 2) in the diagonal tier's form, made on the
device from the run's generator:

    q = q_eps (Q = q_eps I), g = -1 (G = -I), h = 0: fixed by the layer;
    A ~ U(0, 1)^(neq x nx) per shared entry (the learned A at some step),
    b = A z0 with z0 = 2 / nx (an interior point: z0 > 0, A z0 = b);
    p = -puzzle per lane: each entry -1 with probability given_share.

``chip_smoke.py::make_sudoku``'s draw, in its order.
"""

from __future__ import annotations

import torch


def draw(config, cell, gen, device):
    n, k = config["nx"], config["neq"]
    dt = getattr(torch, config["dtype"])
    kw = dict(generator=gen, device=device, dtype=dt)
    A = torch.rand((cell["pool_shared"], k, n), **kw)
    z0 = torch.full((n,), 2.0 / n, device=device, dtype=dt)
    b = torch.matmul(A, z0)
    given = torch.rand((cell["pool_lanes"], n), **kw) < config["given_share"]
    p = -given.to(dt)
    inputs = {
        "q": (torch.full((n,), config["q_eps"], device=device, dtype=dt),
              "const"),
        "p": (p, "lane"),
        "g": (torch.full((n,), -1.0, device=device, dtype=dt), "const"),
        "h": (torch.zeros((n,), device=device, dtype=dt), "const"),
        "A": (A, "shared"), "b": (b, "shared")}
    return inputs, {"z0": (z0, "const")}


def as_dense(x):
    """One batch's inputs as the reference's (Q, p, G, h, A, b): Q = diag(q)
    and G = diag(g) as dense matrices, every matrix with a batch
    dimension (1 where shared), every vector per lane."""
    p = x["p"]
    B = p.shape[0]
    return (torch.diag(x["q"]).unsqueeze(0), p,
            torch.diag(x["g"]).unsqueeze(0), x["h"].expand(B, -1),
            x["A"].unsqueeze(0), x["b"].expand(B, -1))
