"""Random feasible dense QPs, the draw of qpth's ``prof-gurobi.py:51-61``
(and ``bench.py::make_problem``), made on the device from the run's
generator:

    Q = L L^T + 1e-3 I,  L ~ U(0, 1)^(nz x nz);   G ~ N(0, 1)^(nineq x nz);
    z0 ~ N(0, 1)^nz;  s0 ~ U(0, 1)^nineq;  p ~ N(0, 1)^nz;  h = G z0 + s0,

so z0 is strictly feasible. A cell that lists Q and G under ``shared``
gets them as layer parameters (one per shared entry, batch 1) with p and h
per lane, h = G_j z0 + s0 for every pair of shared entry and lane (the
OptNet-layer form of ``chip_smoke.py`` phase 5).
"""

from __future__ import annotations

import torch


def draw(config, cell, gen, device):
    n, m = config["nz"], config["nineq"]
    dt = getattr(torch, config["dtype"])
    lanes, entries = cell["pool_lanes"], cell["pool_shared"]
    shared = set(cell["shared"])
    kw = dict(generator=gen, device=device, dtype=dt)

    def lead(name):
        return (entries,) if name in shared else (lanes,)

    L = torch.rand(lead("Q") + (n, n), **kw)
    Q = torch.matmul(L, L.transpose(-1, -2))
    del L
    Q.diagonal(dim1=-2, dim2=-1).add_(1e-3)
    G = torch.randn(lead("G") + (m, n), **kw)
    z0 = torch.randn((lanes, n), **kw)
    s0 = torch.rand((lanes, m), **kw)
    p = torch.randn((lanes, n), **kw)
    kind = {name: "shared" if name in shared else "lane" for name in "QG"}
    if "G" in shared:
        h = torch.einsum("smn,ln->slm", G, z0) + s0
        kind["h"] = "shared_lane"
    else:
        h = torch.matmul(G, z0.unsqueeze(-1)).squeeze(-1) + s0
        kind["h"] = "lane"
    inputs = {"Q": (Q, kind["Q"]), "p": (p, "lane"), "G": (G, kind["G"]),
              "h": (h, kind["h"])}
    return inputs, {"z0": (z0, "lane"), "s0": (s0, "lane")}


def as_dense(x):
    """One batch's inputs as the reference's (Q, p, G, h, A, b), every
    matrix with a batch dimension (1 where shared)."""
    Q, G = x["Q"], x["G"]
    return (Q if Q.dim() == 3 else Q.unsqueeze(0), x["p"],
            G if G.dim() == 3 else G.unsqueeze(0), x["h"], None, None)
