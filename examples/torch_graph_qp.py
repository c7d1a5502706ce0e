#!/usr/bin/env python3
"""Learning a graph-structured QP layer on the PyTorch/CUDA port, through
``SpQPFunction``'s fixed-pattern tiers.

The task of ``examples/graph_qp.py`` (the JAX script): denoise signals on
a randomly labelled chain graph,

    minimize_z  1/2 sum_i q_i (z_i - y_i)^2 + 1/2 sum_(i,j) w_ij (z_i - z_j)^2
    subject to  z_i - z_j <= c_ij   on a set of difference constraints,

whose Q has the graph's adjacency as its pattern and whose constraints
are two-entry rows. The edge weights w_ij are learned (gradients land on
the COO values) with ``torch.optim.SGD``, the JAX script's plain gradient
step. The construction-time reverse-Cuthill-McKee reordering recovers the
chain, so the general tier runs at banded cost however the nodes are
numbered. As in the reference, an automatically chosen general pattern
with n < 512 is densified below float64: ``--dtype float64`` or
``--structure general`` runs the general tier.

The graph and the constraints come from the JAX script's numpy draws
(seed 0); the signals are drawn with numpy here (the JAX script uses
``jax.random``). Nothing is downloaded.

    python examples/torch_graph_qp.py [--steps 30] [--device cuda]

Runs on CUDA unless ``--device cpu`` is given; without CUDA it raises.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import qpth_tpu_torch as qt  # noqa: E402


def make_graph(n, seed=0):
    """The JAX script's graph: a chain with scrambled node labels, Q's
    pattern (the diagonal, then both triangles of each edge) and
    difference constraints on n // 3 random edges. Returns (label, Qi, Gi,
    n_edges, m)."""
    rng = np.random.RandomState(seed)
    label = rng.permutation(n)
    edges = [(int(label[i]), int(label[i + 1])) for i in range(n - 1)]
    qi = [(i, i) for i in range(n)]
    for (a, b) in edges:
        qi += [(a, b), (b, a)]
    cons = [edges[k] for k in rng.choice(len(edges), size=n // 3,
                                         replace=False)]
    gi = []
    for r, (a, b) in enumerate(cons):
        gi += [(r, a), (r, b)]
    return label, np.array(qi).T, np.array(gi).T, len(edges), len(cons)


def make_batch(rng, B, label):
    """Piecewise-constant signals along the chain (sparse jumps), scattered
    to the node labels, and their noisy copies: (noisy, clean)."""
    n = label.size
    jumps = (rng.rand(B, n) < 0.08) * rng.randn(B, n)
    clean = np.zeros((B, n))
    clean[:, label] = np.cumsum(jumps, axis=1)
    noisy = clean + 0.3 * rng.randn(B, n)
    return noisy, clean


class GraphDenoiser(torch.nn.Module):
    """The QP layer with learnable log edge weights (shared across the
    batch; zero, i.e. w = 1, at the start)."""

    def __init__(self, Qi, Gi, n, n_edges, m, structure="auto",
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.n, self.n_edges, self.m = n, n_edges, m
        self.Qi = Qi
        self.f = qt.SpQPFunction(
            Qi, (n, n), Gi, (m, n), np.zeros((2, 0), int), (0, n),
            config=qt.SolverConfig(verbose=-1, check_Q_spd=False),
            structure=structure, device=device)
        self.logw = torch.nn.Parameter(torch.zeros(n_edges, dtype=dtype,
                                                   device=device))

    def forward(self, noisy):
        B, n, E = noisy.shape[0], self.n, self.n_edges
        w = torch.exp(self.logw)
        ends = torch.as_tensor(self.Qi[:, n:n + 2 * E:2], device=w.device)
        # Q values: q_i + the incident weights on the diagonal, -w on both
        # triangles of each edge.
        deg = w.new_zeros(n).index_add(0, ends[0], w).index_add(0, ends[1], w)
        Qv = torch.cat([(1.0 + deg).expand(B, n),
                        (-w).repeat_interleave(2).expand(B, 2 * E)], dim=1)
        p = -noisy
        Gv = torch.tensor([1.0, -1.0], dtype=w.dtype,
                          device=w.device).repeat(self.m).expand(B, 2 * self.m)
        h = torch.full((B, self.m), 0.8, dtype=w.dtype, device=w.device)
        empty = w.new_zeros((B, 0))
        return self.f(Qv, p, Gv, h, empty, empty)


def loss_fn(model, noisy, clean):
    return ((model(noisy) - clean) ** 2).mean()


def train(model, opt, rng, label, batch, steps, log=print):
    """``steps`` optimizer steps on fresh batches drawn by ``rng``; returns
    the losses."""
    dev, dt = model.logw.device, model.logw.dtype
    losses = []
    t0 = time.time()
    for i in range(steps):
        noisy, clean = (torch.tensor(a, dtype=dt, device=dev)
                        for a in make_batch(rng, batch, label))
        opt.zero_grad()
        loss = loss_fn(model, noisy, clean)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log and (i % 5 == 0 or i == steps - 1):
            log(f"step {i:3d}: loss {losses[-1]:.4f} "
                f"({time.time() - t0:.1f}s)")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.15)
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    ap.add_argument("--structure", choices=["auto", "general", "dense"],
                    default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("qpth_tpu_torch: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    dtype = getattr(torch, args.dtype)
    n = args.nodes
    label, Qi, Gi, n_edges, m = make_graph(n)
    model = GraphDenoiser(Qi, Gi, n, n_edges, m, structure=args.structure,
                          device=device, dtype=dtype)
    f = model.f
    tier = f._tier(model.logw)
    print(f"pattern: n={n}, {n_edges} edges, {m} difference constraints "
          f"-> structure={f.structure}, this dtype's tier {tier}"
          + (f" (bs={f._band[1]}, nb={f._band[2]} after RCM)"
             if f.structure == "general" else ""))
    rng = np.random.RandomState(1)
    noisy0, clean0 = make_batch(rng, args.batch, label)
    base = float(np.mean((noisy0 - clean0) ** 2))
    print(f"noisy-input MSE {base:.4f}")
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    losses = train(model, opt, rng, label, args.batch, args.steps)
    print(f"{args.steps} steps; final loss {losses[-1]:.4f} "
          f"(vs {base:.4f} un-denoised)")
    return losses, base, tier


if __name__ == "__main__":
    main()
