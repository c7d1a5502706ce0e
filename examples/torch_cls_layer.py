#!/usr/bin/env python3
"""OptNet classification-layer example on the PyTorch/CUDA port: train
FC-ReLU-FC-ReLU-QP-log_softmax (``qpth_tpu_torch.nn.OptNetClassifier``) on
a synthetic classification task with ``torch.optim.Adam``, gradients
flowing through the QP layer into L, G, z0, s0 and the FC weights. The
flags, defaults and data are those of ``examples/cls_layer.py`` (the JAX
script); nothing is downloaded.

    python examples/torch_cls_layer.py [--steps 50] [--device cuda]

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


def make_data(n_features, n_cls, batch, seed):
    """The JAX script's task: class = argmax of a random linear map of the
    input. Returns (rng, x_all, y_all); ``rng`` then draws the batches."""
    rng = np.random.RandomState(seed)
    W_true = rng.randn(n_features, n_cls)
    x_all = rng.randn(batch * 4, n_features).astype(np.float32)
    y_all = (x_all @ W_true).argmax(-1)
    return rng, x_all, y_all


def loss_fn(model, x, y):
    """Mean negative log-likelihood of the labels."""
    logp = model(x)
    return -logp[torch.arange(x.shape[0], device=x.device), y].mean()


def train(model, opt, rng, x_all, y_all, batch, steps, log=print):
    """``steps`` Adam steps on batches drawn by ``rng``; returns the
    losses."""
    p0 = next(model.parameters())
    dev, dt = p0.device, p0.dtype
    losses = []
    t0 = time.time()
    for i in range(steps):
        idx = rng.choice(len(x_all), batch, replace=False)
        x = torch.tensor(x_all[idx], dtype=dt, device=dev)
        y = torch.tensor(y_all[idx], device=dev)
        opt.zero_grad()
        loss = loss_fn(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log and (i % 10 == 0 or i == steps - 1):
            log(f"step {i:4d}  loss {losses[-1]:.4f}  "
                f"({time.time() - t0:.1f}s)")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-features", type=int, default=50)
    ap.add_argument("--n-hidden", type=int, default=64)
    ap.add_argument("--n-cls", type=int, default=10)
    ap.add_argument("--n-ineq", type=int, default=50)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng, x_all, y_all = make_data(args.n_features, args.n_cls, args.batch,
                                  args.seed)
    model = qt.nn.OptNetClassifier(
        n_features=args.n_features, n_hidden=args.n_hidden,
        n_cls=args.n_cls, n_ineq=args.n_ineq, device=args.device,
        generator=torch.Generator().manual_seed(args.seed))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = train(model, opt, rng, x_all, y_all, args.batch, args.steps)

    with torch.no_grad():
        logp = model(torch.tensor(x_all, device=model.L.device))
    acc = float((logp.argmax(-1).cpu().numpy() == y_all).mean())
    print(f"final train accuracy: {acc:.3f}")
    return losses, acc


if __name__ == "__main__":
    main()
