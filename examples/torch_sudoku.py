#!/usr/bin/env python3
"""OptNet sudoku example on the PyTorch/CUDA port: learn the constraint
matrix A of 2x2 sudoku (``qpth_tpu_torch.nn.OptNetSudoku(n=2, n_eq=40)``)
purely from (puzzle, solution) pairs through the implicit-KKT gradient dA,
with ``torch.optim.Adam``. The flags, defaults and synthetic data are those
of ``examples/sudoku.py`` (the JAX script); nothing is downloaded.

It runs in float64, as the JAX script does: the random uniform A has a
badly conditioned Gram matrix that float32 cannot factor reliably.

    python examples/torch_sudoku.py [--steps 40] [--device cuda]

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

DTYPE = torch.float64


def gen_sudoku_data(rng, n_samples, n=2):
    """Tiny 2x2 sudoku generator: one-hot boards (n^2, n^2, n^2) with a
    random subset revealed as the puzzle."""
    N = n ** 2
    boards = []
    base = np.array([[1, 2, 3, 4], [3, 4, 1, 2], [2, 1, 4, 3], [4, 3, 2, 1]])
    for _ in range(n_samples):
        perm = rng.permutation(N) + 1
        board = perm[base - 1]
        boards.append(board)
    boards = np.stack(boards)  # (S, 4, 4) values 1..4
    onehot = np.eye(N)[boards - 1]  # (S, 4, 4, 4)
    mask = rng.rand(n_samples, N, N) < 0.5
    puzzles = onehot * mask[..., None]
    return puzzles.reshape(n_samples, -1).astype(np.float64), \
        onehot.reshape(n_samples, -1).astype(np.float64)


def loss_fn(model, x, y):
    """Mean squared error of the predicted boards."""
    return ((model(x) - y) ** 2).mean()


def train(model, opt, rng, puzzles, solutions, batch, steps, log=print):
    """``steps`` Adam steps on batches drawn by ``rng``; returns the
    losses."""
    dev = model.A.device
    losses = []
    t0 = time.time()
    for i in range(steps):
        idx = rng.choice(len(puzzles), batch, replace=False)
        x = torch.tensor(puzzles[idx], dtype=DTYPE, device=dev)
        y = torch.tensor(solutions[idx], dtype=DTYPE, device=dev)
        opt.zero_grad()
        loss = loss_fn(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log and (i % 10 == 0 or i == steps - 1):
            log(f"step {i:4d}  mse {losses[-1]:.5f}  "
                f"({time.time() - t0:.1f}s)")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    puzzles, solutions = gen_sudoku_data(rng, args.samples)
    model = qt.nn.OptNetSudoku(
        n=2, n_eq=40, device=args.device, dtype=DTYPE,
        generator=torch.Generator().manual_seed(args.seed))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = train(model, opt, rng, puzzles, solutions, args.batch,
                   args.steps)

    with torch.no_grad():
        pred = model(torch.tensor(puzzles, dtype=DTYPE,
                                  device=model.A.device)).cpu().numpy()
    cell_acc = float(
        (pred.reshape(-1, 4).argmax(-1)
         == solutions.reshape(-1, 4).argmax(-1)).mean())
    print(f"final cell accuracy: {cell_acc:.3f}")
    return losses, cell_acc


if __name__ == "__main__":
    main()
