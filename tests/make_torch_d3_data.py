#!/usr/bin/env python3
"""Write ``tests/data_torch_d3.npz``: one lane of ``chip_smoke.py``'s path 1
(bench.py's draws at B = 4096, nz = nineq = 100 with 50 equality rows,
seed 0, Q + 1.0 I), rounded to float32 as the card solves it. It is lane
2106, whose float32 backward meets a T that is not SPD (ROADMAP §3 D3).
From the repository root, on the CPU:

    python tests/make_torch_d3_data.py

Contents: ``Q``, ``p``, ``G``, ``h``, ``A``, ``b`` of that lane, each with
a batch dimension of 1, float32.
"""

import os

import numpy as np

B, NZ, NINEQ, NEQ = 4096, 100, 100, 50
SEED, LANE, Q_SHIFT = 0, 2106, 1.0
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data_torch_d3.npz")


def draw_lane(lane, seed=SEED, chunk=256):
    """``chip_smoke.make_problem(B, NZ, NINEQ, seed, NEQ)``'s lane ``lane``
    with Q shifted as path 1 shifts it, drawn ``chunk`` lanes at a time
    (the same stream of draws) so that the whole batch is never held."""
    npr = np.random.RandomState(seed)
    c0 = lane - lane % chunk

    def take(fn, *shape):
        out = None
        for c in range(0, B, chunk):
            x = fn(chunk, *shape)
            if c == c0:
                out = x[lane - c0:lane - c0 + 1]
        return out

    L = take(npr.rand, NZ, NZ)
    G = take(npr.randn, NINEQ, NZ)
    z0 = take(npr.randn, NZ)
    s0 = take(npr.rand, NINEQ)
    p = take(npr.randn, NZ)
    A = take(npr.randn, NEQ, NZ)
    Q = np.matmul(L, L.transpose(0, 2, 1)) + 1e-3 * np.eye(NZ)
    Q = Q + Q_SHIFT * np.eye(NZ)
    h = np.einsum("bmn,bn->bm", G, z0) + s0
    b = np.einsum("bmn,bn->bm", A, z0)
    return Q, p, G, h, A, b


def main():
    arrs = draw_lane(LANE)
    np.savez_compressed(DATA, **{k: v.astype(np.float32)
                                 for k, v in zip("QpGhAb", arrs)})
    print(f"wrote {DATA}")


if __name__ == "__main__":
    main()
