"""The work a dense QP solve needs, counted from its shapes: the least
floating-point operations and bytes of memory traffic that any
implementation of the interior point method of OptNet (arXiv:1703.00443)
moves, whatever kernels carry it out.

Counted, with nz = n, nineq = m, every operand read once and every result
written once per operation (a triangle where the result is triangular):

* the prefactor, once per distinct (Q, G): the Cholesky factor of Q
  (n^3 / 3 flops), W = L^-1 G^T (m n^2), R = W^T W = G Q^-1 G^T (m^2 n,
  symmetric);
* per lane, the initial point: one Cholesky factor of the reduced KKT
  matrix T = R + diag(d) (m^3 / 3) and one solve with it (2 m^2);
* per lane and stepping iteration: one factor of T and two solves (the
  predictor and the corrector); a solve that reports k iterations steps at
  least k - 1 times (the last iteration may only find the exit);
* per lane of a forward+backward call, the backward's factor of T and one
  solve.

Residuals, step lengths and the elementwise updates are left out, so the
count is a lower bound of the solve's work.
"""

from __future__ import annotations


def _tri(k):
    return k * (k + 1) / 2


def count(config, cell, iterations):
    """(flops, bytes) of one call that reported ``iterations``."""
    n, m = config["nz"], config["nineq"]
    B = cell["batch"]
    word = 8 if config["dtype"] == "float64" else 4
    shared = set(cell["shared"])
    # Distinct (Q, G) pairs prefactored in one call.
    pre = 1 if {"Q", "G"} <= shared else B

    flops = pre * (n ** 3 / 3 + m * n * n + m * m * n)
    words = pre * ((n * n + _tri(n))                 # chol(Q)
                   + (_tri(n) + 2 * m * n)           # W = L^-1 G^T
                   + (m * n + _tri(m)))              # R = W^T W

    factors = 1 + max(int(iterations) - 1, 0)
    solves = 1 + 2 * max(int(iterations) - 1, 0)
    if cell["mode"] == "train":
        factors += 1
        solves += 1
    # T = R + diag(d): R is read once per factor for a shared (Q, G) and
    # once per lane otherwise; d is read and L written per lane.
    flops += factors * B * m ** 3 / 3 + solves * B * 2 * m * m
    words += factors * (pre * _tri(m) + B * (m + _tri(m)))
    words += solves * B * (_tri(m) + 2 * m)
    return flops, words * word
