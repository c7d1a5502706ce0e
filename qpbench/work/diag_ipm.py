"""The work a diagonal-structure QP solve needs (Q = diag(q), G = diag(g),
nineq = nx, neq equality rows), counted from its shapes: the least
floating-point operations and bytes of memory traffic that any
implementation of the interior point method moves.

Slack elimination leaves H = q + g^2 d elementwise, so the only dense
algebra is the equality rows' M = A diag(1/H) A^T (neq x neq). Counted,
with nx = n and neq = k, every operand read once and every result written
once per operation (a triangle where the result is symmetric or
triangular):

* per lane, the initial point: M's product (k^2 n, symmetric), its
  Cholesky factor (k^3 / 3) and one solve (2 k^2);
* per lane and stepping iteration: M's product, its factor and two solves
  (predictor and corrector); a solve that reports k iterations steps at
  least k - 1 times;
* per lane of a forward+backward call, the backward's product, factor and
  one solve.

A is read once per product when it is shared, and once per lane otherwise.
The elementwise work on n-vectors is left out, so the count is a lower
bound of the solve's work.
"""

from __future__ import annotations


def _tri(k):
    return k * (k + 1) / 2


def count(config, cell, iterations):
    """(flops, bytes) of one call that reported ``iterations``."""
    n, k = config["nx"], config["neq"]
    B = cell["batch"]
    word = 8 if config["dtype"] == "float64" else 4
    a_reads = 1 if "A" in set(cell["shared"]) else B

    factors = 1 + max(int(iterations) - 1, 0)
    solves = 1 + 2 * max(int(iterations) - 1, 0)
    if cell["mode"] == "train":
        factors += 1
        solves += 1
    flops = factors * B * (k * k * n + k ** 3 / 3) + solves * B * 2 * k * k
    words = factors * (a_reads * k * n + B * (n + _tri(k))    # M
                       + B * 2 * _tri(k))                     # chol(M)
    words += solves * B * (_tri(k) + 2 * k)
    return flops, words * word
