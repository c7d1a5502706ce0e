"""The work counts behind ``kernels.roofline_share``: equal to hand counts
at tiny shapes, and a least time that a plain run never beats."""

import pytest

from qpbench import harness
from qpbench.tests.conftest import tiny

H100 = "NVIDIA H100 80GB HBM3"


def work(name):
    return harness.load_module(harness.BENCH / "work" / f"{name}.py")


def test_dense_hand_count():
    # n = m = 2, B = 1, 3 iterations, forward, every operand per lane.
    # Prefactor: chol(Q) 8/3 flops, reads 4 and writes 3 words; L^-1 G^T
    # 8 flops, reads 3 + 4, writes 4; R = W^T W 8 flops, reads 4, writes 3.
    # Factors: init + 2 steps = 3, each 8/3 flops, reads R (3) and d (2),
    # writes L (3). Solves: init + 2 x 2 = 5, each 8 flops, reads L (3)
    # and the right-hand side (2), writes 2.
    config = {"nz": 2, "nineq": 2, "dtype": "float32"}
    cell = {"batch": 1, "shared": [], "mode": "forward"}
    flops, nbytes = work("dense_ipm").count(config, cell, 3)
    assert flops == pytest.approx(8 / 3 + 8 + 8 + 3 * 8 / 3 + 5 * 8)
    assert nbytes == 4 * ((4 + 3) + (3 + 4 + 4) + (4 + 3)
                          + 3 * (3 + 2 + 3) + 5 * (3 + 2 + 2))


def test_dense_shared_prefactor_counts_once():
    config = {"nz": 2, "nineq": 2, "dtype": "float64"}
    one = {"batch": 1, "shared": ["Q", "G"], "mode": "train"}
    many = dict(one, batch=5)
    f1, b1 = work("dense_ipm").count(config, one, 3)
    f5, b5 = work("dense_ipm").count(config, many, 3)
    pre_f = 8 / 3 + 8 + 8
    # train: 4 factors, 6 solves a lane; R read once a factor when shared.
    assert f5 - pre_f == pytest.approx(5 * (f1 - pre_f))
    assert b5 == 8 * (25 + 4 * 3 + 5 * (4 * (2 + 3) + 6 * (3 + 2 + 2)))


def test_diag_hand_count():
    # n = 3, k = 2, B = 2, 2 iterations, forward+backward, A shared.
    # Factors: init + 1 step + backward = 3, each per lane k^2 n = 12 flops
    # for M and 8/3 for its Cholesky; A (6 words) read once, H (3) read
    # and M (3) written per lane, then M read (3) and L written (3).
    # Solves: init + 2 + backward = 4, each 8 flops a lane, reading L (3)
    # and the right-hand side (2), writing 2.
    config = {"nx": 3, "neq": 2, "dtype": "float32"}
    cell = {"batch": 2, "shared": ["A"], "mode": "train"}
    flops, nbytes = work("diag_ipm").count(config, cell, 2)
    assert flops == pytest.approx(3 * 2 * (12 + 8 / 3) + 4 * 2 * 8)
    assert nbytes == 4 * (3 * (6 + 2 * (3 + 3) + 2 * (3 + 3))
                          + 4 * 2 * (3 + 2 + 2))


@pytest.mark.parametrize("name", ["dense100.fwd", "sudoku4.diag_fwd"])
def test_least_time_below_a_plain_run(name):
    """A plain (CPU) run of the traced calls takes longer than the least
    time the H100 needs for their counted work: the share reads <= 1."""
    cell, config = tiny(name)
    result = harness.run(cell, config, seed=5, seconds=0.2, traced=True,
                         device="cpu")
    its = result["metrics"]["ipm.iterations"]["value"]
    least = harness.least_seconds(config, cell, [its] * cell["trace_calls"],
                                  H100)
    assert 0 < least <= result["device"]["window_s"]


def test_unknown_card_has_no_least_time():
    cell, config = harness.load_cell("dense100.fwd")
    assert harness.least_seconds(config, cell, [20], "Some Other GPU") \
        is None


def test_roofline_reader():
    m = {x.NAME: x for x in harness.metric_modules()}[
        "kernels.roofline_share"]
    assert m.read({"trace": {"busy_s": None, "least_s": 1.0}}) is None
    assert m.read({"trace": {"busy_s": 2.0, "least_s": None}}) is None
    assert m.read({"trace": {"busy_s": 2.0, "least_s": 0.5}}) == 25.0
