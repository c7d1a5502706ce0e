"""A run with the timed path broken underneath comes out not correct, for
every fault a cell can have (``qpbench/faults.py``; the exchange between
cards is not one: every cell runs on one card), and a sound run comes out
correct. The run is the harness's own, on the CPU at a tiny size, past
its look for a card."""

import pytest

import qpth_tpu_torch as qt
from qpbench import faults, harness
from qpbench.tests.conftest import CELLS, tiny


def run_with(name, fault, seed):
    cell, config = tiny(name)
    with faults.FAULTS[fault](qt, config):
        return harness.run(cell, config, seed=seed, seconds=0.1,
                           traced=False, device="cpu")


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    result = run_with(name, fault, seed=2 ** 31 + 77)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell, config = tiny(name)
    result = harness.run(cell, config, seed=2 ** 31 + 77, seconds=0.1,
                         traced=False, device="cpu")
    assert result["correct"] is True, result["checks"]


def test_faults_are_removed_on_exit():
    cell, config = tiny("sudoku4.diag_fwd")
    entries = {n: getattr(qt, n) for n in config["entry"].values()}
    from qpth_tpu_torch.core import diag
    from qpth_tpu_torch.ops.cuda import kernels
    kept = (kernels.ipm_step_xfree, diag.solve_kkt_diag)
    for fault in faults.FAULTS.values():
        with fault(qt, config):
            pass
    assert {n: getattr(qt, n) for n in entries} == entries
    assert (kernels.ipm_step_xfree, diag.solve_kkt_diag) == kept
