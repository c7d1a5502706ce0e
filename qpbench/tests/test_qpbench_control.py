"""The control comes out not correct, and the program correct, on the
card: the reference itself in the program's place, in float32 with TF32
products (the precision below the configurations' float32 with TF32
off), judged by each benchmarked cell's own numbers and limits, at a
batch a test run can hold (512 lanes a call; the cells' own 4096 are
read by ``qpbench/readings.py``)."""

import json

import pytest
import torch

import qpth_tpu_torch as qt
from qpbench import check, harness

BENCHMARK = json.loads((harness.BENCH.parent / "BENCHMARK.json")
                       .read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def readings(name, seed, control):
    cell, config = harness.load_cell(name)
    cell.update(batch=512, pool_lanes=1024)
    device = torch.device("cuda")
    pool = harness.Pool(config, cell, seed, device)
    plan = harness.Plan(pool, seed)
    solver = qt.SolverConfig(**config["solver_config"])
    call = harness.make_call(config, cell, solver, qt, device)
    kept = []
    for i in range(cell["check_calls"]):
        j, o = plan.next()
        cot = None if pool.cot is None else pool.cotangent(o)
        kept.append((i, (j, o, call(pool.batch(j, o), cot))))

    def tf32(x, cot):
        return check.reference_outputs(x, cot, pool, config, cell,
                                       dtype=torch.float32, tf32=True)

    numbers, _ = check.readings(kept, pool, cell, config,
                                outputs=tf32 if control else None)
    return {k: numbers[k] <= v for k, v in cell["limits"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert all(readings(name, seed, control=False).values())
    assert not all(readings(name, seed, control=True).values())
