"""The port's profiling helpers (``qpth_tpu_torch.profiling``)."""

import json
import math

import numpy as np
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch import profiling

from conftest import make_feasible_qp

torch.set_num_threads(1)


def _qp():
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(2), nz=6,
                                        nineq=4, nbatch=4)
    return [torch.tensor(a) for a in (Q, p, G, h)]


def test_trace_writes_a_trace_naming_the_solve(tmp_path):
    """``trace`` yields its directory and leaves a Chrome trace there whose
    events name the solve's ops."""
    args = _qp()
    with profiling.trace(str(tmp_path / "tr")) as d:
        qt.solve_qp_full(*args, device="cpu")
    assert d == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "bmm" in n for n in names), sorted(names)[:20]


def test_solve_timings_counts_calls():
    """``solve_timings`` calls the function trials + 1 times and returns
    two finite positive floats."""
    args = _qp()
    calls = []

    def fn(*a):
        calls.append(1)
        return qt.solve_qp_full(*a, device="cpu")

    first, best = profiling.solve_timings(fn, *args, trials=4)
    assert len(calls) == 5
    for t in (first, best):
        assert isinstance(t, float) and math.isfinite(t) and t > 0
