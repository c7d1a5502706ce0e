"""The port's profiling helpers (``qpth_tpu_torch.profiling``)."""

import json
import math

import numpy as np
import pytest
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


# ---- The solver's spans (``profiling.span``) ------------------------------

def _owner(e):
    """The innermost ``qpth.*`` range that encloses event ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("qpth."):
        p = p.cpu_parent
    return None if p is None else p.name


def _spans(fn):
    """Run ``fn`` under ``torch.profiler`` on the CPU; returns its result
    and the ``qpth.*`` events in order of start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted((e for e in prof.events() if e.name.startswith("qpth.")),
                key=lambda e: e.time_range.start)
    return out, ev


#: The enclosing ``qpth.*`` span each span may have.
PARENTS = {
    "qpth.solve": {None},
    "qpth.prefactor": {"qpth.solve", "qpth.backward", None},
    "qpth.ipm.init": {"qpth.solve"},
    "qpth.ipm.loop": {"qpth.solve"},
    "qpth.ipm.finish": {"qpth.solve"},
    "qpth.ipm.score": {"qpth.ipm.loop"},
    "qpth.ipm.exit": {"qpth.ipm.loop"},
    "qpth.ipm.step": {"qpth.ipm.loop"},
    "qpth.ipm.step.factor": {"qpth.ipm.step"},
    "qpth.ipm.step.solve": {"qpth.ipm.step"},
    "qpth.backward": {None},
    "qpth.backward.solve": {"qpth.backward"},
    "qpth.backward.grads": {"qpth.backward"},
}


#: The spans of a composed step (``core/pdipm.py::pc_direction``), which a
#: fused step records none of.
COMPOSED = ("qpth.ipm.step.factor", "qpth.ipm.step.solve")


@pytest.mark.parametrize("dtype, use_pallas, composed", [
    (torch.float32, "auto", False),      # inverse mode: the fused step
    (torch.float64, "auto", True),       # substitution mode: composed
    (torch.float32, "blocked", True),    # inverse mode, no fused kernel
], ids=["f32-fused", "f64-composed", "f32-blocked-composed"])
def test_spans_of_a_solve_and_its_backward(dtype, use_pallas, composed):
    """A forward+backward records the span tree of ``profiling.SPANS``:
    one ``qpth.ipm.score`` and ``qpth.ipm.exit`` per iteration, a step on
    each but the one that exits, and one ``qpth.sync`` per host read: the
    SPD check, the Ruiz probe (below float64 only), one a loop iteration
    and the INACC check. A fused step records no span inside it; a
    composed one records one ``qpth.ipm.step.factor`` (the factor of T
    with its first solve) and a ``qpth.ipm.step.solve`` for each further
    solve (the corrector and each Gondzio pass)."""
    cfg = qt.SolverConfig(use_pallas=use_pallas)
    args = [a.to(dtype) for a in _qp()]
    its = int(qt.solve_qp_full(*args, config=cfg,
                               device="cpu").stats.iterations)
    assert its < cfg.max_iter

    leaves = [a.clone().requires_grad_(True) for a in args]

    def fwd_bwd():
        z = qt.solve_qp(*leaves, config=cfg, device="cpu")
        z.sum().backward()
        return z

    _, ev = _spans(fwd_bwd)
    names = [e.name for e in ev]
    expected = [n for n in profiling.SPANS if composed or n not in COMPOSED]
    assert set(names) == set(expected)
    count = {n: names.count(n) for n in profiling.SPANS}
    assert count["qpth.ipm.score"] == count["qpth.ipm.exit"] == its
    assert count["qpth.ipm.step"] == its - 1
    if composed:
        assert count["qpth.ipm.step.factor"] == its - 1
        assert count["qpth.ipm.step.solve"] == (its - 1) * (
            1 + cfg.n_correctors)
    for n in ("qpth.solve", "qpth.prefactor", "qpth.ipm.init",
              "qpth.ipm.loop", "qpth.ipm.finish", "qpth.backward",
              "qpth.backward.solve", "qpth.backward.grads"):
        assert count[n] == 1, n
    probe = dtype == torch.float32
    syncs = [_owner(e) for e in ev if e.name == "qpth.sync"]
    assert syncs == (["qpth.solve"] + ["qpth.prefactor"] * probe
                     + ["qpth.ipm.exit"] * its + ["qpth.ipm.finish"])
    for e in ev:
        if e.name != "qpth.sync":
            assert _owner(e) in PARENTS[e.name], (e.name, _owner(e))
    # The phases run in order and the backward after the forward; in a
    # composed step the factor comes before its further solves.
    first = {n: names.index(n) for n in expected}
    assert (first["qpth.solve"] < first["qpth.prefactor"]
            < first["qpth.ipm.init"] < first["qpth.ipm.loop"]
            < first["qpth.ipm.finish"] < first["qpth.backward"]
            < first["qpth.backward.solve"] < first["qpth.backward.grads"])
    if composed:
        steps = [e for e in ev if e.name == "qpth.ipm.step"]
        for step in steps:
            inner = [e.name for e in ev if e.name in COMPOSED
                     and e.cpu_parent is not None
                     and e.cpu_parent.id == step.id]
            assert inner == (["qpth.ipm.step.factor"]
                             + ["qpth.ipm.step.solve"]
                             * (1 + cfg.n_correctors)), inner


def test_prefactor_span_outside_a_solve():
    """``prefactor_qp`` records one ``qpth.prefactor`` on its own; a
    backward without saved factors rebuilds them inside
    ``qpth.backward``."""
    Q, _, G, _ = _qp()
    _, ev = _spans(lambda: qt.prefactor_qp(Q, G, device="cpu"))
    assert [(e.name, _owner(e)) for e in ev
            if e.name != "qpth.sync"] == [("qpth.prefactor", None)]

    leaves = [a.clone().requires_grad_(True) for a in _qp()]
    cfg = qt.SolverConfig(save_factors_for_backward=False)

    def fwd_bwd():
        qt.solve_qp(*leaves, config=cfg, device="cpu").sum().backward()

    _, ev = _spans(fwd_bwd)
    pre = [_owner(e) for e in ev if e.name == "qpth.prefactor"]
    assert pre == ["qpth.solve", "qpth.backward"]


def test_span_without_profiler_is_the_shared_null(monkeypatch):
    """With no profiler running, ``span`` hands back one shared
    ``nullcontext`` and creates no ``record_function``, through a whole
    solve and its backward."""
    assert profiling.span("qpth.solve") is profiling._NULL
    assert profiling.span("qpth.sync") is profiling._NULL

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) without profiler")

    monkeypatch.setattr(profiling, "record_function", no_range)
    leaves = [a.clone().requires_grad_(True) for a in _qp()]
    qt.solve_qp(*leaves, device="cpu").sum().backward()
    assert all(a.grad is not None for a in leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_profiler_leaves_results_bit_identical(dtype):
    """z and the four gradients are the same bits with the profiler on and
    off."""
    def run():
        leaves = [a.to(dtype).requires_grad_(True) for a in _qp()]
        z = qt.solve_qp(*leaves, device="cpu")
        grads = torch.autograd.grad((z * z).sum(), leaves)
        return [z.detach()] + list(grads)

    off = run()
    on, _ = _spans(run)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_trace_names_the_ipm_step(tmp_path):
    """``profiling.trace``'s Chrome file carries the solver's spans."""
    with profiling.trace(str(tmp_path)):
        qt.solve_qp_full(*_qp(), device="cpu")
    (f,) = tmp_path.glob("*.json")
    names = {e.get("name", "") for e in json.loads(f.read_text())
             ["traceEvents"]}
    assert {"qpth.solve", "qpth.ipm.loop", "qpth.ipm.step",
            "qpth.sync"} <= names
