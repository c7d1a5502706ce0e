"""The reading of the program's spans (``qpbench/spans.py``) on a synthetic
event list, beside ``trace.reduce`` on the same list, and on a traced CPU
run."""

from types import SimpleNamespace

import pytest
from torch.profiler import DeviceType

from qpbench import spans, trace
from qpbench.tests.conftest import tiny

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


#: Two traced calls (microseconds). The first: a prefactor with a read, a
#: loop whose step's kernel runs on after the step has closed on the host,
#: a read in the exit test with its copy, a kernel launched in the solve
#: that starts 10 us before its launch, one launched outside every span; an
#: aten op shares a launch's correlation id. The second: a read in a solve
#: that launches nothing, then a backward whose grads launch one kernel.
EVENTS = [
    ev(trace.CALL, 0, 1000),
    ev("qpth.solve", 10, 900),
    ev("qpth.prefactor", 25, 100),
    ev("cudaLaunchKernel", 30, 35, id=1),
    ev("qpth.sync", 60, 95),
    ev("qpth.ipm.loop", 150, 800),
    ev("qpth.ipm.step", 200, 300),
    ev("aten::add", 205, 216, id=2),
    ev("cudaLaunchKernel", 210, 215, id=2),
    ev("qpth.ipm.exit", 500, 700),
    ev("qpth.sync", 510, 690),
    ev("cudaMemcpyAsync", 520, 525, id=6),
    ev("cudaLaunchKernel", 850, 855, id=3),
    ev("cudaLaunchKernel", 950, 952, id=4),
    ev(trace.CALL, 1100, 1200),
    ev("qpth.solve", 1110, 1135),
    ev("qpth.sync", 1120, 1130),
    ev("qpth.backward", 1140, 1190),
    ev("qpth.backward.grads", 1150, 1180),
    ev("cudaLaunchKernel", 1160, 1162, id=7),
    # The device side.
    ev("factor_inv_kernel", 40, 90, CUDA, id=1),
    ev("ipm_step_kernel", 220, 500, CUDA, id=2),
    ev("qpth.ipm.step", 210, 500, CUDA, id=2, annotation=True),
    ev(trace.CALL, 0, 1000, CUDA),
    ev("Memcpy DtoH", 600, 605, CUDA, id=6),
    ev("gemv2T_kernel", 840, 880, CUDA, id=3),
    ev("elementwise_kernel", 955, 990, CUDA, id=4),
    ev("reduce_kernel", 1165, 1175, CUDA, id=7),
]


class Prof:
    def events(self):
        return EVENTS


def approx(d):
    return {k: pytest.approx(v, abs=1e-12) for k, v in d.items()}


def test_reduce_reads_what_it_read():
    """``trace.reduce`` on the list: each of its keys as before the spans
    (the spans' device copy and the call's are no device operations)."""
    t = trace.reduce(Prof())
    assert set(t) == {"busy_s", "window_s", "device_ops", "breakdown"}
    assert t["busy_s"] == pytest.approx(420e-6)
    assert t["window_s"] == pytest.approx(1200e-6)
    assert t["device_ops"] == 6
    assert approx(dict(t["breakdown"]["device_ops"])) == {
        "ipm_step_kernel": 280e-6, "factor_inv_kernel": 50e-6,
        "gemv2T_kernel": 40e-6, "elementwise_kernel": 35e-6,
        "reduce_kernel": 10e-6, "Memcpy DtoH": 5e-6}
    assert approx(dict(t["breakdown"]["idle_gaps"])) == {
        "qpth.solve": 40e-6, "qpth.ipm.loop": 365e-6, "qpth.sync": 100e-6,
        trace.CALL: 75e-6, "(between calls)": 175e-6,
        "qpth.backward": 25e-6}


def test_read_attributes_by_launch():
    r = spans.read(EVENTS)
    t = trace.reduce(Prof())
    assert r["calls"] == 2
    assert r["busy_s"] == pytest.approx(t["busy_s"])
    assert r["window_s"] == pytest.approx(t["window_s"])
    assert r["device_ops"] == t["device_ops"]
    # The step's kernel belongs to the step, where it was launched, though
    # it runs on after the step has closed; the copy to the read.
    assert approx(r["device_s"]) == {
        "qpth.prefactor": 50e-6, "qpth.ipm.step": 280e-6,
        "qpth.sync": 5e-6, "qpth.solve": 40e-6, spans.OUTSIDE: 35e-6,
        "qpth.backward.grads": 10e-6}
    assert approx(r["device_incl_s"]) == {
        "qpth.prefactor": 50e-6, "qpth.solve": 375e-6,
        "qpth.ipm.loop": 285e-6, "qpth.ipm.step": 280e-6,
        "qpth.ipm.exit": 5e-6, "qpth.sync": 5e-6, spans.OUTSIDE: 35e-6,
        "qpth.backward": 10e-6, "qpth.backward.grads": 10e-6}
    assert r["device_ops_by_span"][spans.OUTSIDE] == 1
    assert r["clock_skew_ops"] == 1
    assert r["clock_skew_by_span"] == {"qpth.solve": 1}
    assert r["clock_skew_max_us"] == pytest.approx(10.0)
    assert r["clock_skew_by_call"] == [1, 0]
    assert r["unlaunched_ops"] == 0
    assert r["span_device_copies"] == 0
    ops = dict(r["ops"])
    assert approx(ops["gemv2T_kernel"]) == {"qpth.solve": 40e-6}


def test_read_labels_idle_by_span():
    """The gaps of ``reduce``, by ``qpth.*`` spans only; the loop's idle
    takes the read inside its exit test too."""
    r = spans.read(EVENTS)
    assert approx(r["idle_s"]) == {
        "qpth.solve": 40e-6, "qpth.ipm.loop": 365e-6, "qpth.sync": 100e-6,
        spans.OUTSIDE: 250e-6, "qpth.backward": 25e-6}
    assert r["loop_idle_s"] == pytest.approx(465e-6)
    assert sum(r["idle_s"].values()) == pytest.approx(
        r["window_s"] - r["busy_s"])


def test_read_counts_syncs_and_spans():
    r = spans.read(EVENTS)
    assert r["syncs"] == 3
    assert r["spans"]["qpth.solve"] == 2
    assert r["spans"]["qpth.ipm.step"] == 1


def test_layer_metrics():
    m = spans.layer_metrics(spans.read(EVENTS))
    assert m == pytest.approx({
        "prefactor.share": 100 * 50 / 420,
        "ipm.loop_idle_share": 100 * 465 / 1200,
        "host.syncs_per_call": 1.5,
        "backward.grads_share": 100 * 10 / 420})


def test_no_spans_reads_as_nothing():
    """A program without the spans: no reading, every metric None."""
    plain = [e for e in EVENTS if not e.name.startswith(spans.PREFIX)]
    assert spans.read(plain) is None
    assert set(spans.layer_metrics(None).values()) == {None}
    assert spans.read([e for e in EVENTS if e.name != trace.CALL]) is None


def test_forward_only_has_no_grads_share():
    fwd = [e for e in EVENTS if not e.name.startswith("qpth.backward")]
    m = spans.layer_metrics(spans.read(fwd))
    assert m["backward.grads_share"] is None
    assert m["prefactor.share"] is not None


@pytest.mark.parametrize("name", ["dense100.fwd", "dense100.optnet_train"])
def test_traced_cpu_run_counts_syncs(name):
    """On the CPU the reading gives the syncs a call, and no device
    metric: the SPD check is off, so one read for the Ruiz probe, one an
    iteration and one for the INACC check."""
    cell, config = tiny(name)
    result, r = spans.run_with_spans(cell, config, seed=2 ** 31 + 7,
                                     seconds=0.1, device="cpu")
    assert result["correct"]
    assert trace.reduce.__name__ == "reduce"
    m = spans.layer_metrics(r)
    its = result["metrics"]["ipm.iterations"]["value"]
    assert m["host.syncs_per_call"] == its + 2
    assert m["prefactor.share"] is None
    assert m["ipm.loop_idle_share"] is None
    assert m["backward.grads_share"] is None
    assert r["spans"]["qpth.solve"] == r["calls"]
    assert ("qpth.backward" in r["spans"]) == (cell["mode"] == "train")
