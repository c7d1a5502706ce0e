"""The program's own spans in a traced run: the ``qpth.*`` ranges that
``qpth_tpu_torch.profiling.span`` records inside the solve and its
backward, read on the clock of the ``torch.profiler`` trace they share
with the device activity.

:func:`read` attributes each device operation of the traced calls to the
innermost ``qpth.*`` span open at its launch (the CPU runtime event,
``cudaLaunchKernel`` and kin, with the operation's correlation id), or to
``outside``; labels the idle gaps that ``trace.reduce`` derives by the
innermost span open at each gap's middle; and counts the ``qpth.sync``
spans, one for each device-to-host read of the program. One caller runs
the calls, and a backward runs while its caller waits, so the spans of all
threads nest in time and one sweep over them finds the innermost.
:func:`layer_metrics` turns that into the per-layer numbers the spans can
give. A program without the spans (before they existed) reads as nothing:
every number None.

Standing alone, the module runs one traced run of a cell with the reading
added (``harness.run`` with ``trace.reduce`` wrapped for that run):

    python3 qpbench/spans.py --workload CELL --seed N --seconds S

and prints the run's result line, then a line with the reading and the
metrics (``--out`` also writes them as JSON).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

from torch.profiler import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qpbench import harness, trace  # noqa: E402
from qpbench.run import _finite  # noqa: E402

PREFIX = "qpth."
SYNC = "qpth.sync"
LOOP = "qpth.ipm.loop"
PREFACTOR = "qpth.prefactor"
BACKWARD = "qpth.backward"
GRADS = "qpth.backward.grads"
OUTSIDE = "outside"
#: A device operation that starts more than this many microseconds before
#: its launch on the host shows the two clocks apart.
SKEW_US = 5.0
#: Host events that launch device work: the CUDA API calls (`cudaLaunchKernel`,
#: `cuLaunchKernel`, `cudaMemcpyAsync`, ...).
LAUNCH_PREFIX = "cu"
TOP = 12


def _cpu(e):
    return e.device_type == DeviceType.CPU


def _window(events):
    calls = sorted(e.time_range.start for e in events
                   if e.name == trace.CALL and _cpu(e))
    if not calls:
        return None
    end = max(e.time_range.end for e in events
              if e.name == trace.CALL and _cpu(e))
    return calls[0], end, calls


def _device_ops(events, w0, w1):
    """The device operations ``trace.reduce`` counts, by the same test."""
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != trace.CALL
            and e.time_range.end > w0 and e.time_range.start < w1]


class _Sweep:
    """The ``qpth.*`` spans open at a point, for points visited in
    increasing order: ``open(t)`` returns them innermost first."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[0])
        self.k = 0
        self.stack = []

    def open(self, t):
        while self.k < len(self.spans) and self.spans[self.k][0] <= t:
            self.stack.append(self.spans[self.k])
            self.k += 1
        while self.stack and self.stack[-1][1] < t:
            self.stack.pop()
        return [s for s in reversed(self.stack) if s[0] <= t <= s[1]]


def read(events):
    """The spans' reading of a traced run's profiler events (times in
    microseconds, results in seconds); None without a traced call or
    without a single ``qpth.*`` span in it."""
    win = _window(events)
    if win is None:
        return None
    w0, w1, starts = win
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if _cpu(e) and e.name.startswith(PREFIX)
             and e.time_range.end > w0 and e.time_range.start < w1]
    if not spans:
        return None
    count = defaultdict(int)
    for _, _, name in spans:
        count[name] += 1

    dev = _device_ops(events, w0, w1)
    ids = {e.id for e in dev}
    launch = {}
    for e in events:
        if (_cpu(e) and e.id in ids
                and e.name.startswith(LAUNCH_PREFIX)):
            launch[e.id] = e.time_range.start

    # Each operation by its launch: innermost span (self) and every span
    # open around it (inclusive).
    self_s, incl_s = defaultdict(float), defaultdict(float)
    self_ops = defaultdict(int)
    by_op = defaultdict(lambda: defaultdict(float))
    skew = defaultdict(int)
    skew_us = []
    skew_calls = [0] * len(starts)
    unlaunched = 0
    timed = sorted(((launch.get(e.id), e) for e in dev),
                   key=lambda te: -1.0 if te[0] is None else te[0])
    sweep = _Sweep(spans)
    for t, e in timed:
        a = max(e.time_range.start, w0)
        b = min(e.time_range.end, w1)
        us = max(b - a, 0.0)
        if t is None:
            unlaunched += 1
            chain = []
        else:
            chain = sweep.open(t)
        label = chain[0][2] if chain else OUTSIDE
        if t is not None and e.time_range.start < t - SKEW_US:
            skew[label] += 1
            skew_us.append(t - e.time_range.start)
            skew_calls[max(bisect.bisect_right(starts, t) - 1, 0)] += 1
        self_s[label] += us * 1e-6
        self_ops[label] += 1
        by_op[e.name[:trace.NAME_CHARS]][label] += us * 1e-6
        for name in {s[2] for s in chain} or {OUTSIDE}:
            incl_s[name] += us * 1e-6

    # The idle gaps of ``trace.reduce``, by the innermost span open at each
    # gap's middle; the loop's share is every gap inside ``qpth.ipm.loop``.
    busy = trace._merge((max(e.time_range.start, w0),
                         min(e.time_range.end, w1)) for e in dev)
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    idle = defaultdict(float)
    loop_idle = 0.0
    sweep = _Sweep(spans)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        chain = sweep.open(0.5 * (a + b))
        idle[chain[0][2] if chain else OUTSIDE] += (b - a) * 1e-6
        if any(s[2] == LOOP for s in chain):
            loop_idle += (b - a) * 1e-6

    busy_us = sum(b - a for a, b in busy)
    top = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:TOP]
    return {
        "calls": len(starts), "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6, "device_ops": len(dev),
        "spans": dict(count), "syncs": count.get(SYNC, 0),
        "device_s": dict(self_s), "device_incl_s": dict(incl_s),
        "device_ops_by_span": dict(self_ops), "idle_s": dict(idle),
        "loop_idle_s": loop_idle, "clock_skew_ops": sum(skew.values()),
        "clock_skew_by_span": dict(skew),
        "clock_skew_max_us": max(skew_us, default=0.0),
        "clock_skew_by_call": skew_calls,
        "unlaunched_ops": unlaunched,
        "span_device_copies": sum(1 for e in dev
                                  if e.name.startswith(PREFIX)),
        "ops": [[name, dict(by)] for name, by in top],
    }


def layer_metrics(r):
    """The per-layer numbers of a reading: ``prefactor.share`` and
    ``backward.grads_share`` (device time launched under the span, nested
    spans included, over device busy time, %), ``ipm.loop_idle_share``
    (idle while the host is inside ``qpth.ipm.loop``, over the traced
    window, %) and ``host.syncs_per_call``. A run with no device
    operations (on the CPU) gives only the last; a run without a backward
    span gives no ``backward.grads_share``."""
    out = {"prefactor.share": None, "ipm.loop_idle_share": None,
           "host.syncs_per_call": None, "backward.grads_share": None}
    if r is None:
        return out
    out["host.syncs_per_call"] = r["syncs"] / r["calls"]
    if not r["busy_s"]:
        return out
    incl = r["device_incl_s"]
    out["prefactor.share"] = 100.0 * incl.get(PREFACTOR, 0.0) / r["busy_s"]
    out["ipm.loop_idle_share"] = 100.0 * r["loop_idle_s"] / r["window_s"]
    if r["spans"].get(BACKWARD):
        out["backward.grads_share"] = (100.0 * incl.get(GRADS, 0.0)
                                       / r["busy_s"])
    return out


def run_with_spans(cell, config, seed, seconds, device="cuda", t0=None,
                   program=None):
    """One traced ``harness.run`` with :func:`read` applied to the same
    profiler events ``trace.reduce`` reads; returns (result, reading)."""
    box = {}
    reduce = trace.reduce

    def reduce_and_read(prof):
        t = reduce(prof)
        box["spans"] = read(prof.events())
        return t

    trace.reduce = reduce_and_read
    try:
        result = harness.run(cell, config, seed, seconds, True,
                             device=device, t0=t0, program=program)
    finally:
        trace.reduce = reduce
    return result, box.get("spans")


def main(argv=None):
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the reading as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("qpbench.spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell, config = harness.load_cell(args.workload)
    result, r = run_with_spans(cell, config, args.seed, args.seconds,
                               device="cuda", t0=t0)
    out = {"workload": args.workload, "seed": args.seed,
           "metrics": layer_metrics(r), "spans": r}
    print(json.dumps(_finite(result)))
    print(json.dumps(_finite(out)))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            _finite({"result": result, **out}), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
