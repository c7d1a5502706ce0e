"""The traced run's reading of ``torch.profiler``: device busy time as the
union of the device operations' intervals inside the traced calls, the
operations that took most time, and the idle gaps labelled by the
host-side event that spans each."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.profiler import (DeviceType, ProfilerActivity, profile,
                            record_function)

#: The ``record_function`` name around every traced call.
CALL = "qpbench.call"
TOP = 10
NAME_CHARS = 120


def _activities(device):
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def start(device):
    prof = profile(activities=_activities(device))
    prof.start()
    return prof


def warm(device):
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls into set-up."""
    prof = start(device)
    torch.ones(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


def span(name, on):
    return record_function(name) if on else contextlib.nullcontext()


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof):
    """Busy and window seconds, device operations counted, and the
    breakdown of the traced calls (profiler times are microseconds)."""
    events = prof.events()
    calls = [e.time_range for e in events
             if e.name == CALL and e.device_type == DeviceType.CPU]
    w0 = min(r.start for r in calls)
    w1 = max(r.end for r in calls)
    # Device operations only: a ``record_function`` range also appears on
    # the device's timeline (as a user annotation spanning its kernels).
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != CALL
           and e.time_range.end > w0 and e.time_range.start < w1]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:NAME_CHARS]] += (e.time_range.end
                                         - e.time_range.start) * 1e-6
    busy = _merge((max(e.time_range.start, w0), min(e.time_range.end, w1))
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)

    # Host-side events, for the label of each idle gap: the innermost one
    # (latest start) that spans the gap's middle, by one sweep over both
    # in order of time.
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda t: t[0])
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    gaps = defaultdict(float)
    open_, k = [], 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            open_.append(host[k])
            k += 1
        while open_ and open_[-1][1] < mid:
            open_.pop()
        label = open_[-1][2][:NAME_CHARS] if open_ else "(between calls)"
        gaps[label] += (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"busy_s": busy_us * 1e-6 if busy_us > 0 else None,
            "window_s": (w1 - w0) * 1e-6, "device_ops": len(dev),
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(gaps)}}
