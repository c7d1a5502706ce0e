"""Profiling utilities (counterpart of ``qpth_tpu/profiling.py``).

* :func:`trace`: context manager around ``torch.profiler.profile``; writes a
  Chrome / Perfetto trace (``chrome://tracing``, ui.perfetto.dev) into a
  directory.
* :func:`solve_timings`: wall time of a solve callable, the first call
  apart from the best of the following ones.
* :func:`span`: the solver's named ranges (``qpth.*``, see
  :data:`SPANS`), ``torch.profiler.record_function`` ranges while a
  profiler session records and a shared no-op otherwise.

``SolveStats`` (returned by every full solve) carries the solver's own
counters: iterations, per-lane best residuals, convergence mask.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd.profiler import record_function

#: The solver's span names, outermost first. ``qpth.prefactor`` and
#: ``qpth.ipm.*`` sit inside ``qpth.solve`` (``qpth.prefactor`` also under
#: ``prefactor_qp`` and a backward that rebuilds the factors; the diagonal
#: and banded tiers, which share the dense tier's loop, record its spans
#: with no ``qpth.solve`` around them); score, exit
#: and step inside ``qpth.ipm.loop``, once per iteration (no step on the
#: iteration that exits); inside a composed step (no fused kernel),
#: ``qpth.ipm.step.factor`` around the factor of T with its first solve
#: and ``qpth.ipm.step.solve`` around each further solve on that factor;
#: ``qpth.backward.*`` inside ``qpth.backward``;
#: ``qpth.sync`` around each device-to-host read, inside whichever span
#: makes it, so its count is the number of reads and its length the
#: host's wait.
SPANS = ("qpth.solve", "qpth.prefactor", "qpth.ipm.init", "qpth.ipm.loop",
         "qpth.ipm.score", "qpth.ipm.exit", "qpth.ipm.step",
         "qpth.ipm.step.factor", "qpth.ipm.step.solve",
         "qpth.ipm.finish", "qpth.backward", "qpth.backward.solve",
         "qpth.backward.grads", "qpth.sync")

_NULL = contextlib.nullcontext()


def span(name: str):
    """A named range of the solver: ``record_function(name)`` while a
    ``torch.profiler`` session records, so that the range shares the
    trace's clock with the device activity; otherwise one shared
    ``nullcontext``, since a ``record_function`` costs ~11 us of host time
    even with no profiler running, and a span then costs ~0.6 us (its
    flag check ~0.1 us). Neither synchronizes, allocates on the device or
    launches work."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NULL


@contextlib.contextmanager
def trace(log_dir: str = "qpth_tpu_torch_trace"):
    """Profile a block: ``with qpth_tpu_torch.profiling.trace(d): solve()``.
    Records CPU activity, and CUDA activity where CUDA is present, and on
    exit writes ``<log_dir>/trace_<pid>.json``, a Chrome trace. Yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _sync(out) -> None:
    """Wait for the device work behind ``out``: one ``synchronize`` where any
    tensor in it lies on CUDA."""
    stack = [out]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
                return
        elif isinstance(v, (tuple, list)):
            stack.extend(v)


def solve_timings(solve_fn, *args, trials: int = 3):
    """Wall-time ``solve_fn(*args)``: returns ``(first_call_s, best_run_s)``,
    the first call's seconds and the least of ``trials`` further calls.
    Every timed call ends in ``torch.cuda.synchronize()`` where its output
    lies on CUDA. The first call stands in for the JAX package's compile
    time: it includes the first use of the kernels (the ``nvcc`` build of
    any missing library and the library loads) and of the CUDA libraries."""
    def once():
        t0 = time.perf_counter()
        _sync(solve_fn(*args))
        return time.perf_counter() - t0

    first = once()
    return first, min(once() for _ in range(trials))
