"""Profiling utilities (counterpart of ``qpth_tpu/profiling.py``).

* :func:`trace`: context manager around ``torch.profiler.profile``; writes a
  Chrome / Perfetto trace (``chrome://tracing``, ui.perfetto.dev) into a
  directory.
* :func:`solve_timings`: wall time of a solve callable, the first call
  apart from the best of the following ones.

``SolveStats`` (returned by every full solve) carries the solver's own
counters: iterations, per-lane best residuals, convergence mask.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
