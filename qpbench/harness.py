"""The benchmark of ``qpth_tpu_torch``: one cell, one run.

A run draws a pool of inputs on the device from its seed, warms the cell's
shapes, then calls the configuration's entry point in a closed loop with
one caller for the window's seconds: each call takes a batch of the pool
(a shared entry and a window of lanes, both drawn from the seed), and ends
in ``torch.cuda.synchronize()``. A forward+backward cell takes the
gradients of sum(cotangent * z) to the inputs its ``grads`` names. After
the window a seeded sample of the calls is judged against the plain
reference (``qpbench/reference``) and the run prints one line of JSON.

Everything that belongs to one configuration, cell or metric is found by
name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<generator>.py``, ``work/<work>.py``, ``metrics/*.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, trace

BENCH = Path(__file__).resolve().parent

#: Top-level modules the run must not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "qpth_tpu")


def load_json(kind, name):
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"qpbench: no {kind} file {path.name}")
    return json.loads(path.read_text())


def load_module(path: Path):
    mod_name = "qpbench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name):
    """The cell's file and its configuration's, each with its name."""
    cell = dict(load_json("workloads", name), name=name)
    config = load_json("configs", cell["config"])
    return cell, config


def metric_modules():
    return [load_module(p) for p in sorted((BENCH / "metrics").glob("*.py"))]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Pool:
    """The inputs a run draws at set-up, and the batch of each call.

    The generator returns every input with its kind: ``const`` (the same
    tensor in every call), ``shared`` (one of ``pool_shared`` layer
    parameters, batch 1), ``lane`` (``pool_lanes`` rows, of which a call
    takes ``batch`` consecutive ones) or ``shared_lane`` (both)."""

    def __init__(self, config, cell, seed, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        module = load_module(BENCH / "traffic" / f"{config['generator']}.py")
        self.inputs, _ = module.draw(config, cell, gen, device)
        self.as_dense = module.as_dense
        self.B = cell["batch"]
        self.lanes, self.entries = cell["pool_lanes"], cell["pool_shared"]
        if self.lanes < 2 * self.B:
            raise ValueError("pool_lanes must be at least twice the batch")
        self.cot = None
        if cell["mode"] == "train":
            n = self.inputs["p"][0].shape[-1]
            self.cot = torch.randn((self.lanes, n), generator=gen,
                                   device=device,
                                   dtype=self.inputs["p"][0].dtype)

    def batch(self, j, o):
        lanes = slice(o, o + self.B)
        out = {}
        for name, (t, kind) in self.inputs.items():
            if kind == "shared":
                t = t[j]
            elif kind == "lane":
                t = t[lanes]
            elif kind == "shared_lane":
                t = t[j, lanes]
            out[name] = t
        return out

    def cotangent(self, o):
        return self.cot[o:o + self.B]


class Plan:
    """Which batch each call takes: a shared entry (never the previous
    call's) and a first lane, drawn from the seed."""

    def __init__(self, pool, seed):
        self.rng = random.Random(seed)
        self.pool = pool
        self.j = -1

    def next(self):
        S = self.pool.entries
        j = self.rng.randrange(S)
        if S > 1 and j == self.j:
            j = (j + 1) % S
        self.j = j
        return j, self.rng.randrange(self.pool.lanes - self.pool.B + 1)


class Reservoir:
    """A uniform sample of ``size`` calls of the window, drawn from the
    seed (reservoir sampling): the calls kept are not known while the
    window runs, and keeping one costs only a reference to its outputs."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = random.Random(seed ^ 0x5EED)
        self.kept = []

    def offer(self, i, item):
        if len(self.kept) < self.size:
            self.kept.append((i, item))
            return
        k = self.rng.randrange(i + 1)
        if k < self.size:
            self.kept[k] = (i, item)


def make_call(config, cell, solver_config, program, device):
    """The timed call: (batch, cotangent, marks) -> dict of outputs (z,
    and each gradient). A forward+backward call appends the time its
    forward ended to ``marks`` when given one (after a synchronize)."""
    args = config["args"]
    if cell["mode"] != "train":
        fn = getattr(program, config["entry"]["forward"])
        return lambda x, cot, marks=None: {
            "z": fn(*(x[a] for a in args), config=solver_config,
                    device=device).z}
    fn = getattr(program, config["entry"]["train"])
    grads = cell["grads"]

    def train(x, cot, marks=None):
        leaves = {g: x[g].detach().requires_grad_(True) for g in grads}
        z = fn(*(leaves.get(a, x[a]) for a in args), config=solver_config,
               device=device)
        if marks is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        gs = torch.autograd.grad(z, [leaves[g] for g in grads], cot)
        return dict(zip(grads, gs), z=z.detach())

    return train


def iterations(config, solver_config, program, pool, batches, device):
    """``SolveStats.iterations`` of the forward entry on each batch."""
    fn = getattr(program, config["entry"]["forward"])
    out = []
    for j, o in batches:
        x = pool.batch(j, o)
        sol = fn(*(x[a] for a in config["args"]), config=solver_config,
                 device=device)
        out.append(int(sol.stats.iterations))
    return out


def least_seconds(config, cell, its, card):
    """The least time the work of calls reporting ``its`` needs on the
    card (None for a card the peak table lacks)."""
    peaks = json.loads((BENCH / "work" / "peaks.json").read_text())
    peak = next((c for c in peaks["cards"] if c["match"] in card), None)
    if peak is None:
        return None
    work = load_module(BENCH / "work" / f"{config['work']}.py")
    flops = nbytes = 0.0
    for k in its:
        f, b = work.count(config, cell, k)
        flops, nbytes = flops + f, nbytes + b
    return max(nbytes / peak["bytes_per_s"],
               flops / peak["flops_per_s"][config["dtype"]])


def card_facts():
    """Name, power limit and SM clock of card 0 by ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,"
             "clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        name, limit, sm, sm_max = (v.strip() for v in out.split(","))
        return {"smi_name": name, "power_limit_w": float(limit),
                "sm_clock_mhz": float(sm), "sm_clock_max_mhz": float(sm_max)}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {"smi_name": None, "power_limit_w": None,
                "sm_clock_mhz": None, "sm_clock_max_mhz": None}


def run(cell, config, seed, seconds, traced, device="cuda", t0=None,
        program=None):
    """One run of one cell; returns the result dict. ``program`` is the
    module whose entry points are timed (``qpth_tpu_torch``)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if program is None:
        import qpth_tpu_torch as program
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    solver_config = program.SolverConfig(**config["solver_config"])
    pool = Pool(config, cell, seed, device)
    plan = Plan(pool, seed)
    call = make_call(config, cell, solver_config, program, device)
    keep = Reservoir(cell["check_calls"], seed)

    # Warm the cell's shapes (on a checkout's first run this builds the
    # kernels), and in a traced run the profiler.
    for j, o in ((0, 0), (pool.entries - 1, pool.lanes - pool.B)):
        call(pool.batch(j, o), None if pool.cot is None
             else pool.cotangent(o))
    sync()
    if traced:
        trace.warm(device)
    # What set-up made stays alive for the whole run: keep it out of the
    # collector's full passes inside the window.
    gc.collect()
    gc.freeze()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    times, marks, spans, traced_calls = [], [], [], []
    profiler, profiling = None, False
    first_traced = 2         # the first calls of a window run untraced
    train_spans = traced and cuda and cell["mode"] == "train"
    start = time.perf_counter()
    setup_s = start - t0
    i = 0
    while True:
        j, o = plan.next()
        x = pool.batch(j, o)
        cot = None if pool.cot is None else pool.cotangent(o)
        if traced and i == first_traced:
            profiler, profiling = trace.start(device), True
        t_call = time.perf_counter()
        with trace.span(trace.CALL, profiling):
            out = call(x, cot, marks if train_spans else None)
            sync()
        t_end = time.perf_counter()
        times.append(t_end - t_call)
        if train_spans:
            spans.append((t_call, marks[-1], t_end))
        if profiling:
            traced_calls.append((j, o))
            if len(traced_calls) == cell["trace_calls"]:
                profiler.stop()
                profiling = False
        keep.offer(i, (j, o, out))
        del out, x, cot
        i += 1
        if t_end - start >= seconds and not (
                traced and len(traced_calls) < cell["trace_calls"]):
            break
    window_s = t_end - start
    gc.unfreeze()
    if profiling:
        profiler.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    card = card_facts() if cuda else {}

    record = {"setup_s": setup_s, "window_s": window_s, "lanes": i * pool.B,
              "call_s": times, "peak_bytes": peak}
    if traced:
        t = trace.reduce(profiler)
        t["calls"] = len(traced_calls)
        t["iterations"] = iterations(config, solver_config, program, pool,
                                     traced_calls, device)
        t["least_s"] = (least_seconds(config, cell, t["iterations"],
                                      torch.cuda.get_device_name(device))
                        if cuda and traced_calls else None)
        t["wall_s"] = sum(c - a for a, _, c in spans)
        t["backward_s"] = sum(c - b for _, b, c in spans)
        record["trace"] = t
        del profiler

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(keep.kept, pool, cell, config)
    print(f"qpbench: {i} calls in {window_s:.3f} s; the reference judged "
          f"{len(keep.kept)} of them in {time.perf_counter() - t_check:.3f}"
          " s", file=sys.stderr)

    metrics = {}
    for m in metric_modules():
        if (m.KIND == "per_layer") != traced:
            continue
        value = m.read(record)
        if value is not None:
            metrics[m.NAME] = {"value": value, "unit": m.UNIT}

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    dev.update(card)
    result = {"correct": verdict["correct"], "attempted": i * pool.B,
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if traced:
        t = record["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = t["breakdown"]
    result["checks"] = verdict["checks"]
    return result
