"""The readings a cell's limits are set from (not part of a benchmark run):

    python3 qpbench/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--fault <name> --fault-seeds ...]

For each seed it draws the cell's pool, makes as many calls as a run
compares (``check_calls``, batches planned from the seed as in a run),
and prints, one JSON line each, the compared numbers of

* the program (``qpth_tpu_torch`` as configured): the lower readings;
* the control: the reference itself in the program's place, in the
  precision below the configuration's (float32 with TF32 products where
  the configuration states float32 with TF32 off): the upper readings;
* the program with one of ``faults.FAULTS`` planted.

All on the CUDA card, at the cell's own sizes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _calls(harness, cell, config, seed, device, program, solver_config):
    pool = harness.Pool(config, cell, seed, device)
    plan = harness.Plan(pool, seed)
    call = harness.make_call(config, cell, solver_config, program, device)
    kept = []
    for i in range(cell["check_calls"]):
        j, o = plan.next()
        cot = None if pool.cot is None else pool.cotangent(o)
        kept.append((i, (j, o, call(pool.batch(j, o), cot))))
    return pool, kept


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import qpth_tpu_torch as program
    from qpbench import check, faults, harness

    cell, config = harness.load_cell(args.workload)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    solver_config = program.SolverConfig(**config["solver_config"])

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(kind, seed, numbers, failed, t0):
        line = json.dumps({"cell": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers,
                           "failed": failed,
                           "seconds": time.perf_counter() - t0,
                           "card": torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"})
        print(line, flush=True)

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        pool, kept = _calls(harness, cell, config, seed, device, program,
                            solver_config)
        emit("program", seed, *check.readings(kept, pool, cell, config), t0)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        pool, kept = _calls(harness, cell, config, seed, device, program,
                            solver_config)
        control = lambda x, cot, pool=pool: check.reference_outputs(  # noqa
            x, cot, pool, config, cell, dtype=torch.float32, tf32=True)
        emit("control", seed, *check.readings(kept, pool, cell, config,
                                              outputs=control), t0)
    for seed in seeds(args.fault_seeds):
        t0 = time.perf_counter()
        with faults.FAULTS[args.fault](program, config):
            pool, kept = _calls(harness, cell, config, seed, device,
                                program, solver_config)
        emit(args.fault, seed, *check.readings(kept, pool, cell, config), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
