"""Run one cell of the ``qpth_tpu_torch`` benchmark once, on the CUDA card of
this machine, and print its result as the last line of standard output:

    python3 qpbench/run.py --workload CELL --seed N --seconds S --trace 0|1

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of some of the window's
calls. Every number the run compared with the reference is printed beside
its limit, as the last lines of standard error and under ``checks`` in the
result. A machine without a CUDA card, or with fewer than the cell asks
for, gets exit code 2 and no result; a process that holds JAX or the JAX
package once the window has closed gets exit code 3 and no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _finite(v):
    """JSON has no infinity or NaN: a non-finite reading prints as null."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from qpbench import harness

    cell, config = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("qpbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"qpbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(cell, config, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t0=T0)
    held = harness.forbidden_modules()
    if held:
        print(f"qpbench: the run holds {', '.join(held)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(_finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
