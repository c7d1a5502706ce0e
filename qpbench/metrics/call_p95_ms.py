"""95th percentile of the wall time of every call in the window: host
clock from the call to the ``torch.cuda.synchronize()`` after it (after
its backward in a forward+backward cell)."""

import statistics

KIND = "end_to_end"
NAME = "call_p95_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    times = run["call_s"]
    if len(times) < 2:
        return times[0] * 1e3
    return statistics.quantiles(times, n=20)[18] * 1e3
