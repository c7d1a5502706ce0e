"""Device operations (kernels, copies, fills) per traced call, counted by
the profiler."""

KIND = "per_layer"
NAME = "host.launches_per_call"
UNIT = "ops/call"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "host dispatch"
MOVES = "qps"


def read(run):
    t = run["trace"]
    if not t["device_ops"]:
        return None
    return t["device_ops"] / t["calls"]
