"""Share of the traced calls' wall time in which no operation ran on the
device: 1 - (union of the device operations' intervals) / (the traced
window), from ``torch.profiler``."""

KIND = "per_layer"
NAME = "device.idle_share"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "qps"


def read(run):
    t = run["trace"]
    if not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
