"""The least time the traced calls' solve work needs, over the device's
busy time in those calls. The least time is the larger of bytes / peak
bandwidth and flops / peak rate (``qpbench/work/peaks.json``), with the
work counted from the cell's shapes and the iterations the solves report
(``qpbench/work/<config's work>.py``), never from kernel names or
launches."""

KIND = "per_layer"
NAME = "kernels.roofline_share"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "qps"


def read(run):
    t = run["trace"]
    if not t["busy_s"] or t["least_s"] is None:
        return None
    return 100.0 * t["least_s"] / t["busy_s"]
