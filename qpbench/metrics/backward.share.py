"""Share of a forward+backward call's wall time spent after the forward:
the benchmark's own spans, (end of the backward - end of the forward) /
call wall, with a ``torch.cuda.synchronize()`` at each boundary, summed
over every call of the traced run's window. The harness records these
spans only in a forward+backward cell (``"mode": "train"``); elsewhere
there is nothing to read and the metric is left out."""

KIND = "per_layer"
NAME = "backward.share"
UNIT = "%"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "autograd backward"
MOVES = "qps"


def read(run):
    t = run["trace"]
    if not t["wall_s"]:
        return None
    return 100.0 * t["backward_s"] / t["wall_s"]
