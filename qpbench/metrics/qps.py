"""QPs completed per second of the window: every lane of every call, from
the window's start to the end of its last call (in a forward+backward
cell a QP counts once its gradients are on the card)."""

KIND = "end_to_end"
NAME = "qps"
UNIT = "QP/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    return run["lanes"] / run["window_s"]
