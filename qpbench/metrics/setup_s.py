"""Seconds from the process's start to the window's start: imports, the
CUDA context, loading (on a checkout's first run, building) the kernels,
drawing the pool and warming the cell's shapes."""

KIND = "end_to_end"
NAME = "setup_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run["setup_s"]
