"""IPM iterations a solve reports (``SolveStats.iterations`` of the
configuration's forward entry on each traced call's batch), averaged over
the traced calls."""

KIND = "per_layer"
NAME = "ipm.iterations"
UNIT = "iterations"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "IPM loop"
MOVES = "qps"


def read(run):
    its = run["trace"]["iterations"]
    return sum(its) / len(its) if its else None
