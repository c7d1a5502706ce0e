"""Shared helpers of the benchmark's CPU tests: each cell and its
configuration cut to a size a CPU test can run (the card's sizes are the
files' own)."""

from qpbench import harness

#: A cell of the ``optnet_sudoku4`` configuration. No cell of
#: ``BENCHMARK.json`` runs that configuration yet (its training cell waits
#: on a fault of the program), so its generator and work count are tested
#: through this one, which exists only here.
SUDOKU = {
    "config": "optnet_sudoku4", "traffic": "diag_fwd_b4096", "chips": 1,
    "batch": 4096, "mode": "forward", "grads": [], "shared": ["A"],
    "pool_lanes": 8192, "pool_shared": 64, "check_calls": 2,
    "trace_calls": 8, "limits": {"z_p99": 1e-3, "z_rms": 8e-4},
    "why": "the sudoku layer's forward, shared A per call: the diagonal tier",
}

CELLS = ["dense100.fwd", "sudoku4.diag_fwd", "dense100.optnet_train",
         "dense100.fwd_b128"]


def load(name):
    """``harness.load_cell(name)``, or the sudoku cell above."""
    if name == "sudoku4.diag_fwd":
        return (dict(SUDOKU, name=name),
                harness.load_json("configs", SUDOKU["config"]))
    return harness.load_cell(name)


def tiny(name, batch=6):
    """``load(name)`` with every width cut to 8 (3 equality rows) and a
    pool of a few batches."""
    cell, config = load(name)
    for key in ("nz", "nineq", "nx"):
        if key in config:
            config[key] = 8
    if config.get("neq"):
        config["neq"] = 3
    cell.update(batch=batch, pool_lanes=3 * batch,
                pool_shared=min(cell["pool_shared"], 3), check_calls=2,
                trace_calls=2)
    return cell, config
