"""Peak device memory the process allocated over the window
(``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at its start), the resident input pool included."""

KIND = "end_to_end"
NAME = "peak_mem_gib"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    peak = run["peak_bytes"]
    return None if peak is None else peak / 2 ** 30
