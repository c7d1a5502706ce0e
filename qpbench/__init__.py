"""The benchmark of qpth_tpu_torch (see run.py)."""
