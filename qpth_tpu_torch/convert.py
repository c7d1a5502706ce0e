"""Carry the JAX package's cached factorization over to the port.

``qpth_tpu.prefactor_qp`` returns the solver's only state that persists
across calls: a ``KKTFactors`` with its ``Scaling``/``sem_scaling``. Both
packages keep it batch-major with the same field names, so the arrays move
as they are. The problem data (Q, p, G, h) is plain arrays already.
"""

from __future__ import annotations

import torch

from .ops.kkt import KKTFactors
from .scaling import Scaling

_FIELDS = ("L_Q", "R", "L_S11", "S21", "W", "invQ", "invS11", "invQ_GT",
           "invQ_AT", "GiGT", "S11")


def _scaling(d, device):
    if d is None:
        return None

    def t(k):
        v = d.get(k)
        return None if v is None else torch.as_tensor(v, device=device)

    return Scaling(E=t("E"), RG=t("RG"), RA=t("RA"), c=t("c"))


def factors_from_numpy(arrays: dict, device) -> KKTFactors:
    """Build the port's ``KKTFactors`` from numpy arrays keyed by the JAX
    ``KKTFactors`` field names, in inverse or substitution mode, with or
    without equality constraints. ``arrays["scaling"]`` and
    ``arrays["sem_scaling"]``, when present, are dicts keyed by the
    ``Scaling`` field names (E, RG, RA, c)."""
    if arrays.get("facQ") is not None:
        raise NotImplementedError(
            "factors field 'facQ' (the hybrid path) — ROADMAP.md §1 "
            "item 13")
    if arrays.get("R") is None or (arrays.get("invQ") is None
                                   and arrays.get("L_Q") is None):
        raise ValueError("factors_from_numpy: needs R and one of invQ "
                         "(inverse mode) or L_Q (substitution mode)")
    fields = {k: None if arrays.get(k) is None
              else torch.as_tensor(arrays[k], device=device)
              for k in _FIELDS}
    return KKTFactors(**fields,
                      scaling=_scaling(arrays.get("scaling"), device),
                      sem_scaling=_scaling(arrays.get("sem_scaling"),
                                           device))
