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

#: Fields of a branch the port does not run yet (substitution mode, neq > 0,
#: the hybrid path); they must be absent or None.
_UNPORTED = ("L_Q", "L_S11", "S21", "W", "invS11", "invQ_AT", "S11",
             "facQ")
_REQUIRED = ("R", "invQ", "invQ_GT")


def _scaling(d, device):
    if d is None:
        return None
    if d.get("RA") is not None:
        raise NotImplementedError(
            "equality-row scaling RA (neq > 0) — ROADMAP.md §1 item 8")
    return Scaling(E=torch.as_tensor(d["E"], device=device),
                   RG=torch.as_tensor(d["RG"], device=device), RA=None,
                   c=torch.as_tensor(d["c"], device=device))


def factors_from_numpy(arrays: dict, device) -> KKTFactors:
    """Build the port's ``KKTFactors`` from numpy arrays keyed by the JAX
    ``KKTFactors`` field names. ``arrays["scaling"]`` and
    ``arrays["sem_scaling"]``, when present, are dicts keyed by the
    ``Scaling`` field names (E, RG, RA, c)."""
    for k in _UNPORTED:
        if arrays.get(k) is not None:
            raise NotImplementedError(
                f"factors field {k!r} (substitution mode, neq > 0 or the "
                "hybrid path) — ROADMAP.md §1 items 7, 8, 13")
    missing = [k for k in _REQUIRED if arrays.get(k) is None]
    if missing:
        raise ValueError(f"factors_from_numpy: missing fields {missing}")

    def t(k):
        v = arrays.get(k)
        return None if v is None else torch.as_tensor(v, device=device)

    return KKTFactors(L_Q=None, R=t("R"), L_S11=None, S21=None, W=None,
                      invQ=t("invQ"), invQ_GT=t("invQ_GT"), GiGT=t("GiGT"),
                      scaling=_scaling(arrays.get("scaling"), device),
                      sem_scaling=_scaling(arrays.get("sem_scaling"),
                                           device))
