"""Carry the JAX package's state over to the port.

``qpth_tpu.prefactor_qp`` returns the solver's only state that persists
across calls: a ``KKTFactors`` with its ``Scaling``/``sem_scaling``. Both
packages keep it batch-major with the same field names, so the arrays move
as they are. The problem data (Q, p, G, h) is plain arrays already.

The OptNet layers' parameters (a Flax parameter tree) move with
:func:`optnet_params_from_numpy`.
"""

from __future__ import annotations

import torch

from .ops.hybrid import HybridFactor
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


def _hybrid_factor(d, device):
    if d is None:
        return None

    def t(v):
        return None if v is None else torch.as_tensor(v, device=device)

    return HybridFactor([t(g) for g in d["Gs"]], [t(p) for p in d["Ps"]],
                        int(d["m"]), int(d["block"]))


def factors_from_numpy(arrays: dict, device) -> KKTFactors:
    """Build the port's ``KKTFactors`` from numpy arrays keyed by the JAX
    ``KKTFactors`` field names, in inverse or substitution mode, with or
    without equality constraints. ``arrays["scaling"]`` and
    ``arrays["sem_scaling"]``, when present, are dicts keyed by the
    ``Scaling`` field names (E, RG, RA, c). ``arrays["facQ"]``, Q's blocked
    factor in the JAX package's hybrid regime, is a dict of the
    ``HybridFactor`` slots: ``{"Gs": [...], "Ps": [..., None], "m": int,
    "block": int}``; it becomes the port's ``HybridFactor`` on ``device``."""
    if arrays.get("R") is None or (arrays.get("invQ") is None
                                   and arrays.get("L_Q") is None
                                   and arrays.get("facQ") is None):
        raise ValueError("factors_from_numpy: needs R and one of invQ or "
                         "facQ (inverse mode) or L_Q (substitution mode)")
    fields = {k: None if arrays.get(k) is None
              else torch.as_tensor(arrays[k], device=device)
              for k in _FIELDS}
    return KKTFactors(**fields, facQ=_hybrid_factor(arrays.get("facQ"),
                                                    device),
                      scaling=_scaling(arrays.get("scaling"), device),
                      sem_scaling=_scaling(arrays.get("sem_scaling"),
                                           device))


def optnet_params_from_numpy(module, params):
    """Load a Flax OptNet layer's parameters, as numpy arrays, into the
    port's ``nn.OptNetSudoku`` or ``nn.OptNetClassifier`` (in place; each
    array takes the module parameter's dtype and device). ``params`` is the
    tree ``model.init`` returns, with or without its outer ``"params"``
    key. A Flax ``Dense`` kernel is (in, out) and a ``torch.nn.Linear``
    weight (out, in), so kernels are transposed. Returns the module."""
    params = params.get("params", params)
    if hasattr(module, "fc1"):
        pairs = [(module.fc1.weight, params["Dense_0"]["kernel"].T),
                 (module.fc1.bias, params["Dense_0"]["bias"]),
                 (module.fc2.weight, params["Dense_1"]["kernel"].T),
                 (module.fc2.bias, params["Dense_1"]["bias"])]
        pairs += [(getattr(module, k), params[k])
                  for k in ("L", "G", "z0", "s0")]
    else:
        pairs = [(module.A, params["A"])]
    with torch.no_grad():
        for dst, src in pairs:
            src = torch.tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"parameter shape {tuple(src.shape)} does "
                                 f"not match the module's {tuple(dst.shape)}")
            dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
    return module
