"""Shape/broadcast utilities (counterpart of ``qpth_tpu/utils.py``).

Parameters keep a *minimal* leading batch dimension: 1 when shared across
the batch, B when per-instance. A shared Q/G is then factored once, and
batched matvecs against it become one matrix product.
"""

from __future__ import annotations

import torch


def is_empty(x) -> bool:
    """Upstream qpth's empty-constraint convention: None or any zero-sized
    tensor means "no constraints of this kind"."""
    return x is None or x.numel() == 0


def extract_nbatch(Q, p, G, h, A, b) -> int:
    """Infer the batch size from whichever parameter carries a batch dim."""
    dims = [3, 2, 3, 2, 3, 2]
    for param, d in zip((Q, p, G, h, A, b), dims):
        if param is not None and param.dim() == d:
            return param.shape[0]
    return 1


def as_batched(x, ndim: int):
    """Give ``x`` a leading batch dim of size 1 or B without copying.

    Returns (batched_tensor, was_unbatched)."""
    if x is None:
        return None, False
    if x.dim() == ndim:
        return x, False
    if x.dim() == ndim - 1:
        return x.unsqueeze(0), True
    raise ValueError(
        f"Unexpected rank {x.dim()} for parameter expected at rank "
        f"{ndim - 1} or {ndim}.")


def bger(x, y):
    """Batched outer product. x: (B,m), y: (B,n) -> (B,m,n)."""
    return x.unsqueeze(-1) * y.unsqueeze(-2)


def bdiag(d):
    """Batched diag-embed: (B, n) -> (B, n, n)."""
    return torch.diag_embed(d)


def normalize_constraints(A, b):
    """Map the empty-constraint convention to (None, None)."""
    if is_empty(A) or is_empty(b):
        return None, None
    return A, b
