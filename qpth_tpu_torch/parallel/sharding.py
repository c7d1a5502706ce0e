"""Batch sharding of the QP solver over ``torch.distributed`` processes
(counterpart of ``qpth_tpu/parallel/sharding.py``).

The QP instances are split over the ranks of a process group, one GPU per
rank; each rank solves its own lanes. The algorithm's only cross-rank
traffic is the loop's exit test (any lane improved, max best residual, min
mu), one ``all_reduce`` of a few scalars per iteration
(``core/pdipm.py::exit_test``), where the JAX package has its ``pmax`` /
``pmin`` over the mesh axis. The backward pass needs none but the sum of
the shared parameters' cotangents over the ranks, which ``shard_map``'s
autodiff inserts there as a ``psum`` and :class:`_SumGrads` runs here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import qp as qp_mod
from ..config import SolverConfig
from ..utils import extract_nbatch


def batch_mesh(ranks=None):
    """The process group for batch parallelism over ``ranks`` (every rank
    of the default group when None). Every rank must call it, as
    ``torch.distributed.new_group`` requires."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(ranks=list(ranks))


def batch_sharding(group=None):
    """This rank's share of a global batch: a function that cuts the
    leading (batch) dimension of a global tensor to this rank's lanes; the
    batch must divide evenly over the group."""
    from .multihost import local_batch_slice

    def shard(x):
        return x[local_batch_slice(x.shape[0], group)]

    return shard


class _SumGrads(torch.autograd.Function):
    """The identity forward; backward, the cotangents of every input summed
    over the group in one ``all_reduce`` of their concatenation (one
    collective, in one fixed order on every rank)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        out, i = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            out.append(flat[i:i + n].view(shape))
            i += n
        return (None,) + tuple(out)


def _shared(x, rank: int, B: int) -> bool:
    """Whether a parameter is shared by the lanes (passed without the batch
    dimension, or with batch 1 where the local batch is larger)."""
    return x is not None and (x.dim() < rank or (x.shape[0] == 1 and B > 1))


def solve_qp_sharded(Q, p, G, h, A=None, b=None, *, group,
                     config: SolverConfig = qp_mod.DEFAULT_CONFIG,
                     device="cuda"):
    """Differentiable batched QP solve with the batch split over the ranks
    of ``group``: each rank passes its LOCAL shard of every batched
    parameter and the whole of every shared one (replicated), and gets its
    lanes' z. Every rank must call it with the same number of lanes (the
    global batch divisible by the group's size, checked with one
    ``all_reduce`` on entry).

    The group is set on the config (``process_group``), so the loop's exit
    test, refinement's early exit, the INACC check and the batch-collapsed
    Ruiz norms reduce over it, and the ordinary :func:`qpth_tpu_torch.
    solve_qp` path runs. ``broadcast_grad_reduction="mean"`` divides by
    the global batch. The cotangents of the shared parameters are summed
    over the group in the backward."""
    cfg = dataclasses.replace(config, process_group=group)
    Q, p, G, h, A, b = qp_mod._inputs(Q, p, G, h, A, b, device)
    B = extract_nbatch(Q, p, G, h, A, b)
    n = dist.get_world_size(group)
    sizes = torch.tensor([B, -B], dtype=torch.float64, device=p.device)
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
    if int(sizes[0]) != -int(sizes[1]):
        raise ValueError(
            f"Batch of {B} lanes on rank {dist.get_rank(group)} while "
            f"another rank holds {int(sizes[0])} or {-int(sizes[1])}: the "
            f"global batch is not divisible by the group's size {n} in "
            "equal shares; pad the batch.")
    args = [Q, p, G, h, A, b]
    idx = [i for i, (x, r) in enumerate(zip(args, (3, 2, 3, 2, 3, 2)))
           if _shared(x, r, B) and x.requires_grad]
    if idx and torch.is_grad_enabled():
        for i, x in zip(idx, _SumGrads.apply(group, *(args[i] for i in idx))):
            args[i] = x
    Q, p, G, h, A, b = args
    if G is None:
        return qp_mod._solve_qp_eq_core(Q, p, A, b)[0]
    Qb, pb, Gb, hb, Ab, bb, meta = qp_mod._canonicalize(Q, p, G, h, A, b)
    meta = (meta[0] * n,) + tuple(meta[1:])
    return qp_mod._QPCore.apply(Qb, pb, Gb, hb, Ab, bb, None, None, cfg,
                                meta)
