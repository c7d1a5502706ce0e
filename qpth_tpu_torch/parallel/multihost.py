"""Multi-process start-up (counterpart of ``qpth_tpu/parallel/multihost.py``).

The JAX package starts JAX's multi-controller runtime over a TPU pod; here
the runtime is ``torch.distributed``: one process per GPU, NCCL between the
GPUs (gloo on the CPU), with the QP batch split evenly over the processes.
The IPM's only cross-process traffic is the loop's exit test (one
``all_reduce`` of a few scalars per iteration); the backward adds one
``all_reduce`` of the shared parameters' cotangents.

Typical start under ``torchrun --nproc-per-node=N script.py``::

    import qpth_tpu_torch.parallel as qp_par
    qp_par.init_multihost()                   # reads torchrun's environment
    group = qp_par.batch_mesh()               # every rank
    sl = qp_par.local_batch_slice(B, group)   # this rank's lanes
    z = qp_par.solve_qp_sharded(Q, p[sl], G, h[sl], group=group)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

#: torchrun's environment: the counterpart of the TPU pod's metadata.
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Start ``torch.distributed`` (a no-op if a default group exists, or
    if no argument is given and the environment names no cluster).

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Explicit arguments give the
    rendezvous (``coordinator_address``: ``host:port``, or a URL such as
    ``tcp://host:port`` or ``file:///path``), the world size and this
    process's rank. ``backend`` defaults to NCCL where CUDA is present and
    gloo elsewhere. Under NCCL each process takes its own GPU as the
    current device: ``LOCAL_RANK`` where torchrun sets it, else the rank
    modulo the GPUs present, so the entry points' default
    ``device="cuda"`` lands there. A failed start with explicit arguments
    raises: unlike the JAX package's, this function does not swallow
    it."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and not all(k in os.environ for k in _ENV):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        rank = process_id if explicit else int(os.environ["RANK"])
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else (rank or 0) % torch.cuda.device_count())
    if not explicit:
        dist.init_process_group(backend, init_method="env://")
        return
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _rank_world(group) -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_batch_slice(global_batch: int, group=None) -> slice:
    """The [start, stop) slice of the global batch this rank owns under
    batch sharding with equal shares (the whole batch in one process)."""
    i, n = _rank_world(group)
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{n}")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
