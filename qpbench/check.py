"""Whether a run's answers are right: the outputs of a seeded sample of the
window's calls against the plain reference (``reference/qp.py``) solved in
float64 on the same inputs.

Numbers read (a cell's file names under ``limits`` those it compares, each
with its limit):

* ``z_med``, ``z_p99``, ``z_rms``, ``z_max``: the median, the 99th
  percentile, the root mean square and the largest of the per-lane
  relative errors of the solution z over every lane of the sampled calls;
* for each input the cell takes gradients to: the same four
  (``<name>_med`` ...) where the input is per lane, or ``<name>``, the
  largest relative error of the summed gradient over the sampled calls,
  where it is a layer parameter shared by the batch.

A lane's relative error is |x - r| / max(|r|, median over lanes of |r|)
(2-norms over the lane): the median's floor keeps a lane whose reference
is near zero from reading rounding as error. A non-finite output reads as
an infinite error.
"""

from __future__ import annotations

import torch

from .reference import qp as ref

#: Kinds of pool input that are one tensor for the whole batch.
SHARED_KINDS = ("const", "shared")


def reference_outputs(x, cot, pool, config, cell, dtype=torch.float64,
                      tf32=False):
    """The reference's z and gradients for one batch ``x`` (the pool's
    dict of inputs), computed in ``dtype`` (with TF32 products where
    ``tf32``: the control)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        dense = pool.as_dense({k: v.to(dtype) for k, v in x.items()})
        Q, p, G, h, A, b = dense
        sol = ref.solve(Q, p, G, h, A, b)
        out = {"z": sol["z"]}
        grads = cell.get("grads", [])
        if grads:
            shared = [g for g in grads
                      if pool.inputs[g][1] in SHARED_KINDS]
            gr = ref.gradients(Q, G, A, sol, cot.to(dtype),
                               config["solver_config"].get("grad_clamp",
                                                           1e-8),
                               shared=shared)
            out.update({g: gr[g] for g in grads})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def lane_errors(x, r):
    """Per-lane relative errors of x against r, (B, ...) each."""
    x = x.detach().to(torch.float64).reshape(x.shape[0], -1)
    r = r.to(torch.float64).reshape(r.shape[0], -1)
    rn = r.norm(dim=1)
    err = (x - r).norm(dim=1) / torch.maximum(rn, rn.median())
    bad = ~torch.isfinite(x).all(dim=1)
    return torch.where(bad, torch.full_like(err, float("inf")), err), bad


def shared_error(x, r):
    x = x.detach().to(torch.float64)
    r = r.to(torch.float64)
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    return float((x - r).norm() / r.norm())


def readings(kept, pool, cell, config, outputs=None):
    """The compared numbers over the kept calls ``[(i, (j, o, out))]``, and
    the lanes with a non-finite answer. ``outputs(x, cot)`` replaces the
    program's outputs (the control)."""
    per_lane, shared, failed = {}, {}, 0
    for _, (j, o, out) in kept:
        x = pool.batch(j, o)
        cot = None if pool.cot is None else pool.cotangent(o)
        want = reference_outputs(x, cot, pool, config, cell)
        if outputs is not None:
            out = outputs(x, cot)
        bad_lanes = None
        for name, r in want.items():
            if name != "z" and pool.inputs[name][1] in SHARED_KINDS:
                shared.setdefault(name, []).append(
                    shared_error(out[name], r))
                continue
            err, bad = lane_errors(out[name], r)
            per_lane.setdefault(name, []).append(err)
            bad_lanes = bad if bad_lanes is None else bad_lanes | bad
        failed += int(bad_lanes.sum())
    numbers = {}
    for name, errs in per_lane.items():
        e = torch.cat(errs)
        numbers[f"{name}_med"] = float(e.median())
        numbers[f"{name}_p99"] = float(e.quantile(0.99))
        numbers[f"{name}_rms"] = float(e.square().mean().sqrt())
        numbers[f"{name}_max"] = float(e.max())
    for name, errs in shared.items():
        numbers[name] = max(errs)
    return numbers, failed


def judge(kept, pool, cell, config):
    """The run's verdict: every number the cell's ``limits`` name within
    its limit."""
    numbers, failed = readings(kept, pool, cell, config)
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in cell["limits"].items()}
    correct = bool(kept) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    return {"correct": correct, "failed": failed, "checks": checks}
