"""Faults planted in the program under test, each of which the comparison
with the reference must catch (``correct`` false). Each is a context
manager that patches ``qpth_tpu_torch`` while it is open:

* ``frozen_step``: every IPM step returns its state unchanged (the fused
  dense steps, and the diagonal tier's Newton solve giving zero
  directions);
* ``half_batch``: the entry solves the first half of the batch only and
  gives the other half the mean of that half's answers;
* ``altered_answer``: the entry's answer for lane 0 is moved by 1 in every
  coordinate.

The exchange between cards is not a fault these cells can have: each runs
on one card.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def frozen_step(program, config):
    from qpth_tpu_torch.core import diag
    from qpth_tpu_torch.ops.cuda import kernels

    def xfree(R, s, z, q, n_correctors=0):
        return z, s, z, torch.zeros_like(s[:, 0])

    def step(R, iGT, x, s, z, *rest):
        return x, s, z, torch.zeros_like(s[:, 0])

    def step_eq(R, iGT, S21, W, iS11, S11, iAT, x, s, z, y, *rest):
        return x, s, z, y, torch.zeros_like(s[:, 0])

    def newton(q, g, A, d, H, fac, rx, rs, rz, ry, B, n, dtype):
        zero = torch.zeros((B, n), dtype=dtype, device=d.device)
        dy = None if A is None else torch.zeros(
            (B, A.shape[-2]), dtype=dtype, device=d.device)
        return zero, zero, zero, dy

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(kernels, "ipm_step_xfree", xfree))
        stack.enter_context(_patched(kernels, "ipm_step", step))
        stack.enter_context(_patched(kernels, "ipm_step_eq", step_eq))
        stack.enter_context(_patched(diag, "solve_kkt_diag", newton))
        yield


def _entry_wrapper(program, config, transform):
    """Patch both entries of the configuration with ``transform(fn, args,
    kwargs)``."""
    stack = contextlib.ExitStack()
    for name in set(config["entry"].values()):
        fn = getattr(program, name)

        def wrapped(*args, _fn=fn, **kwargs):
            return transform(_fn, args, kwargs)

        stack.enter_context(_patched(program, name, wrapped))
    return stack


def _lanes(args):
    """The batch size: the leading dimension of the per-lane vector p."""
    return args[1].shape[0]


def _replace_z(out, z):
    return z if isinstance(out, torch.Tensor) else out._replace(z=z)


@contextlib.contextmanager
def half_batch(program, config):
    def transform(fn, args, kwargs):
        B = _lanes(args)
        half = B // 2
        cut = [a[:half] if a is not None and a.dim() >= 2
               and a.shape[0] == B else a for a in args]
        out = fn(*cut, **kwargs)
        z = out if isinstance(out, torch.Tensor) else out.z
        z = torch.cat([z, z.mean(dim=0, keepdim=True).expand(B - half, -1)])
        return _replace_z(out, z)

    with _entry_wrapper(program, config, transform):
        yield


@contextlib.contextmanager
def altered_answer(program, config):
    def transform(fn, args, kwargs):
        out = fn(*args, **kwargs)
        z = out if isinstance(out, torch.Tensor) else out.z
        return _replace_z(out, torch.cat([z[:1] + 1.0, z[1:]]))

    with _entry_wrapper(program, config, transform):
        yield


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch,
          "altered_answer": altered_answer}
