"""The PyTorch port's fused steps with the direct x update and its
``inv_solve`` (``qpth_tpu_torch/ops/cuda/kernels.py``) against the TPU
kernels they replace, in Pallas interpret mode: ``ipm_step_lanes``,
``ipm_step_eq_lanes`` (through ``pallas_lanes_backend``'s ``fused_step`` /
``fused_step_eq``, which take and return batch-major arrays) and
``inv_solve_lanes``. On a CPU tensor a wrapper takes its plain PyTorch
version, which is what runs here.

Both sides compute the same float32 recurrence in another summation order,
so outputs agree to a few ulps of the operand scale (2e-5 relative to the
largest output entry). Every batch has one lane whose R + diag(s/z) is not
SPD: both versions must freeze it (alpha = 0, state unchanged)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops import kkt as jkkt
from qpth_tpu.ops.pallas.lanes import inv_solve_lanes, pad_spd_lanes
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

B = 8
BAD = 3  # the lane whose T is not SPD
#: (m, nz, neq), all different and both orders of m and nz.
SHAPES = [(7, 9, 3), (5, 11, 6)]


def _operands(seed, m, nz, neq, shared):
    """float32 operands of one fused step. ``shared`` names the matrix
    groups given with batch 1: "R", "g" (Q^-1 G^T), "eq" (the five
    equality operands). R = C C^T - 2 I, so T = R + diag(s/z) is SPD for
    s/z in [3, 4] and not SPD for s/z in [0.5, 1] (lane BAD)."""
    rng = np.random.RandomState(seed)

    def mat(key, rows, cols):
        b = 1 if key in shared else B
        return (rng.rand(b, rows, cols) - 0.5).astype(np.float32)

    C = rng.rand(1 if "R" in shared else B, m, m) / np.sqrt(m)
    ops = dict(
        R=(C @ C.transpose(0, 2, 1) - 2.0 * np.eye(m)).astype(np.float32),
        invQ_GT=mat("g", nz, m), S21=mat("eq", m, neq), W=mat("eq", neq, m),
        invS11=mat("eq", neq, neq), S11=mat("eq", neq, neq),
        invQ_AT=mat("eq", nz, neq))
    z = (rng.rand(B, m) + 0.5).astype(np.float32)
    ratio = rng.rand(B, m) + 3.0
    ratio[BAD] = rng.rand(m) * 0.5 + 0.5
    vecs = dict(x=rng.randn(B, nz), s=z * ratio, z=z, y=rng.randn(B, neq),
                q=rng.randn(B, m), ip=rng.randn(B, nz),
                rb=rng.randn(B, neq))
    return ops, {k: v.astype(np.float32) for k, v in vecs.items()}


def _factors(ops, eq):
    keys = ("R", "invQ_GT") + (("S21", "W", "invS11", "S11", "invQ_AT")
                               if eq else ())
    f = {k: jnp.asarray(ops[k]) for k in keys}
    return jkkt.KKTFactors(L_Q=None, L_S11=None,
                           S21=f.pop("S21", None), W=f.pop("W", None), **f)


def _close(got, want, frozen_input):
    got, want = np.asarray(got), np.asarray(want)
    npt.assert_allclose(got, want, rtol=0,
                        atol=2e-5 * max(1.0, np.abs(want).max()))
    npt.assert_array_equal(got[BAD], frozen_input[BAD])
    npt.assert_array_equal(want[BAD], frozen_input[BAD])


@pytest.mark.parametrize("shared", [(), ("R", "g")],
                         ids=["batched", "shared"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ipm_step_matches_pallas(shape, n_correctors, shared):
    m, nz, _ = shape
    ops, v = _operands(100 * m + n_correctors, m, nz, 1, shared)
    backend = jkkt.pallas_lanes_backend(interpret=True)
    fs = backend.prepare(_factors(ops, eq=False))
    iGT_t, q_t, ip_t = backend.prepare_fused(
        fs.invQ_GT, jnp.asarray(v["q"]), jnp.asarray(v["ip"]))
    want = backend.fused_step(
        fs.R, iGT_t, jnp.asarray(v["x"]), jnp.asarray(v["s"]),
        jnp.asarray(v["z"]), q_t, ip_t, n_correctors)
    t = {k: torch.tensor(a) for k, a in {**ops, **v}.items()}
    got = kernels.ipm_step(t["R"], t["invQ_GT"], t["x"], t["s"], t["z"],
                           t["q"], t["ip"], n_correctors)
    for g, w, name in zip(got[:3], want[:3], "xsz"):
        _close(g.numpy(), w, v[name])
    alpha = got[3].numpy()
    npt.assert_allclose(alpha, np.asarray(want[3]), atol=1e-5)
    assert alpha[BAD] == 0.0 and (alpha[np.arange(B) != BAD] > 0).all()


@pytest.mark.parametrize("shared", [(), ("R", "g", "eq"), ("R", "eq"),
                                    ("eq",)],
                         ids=["batched", "shared", "shared_R_eq",
                              "shared_eq"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ipm_step_eq_matches_pallas(shape, n_correctors, shared):
    m, nz, neq = shape
    ops, v = _operands(100 * m + n_correctors + 7, m, nz, neq, shared)
    backend = jkkt.pallas_lanes_backend(interpret=True)
    fs = backend.prepare(_factors(ops, eq=True))
    eq_ops, q_t, ip_t = backend.prepare_fused_eq(
        fs, jnp.asarray(v["rb"]), jnp.asarray(v["q"]), jnp.asarray(v["ip"]))
    want = backend.fused_step_eq(
        fs.R, eq_ops, *(jnp.asarray(v[k]) for k in "xszy"), q_t, ip_t,
        n_correctors)
    t = {k: torch.tensor(a) for k, a in {**ops, **v}.items()}
    got = kernels.ipm_step_eq(
        t["R"], t["invQ_GT"], t["S21"], t["W"], t["invS11"], t["S11"],
        t["invQ_AT"], t["x"], t["s"], t["z"], t["y"], t["q"], t["ip"],
        t["rb"], n_correctors)
    for g, w, name in zip(got[:4], want[:4], "xszy"):
        _close(g.numpy(), w, v[name])
    alpha = got[4].numpy()
    npt.assert_allclose(alpha, np.asarray(want[4]), atol=1e-5)
    assert alpha[BAD] == 0.0 and (alpha[np.arange(B) != BAD] > 0).all()


@pytest.mark.parametrize("m", [7, 13])
def test_inv_solve_matches_pallas(m):
    rng = np.random.RandomState(m)
    C = rng.rand(B, m, m) / np.sqrt(m)
    T = (C @ C.transpose(0, 2, 1) + np.eye(m)).astype(np.float32)
    Linv = np.linalg.inv(np.linalg.cholesky(T.astype(np.float64))).astype(
        np.float32)
    rhs = rng.randn(B, m).astype(np.float32)
    G_t = pad_spd_lanes(jnp.asarray(Linv.transpose(1, 2, 0)))
    want = np.asarray(inv_solve_lanes(G_t, jnp.asarray(rhs.T),
                                      interpret=True)).T
    got = kernels.inv_solve(torch.tensor(Linv), torch.tensor(rhs)).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # and it solves T x = rhs
    npt.assert_allclose(np.einsum("bij,bj->bi", T, got), rhs, atol=1e-4)


def test_fused_steps_f64_reduce_to_each_other():
    """With no equality rows acting (S21 = W = Q^-1 A^T = 0, rb = y = 0)
    the equality-constrained step is the direct-x step, whose s', z' and
    alpha are the x-free step's; x' = x + alpha dx with dx rebuilt from
    zeta. Float64, so the three plain versions agree to rounding."""
    m, nz, neq = 6, 8, 3
    ops, v = _operands(5, m, nz, neq, ())
    t = {k: torch.tensor(a, dtype=torch.float64)
         for k, a in {**ops, **v}.items()}
    zeta, s1, z1, a1 = kernels.ipm_step_xfree(t["R"], t["s"], t["z"],
                                              t["q"], 1)
    x2, s2, z2, a2 = kernels.ipm_step(t["R"], t["invQ_GT"], t["x"], t["s"],
                                      t["z"], t["q"], t["ip"], 1)
    zero = {k: torch.zeros_like(t[k]) for k in ("S21", "W", "invQ_AT",
                                                "rb", "y")}
    x3, s3, z3, y3, a3 = kernels.ipm_step_eq(
        t["R"], t["invQ_GT"], zero["S21"], zero["W"], t["invS11"],
        t["S11"], zero["invQ_AT"], t["x"], t["s"], t["z"], zero["y"],
        t["q"], t["ip"], zero["rb"], 1)
    dx = -(t["x"] + t["ip"]) - torch.einsum("bnm,bm->bn", t["invQ_GT"],
                                            zeta)
    for got, want in ((s2, s1), (z2, z1), (a2, a1), (s3, s1), (z3, z1),
                      (a3, a1), (x3, x2), (x2, t["x"] + a1[:, None] * dx)):
        npt.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert float(y3.abs().max()) == 0.0 and float(a1[BAD]) == 0.0


@pytest.mark.parametrize("case", ["igt_rows", "x_len", "y_len", "W_batch",
                                  "linv_shape", "dtype"])
def test_step_wrappers_reject_bad_operands(case):
    m, nz, neq = 5, 7, 3
    ops, v = _operands(1, m, nz, neq, ())
    t = {k: torch.tensor(a) for k, a in {**ops, **v}.items()}
    if case == "igt_rows":
        t["invQ_GT"] = t["invQ_GT"][:, :-1].contiguous()
    elif case == "x_len":
        t["x"] = t["x"][:, :-1].contiguous()
    elif case == "y_len":
        t["y"] = t["y"][:, :-1].contiguous()
    elif case == "W_batch":
        t["W"] = t["W"][:3].contiguous()
    elif case == "dtype":
        t["ip"] = t["ip"].double()
    with pytest.raises((ValueError, TypeError)):
        if case == "linv_shape":
            kernels.inv_solve(t["R"][:, :-1].contiguous(), t["s"])
        elif case in ("y_len", "W_batch"):
            kernels.ipm_step_eq(
                t["R"], t["invQ_GT"], t["S21"], t["W"], t["invS11"],
                t["S11"], t["invQ_AT"], t["x"], t["s"], t["z"], t["y"],
                t["q"], t["ip"], t["rb"], 0)
        else:
            kernels.ipm_step(t["R"], t["invQ_GT"], t["x"], t["s"], t["z"],
                             t["q"], t["ip"], 0)
