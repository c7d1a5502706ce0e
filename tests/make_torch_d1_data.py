#!/usr/bin/env python3
"""Write ``tests/data_torch_d1.npz``: the inputs of ROADMAP §3's D1
measurement (kernel A's float32 inverse Cholesky factor against float64),
so that ``chip_smoke.py`` measures the card's kernels on the very inputs
that the CPU numbers below were taken on. The card has no JAX. From the
repository root, on the CPU:

    python tests/make_torch_d1_data.py

Contents (N = 128 lanes; symmetric matrices as float32 packed lower
triangles, ``np.tril_indices(100)`` order):

* ``Q``: bench.py's Q, ``make_problem(4096, 100, 100, seed=0)``'s first N
  lanes, rounded to float32;
* ``R``, ``s``, ``z``, ``q``: the inputs of the port's fused x-free step
  (kernel B) at iteration ``ITER`` of the float32 default solve of those N
  lanes (the port's plain versions): T = R + diag(s / z);
* ``err_Q_*`` / ``err_T_*``: per-lane relative Frobenius error of the
  inverse factor inv(chol(.)) in float32 against float64, for the JAX
  package's kernel (``factor_inv_lanes``, interpret mode), the port's plain
  version, and the plain recurrence with each multiply-subtract rounded
  once (as a fused multiply-add rounds).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from test_torch_qp import make_problem  # noqa: E402  (bench.py's generator)

N, NZ, ITER = 128, 100, 10
OUT = os.path.join(ROOT, "tests", "data_torch_d1.npz")


def pack(M):
    return M[:, np.tril_indices(M.shape[-1])[0],
             np.tril_indices(M.shape[-1])[1]].astype(np.float32)


def unpack(P, n=NZ):
    """Symmetric (N, n, n) float32 from packed lower triangles."""
    i, j = np.tril_indices(n)
    M = np.zeros((P.shape[0], n, n), np.float32)
    M[:, i, j] = P
    M[:, j, i] = P
    return M


def linv_errors(M, dinv):
    """Per-lane relative errors of inv(chol(M + diag(dinv))) in float32:
    the JAX kernel, the port's plain version, the rounded-once recurrence."""
    import jax.numpy as jnp
    import torch

    from qpth_tpu.ops.pallas import factor_inv_lanes, pad_spd_lanes
    from qpth_tpu_torch.ops.cuda import kernels

    T64 = M.astype(np.float64) + np.apply_along_axis(
        np.diag, 1, dinv.astype(np.float64))
    exact = np.linalg.inv(np.linalg.cholesky(T64))
    B, n = dinv.shape
    M_t = pad_spd_lanes(jnp.transpose(jnp.asarray(M), (1, 2, 0)))
    g_jax = jnp.transpose(factor_inv_lanes(
        M_t, jnp.asarray(dinv.T), interpret=True), (2, 0, 1))[:, :n, :n]
    g_port = kernels.factor_inv_plain(torch.from_numpy(M),
                                      torch.from_numpy(dinv))
    T = torch.from_numpy(M).clone()
    T += torch.diag_embed(torch.from_numpy(dinv))
    g_once = torch.eye(n).expand(B, n, n).clone()
    for j in range(n):
        isq = torch.rsqrt(T[:, j, j]).unsqueeze(-1)
        lk = (T[:, j + 1:, j] * isq).double()
        g_once[:, j, :j + 1] *= isq
        g_once[:, j + 1:, :j + 1] = (
            g_once[:, j + 1:, :j + 1].double()
            - lk.unsqueeze(-1) * g_once[:, j:j + 1, :j + 1].double()).float()
        T[:, j + 1:, j + 1:] = (
            T[:, j + 1:, j + 1:].double()
            - lk.unsqueeze(-1) * lk.unsqueeze(-2)).float()
    out = {}
    for name, g in (("jax_kernel", np.asarray(g_jax)),
                    ("port_plain", g_port.numpy()),
                    ("port_plain_rounded_once", g_once.numpy())):
        out[name] = (np.linalg.norm(g.astype(np.float64) - exact,
                                    axis=(1, 2))
                     / np.linalg.norm(exact, axis=(1, 2)))
    return out


def main():
    import torch

    import qpth_tpu_torch as qt
    from qpth_tpu_torch.ops.cuda import kernels

    Q, p, G, h = (v[:N] for v in make_problem(4096, NZ, NZ, seed=0))
    Q32 = Q.astype(np.float32)
    calls = []
    orig = kernels.ipm_step_xfree

    def capture(R, s, z, q, n_correctors=0):
        calls.append(tuple(v.clone() for v in (R, s, z, q)))
        return orig(R, s, z, q, n_correctors)

    kernels.ipm_step_xfree = capture
    try:
        qt.solve_qp_full(*(torch.tensor(v, dtype=torch.float32)
                           for v in (Q, p, G, h)),
                         config=qt.SolverConfig(check_Q_spd=False),
                         device="cpu")
    finally:
        kernels.ipm_step_xfree = orig
    R, s, z, q = (v.numpy() for v in calls[ITER - 1])
    R = 0.5 * (R + R.transpose(0, 2, 1))
    arrays = dict(Q=pack(Q32), R=pack(R), s=s, z=z, q=q,
                  iteration=np.int32(ITER))
    # The stored (rounded, symmetrized) matrices are the inputs measured.
    for key, M, dinv in (("Q", unpack(arrays["Q"]),
                          np.zeros((N, NZ), np.float32)),
                         ("T", unpack(arrays["R"]), (s / z))):
        for name, e in linv_errors(M, dinv.astype(np.float32)).items():
            arrays[f"err_{key}_{name}"] = e
            print(f"{key} {name}: median {np.median(e):.3e} max "
                  f"{e.max():.3e}")
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
