#!/usr/bin/env python3
"""Receding-horizon MPC on the PyTorch/CUDA port: warm starts across the
horizon, in two formulations.

A batch of box-constrained double-integrator tracking problems is
re-solved as the horizon recedes, as in ``examples/mpc.py`` (the JAX
script), whose flags, defaults and problem data this script takes:

* ``--formulation condensed``: the decision variable is the control
  sequence; Q, G and A are fixed across steps, so the KKT
  pre-factorization is built once with ``prefactor_qp``, and every step
  warm-starts from the previous solution;
* ``--formulation banded``: multiple shooting on the banded structured
  tier (``solve_qp_banded_full``): stage variables (pos, vel, u) make Q
  block-diagonal, |u| <= u_max is a separable box (``g_cols``), the
  dynamics equalities couple adjacent stages; warm-started too.

    python examples/torch_mpc.py [--formulation banded] [--device cuda]

Runs on CUDA unless ``--device cpu`` is given; without CUDA it raises.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import qpth_tpu_torch as qt  # noqa: E402

DT, RHO, U_MAX = 0.1, 0.1, 1.0


def build_mpc_qp(T, dt=DT, rho=RHO):
    """Condensed double-integrator MPC (the JAX script's): z = (u_0..u_{T-1}),
    Q from the tracking objective, G z <= h encodes |u| <= u_max, and one
    equality sum(u) dt = v_goal - v_0 pins the terminal velocity. Returns
    (Q, G, A) in float64 numpy, shared across the batch, and the position
    response S."""
    S = np.zeros((T, T))
    for t in range(T):
        for k in range(t + 1):
            S[t, k] = dt * dt * (t - k + 0.5)
    Q = S.T @ S + rho * np.eye(T)
    G = np.vstack([np.eye(T), -np.eye(T)])
    A = np.full((1, T), dt)
    return Q, G, A, S


def build_banded(T, dt=DT, rho=RHO):
    """Multiple-shooting MPC (the JAX script's ``run_banded``): stage
    variables w_t = (pos_{t+1}, vel_{t+1}, u_t), bs = 3, nb = T. Returns
    (Qd, Qe, A, g, h, g_cols) in float64 numpy."""
    bs, nb = 3, T
    n = nb * bs
    Qd = np.zeros((nb, bs, bs))
    Qd[:, 0, 0], Qd[:, 1, 1], Qd[:, 2, 2] = 2.0, 1e-3, 2.0 * rho
    Qe = np.zeros((nb - 1, bs, bs))
    # pos_{t+1} - pos_t - dt vel_t - dt^2/2 u_t = 0 and
    # vel_{t+1} - vel_t - dt u_t = 0 (t = 0 moves the known state right).
    A = np.zeros((2 * T, n))
    for t in range(T):
        A[2 * t, 3 * t] = 1.0
        A[2 * t + 1, 3 * t + 1] = 1.0
        A[2 * t, 3 * t + 2] = -0.5 * dt * dt
        A[2 * t + 1, 3 * t + 2] = -dt
        if t > 0:
            A[2 * t, 3 * (t - 1)] = -1.0
            A[2 * t, 3 * (t - 1) + 1] = -dt
            A[2 * t + 1, 3 * (t - 1) + 1] = -1.0
    u_idx = [3 * t + 2 for t in range(T)]
    g = np.concatenate([np.ones(T), -np.ones(T)])
    h = np.full(2 * T, U_MAX)
    return Qd, Qe, A, g, h, u_idx + u_idx


def initial_state(B, seed=0):
    """(pos, vel, target) of the JAX script: pos and target ~ N(0, 1) from
    RandomState(seed), vel = 0."""
    npr = np.random.RandomState(seed)
    pos = npr.randn(B).astype(np.float32)
    vel = np.zeros(B, np.float32)
    target = npr.randn(B).astype(np.float32)
    return pos, vel, target


def condensed_step_data(pos, vel, target, S, dt=DT):
    """p and b of one condensed step at the current state: the tracking
    error of the free response through S, and terminal velocity 0."""
    T = S.shape[0]
    tvec = torch.arange(1, T + 1, dtype=pos.dtype, device=pos.device) * dt
    err = pos[:, None] + tvec[None, :] * vel[:, None] - target[:, None]
    return err @ S, (-vel)[:, None]


def banded_step_data(pos, vel, target, n, dt=DT):
    """p and b of one banded step: track pos on every stage, and the
    t = 0 dynamics rows carry the current state."""
    B = pos.shape[0]
    p = torch.zeros((B, n), dtype=pos.dtype, device=pos.device)
    p[:, 0::3] = -2.0 * target[:, None]
    b = torch.zeros((B, 2 * (n // 3)), dtype=pos.dtype, device=pos.device)
    b[:, 0] = pos + dt * vel
    b[:, 1] = vel
    return p, b


def run(formulation, B, T, steps, device, log=print):
    """Run the receding horizon in float32, as the JAX script does; returns
    one record per step: the mean tracking error after the step, the IPM
    iterations, and the wall seconds of the solve."""
    cfg = qt.SolverConfig(check_Q_spd=False)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    pos, vel, target = (t(a) for a in initial_state(B))
    if formulation == "condensed":
        Q, G, A, S = (t(a) for a in build_mpc_qp(T))
        h = t(np.full(2 * T, U_MAX)).expand(B, 2 * T)
        factors = qt.prefactor_qp(Q, G, A, config=cfg, device=device)

        def plan(init):
            p, b = condensed_step_data(pos, vel, target, S)
            return qt.solve_qp_full(Q, p, G, h, A, b, config=cfg, init=init,
                                    factors=factors, device=device)

        u_col = 0
    else:
        Qd, Qe, A, g, h, g_cols = build_banded(T)
        Qd, Qe, A, g, h = (t(a) for a in (Qd, Qe, A, g, h))

        def plan(init):
            p, b = banded_step_data(pos, vel, target, 3 * T)
            return qt.solve_qp_banded_full(Qd, Qe, p, g, h, A, b, config=cfg,
                                           init=init, g_cols=g_cols,
                                           device=device)

        u_col = 2
    init, records = None, []
    for step in range(steps):
        t0 = time.perf_counter()
        sol = plan(init)
        its = int(sol.stats.iterations)          # reads back: synchronizes
        secs = time.perf_counter() - t0
        u0 = sol.z[:, u_col]
        pos, vel = pos + DT * vel + 0.5 * DT * DT * u0, vel + DT * u0
        init = (sol.z, sol.s, sol.lam, sol.nu)   # warm start the next step
        err = float((pos - target).abs().mean())
        records.append(dict(error=err, iterations=its, seconds=secs))
        if log and (step % 5 == 0 or step == steps - 1):
            log(f"step {step:3d}  mean|pos-target| {err:.4f}  "
                f"ipm iters {its}  ({secs * 1e3:.1f} ms)")
    u = sol.z[:, u_col::3] if formulation == "banded" else sol.z
    sat = float((u.abs() > 0.99 * U_MAX).float().mean())
    if log:
        log(f"done ({formulation}); control saturation {sat:.2f}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--formulation", choices=["condensed", "banded"],
                    default="condensed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("qpth_tpu_torch: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    return run(args.formulation, args.batch, args.horizon, args.steps,
               device)


if __name__ == "__main__":
    main()
