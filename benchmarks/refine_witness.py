#!/usr/bin/env python3
"""The eps dial's float32 refinement in the PyTorch port against the JAX
package, on the CPU. From the repository root:

    python3 benchmarks/refine_witness.py [--batch 1024] [--parts dial,linv,lane]

Three parts, each printing its readings and one JSON line:

* ``dial``: bench.py's workload, make_problem(B, 100, 100) rounded to
  float32, solved at ``SolverConfig(eps=1e-8)`` (12 refinement steps with
  the batch-wide early exit) and at ``refine_steps=0`` by the port (its
  kernels' plain versions), by the JAX package on the kernel path that the
  port mirrors (``use_pallas=True``, the Pallas kernels in interpret mode)
  and on its XLA path (the CPU default). For each: refinement steps taken,
  the per-lane relative z error against the port's float64 solve of the
  rounded data (refine_steps=0, so the yardstick does not run the code
  under test) as median, p90 and max, the lanes above 1e-8, and the max
  score.
* ``linv``: the inverse Cholesky factor of 128 of that workload's Q
  (kernel A's recurrence) from the JAX kernel in interpret mode, from the
  port's plain version, and from the port's recurrence with each
  multiply-subtract rounded once (as a fused multiply-add rounds), against
  the float64 factor: the median relative error.
* ``lane``: one lane (``--lane``) of the equality-constrained float32 data
  of ``chip_smoke.py``'s path 1 (B = 4096, Q + I, 50 equality rows). Its unrefined
  port solve is handed, as a warm start with no IPM iteration
  (``max_iter=0``, ``warm_start_min=0``), to one and two refinement steps
  of the port and of the JAX package (one lane is below the batch of 8
  from which the JAX package's kernel path runs, so its XLA path runs
  there): the rows with a negative slack, the smallest slack, the largest
  multiplier, the score, whether the gradients of sum(z^2) are finite, and
  the smallest eigenvalue of the backward's T = R + diag(s / lam) (both
  clamped at ``grad_clamp``) on each package's float32 R.

Nothing here runs on a GPU; the JAX package's part needs x64 on, as its
refinement does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import qpth_tpu  # noqa: E402
import qpth_tpu_torch as qt  # noqa: E402
from qpth_tpu.core import pdipm as jax_pdipm  # noqa: E402
from qpth_tpu_torch.core import pdipm as port_pdipm  # noqa: E402
from qpth_tpu_torch.ops.cuda import kernels  # noqa: E402

NZ = NINEQ = 100
NEQ = 50


def make_problem(nbatch, nz, nineq, seed=0, neq=0):
    """bench.py's generator (as in chip_smoke.py), A and b drawn last."""
    npr = np.random.RandomState(seed)
    L = npr.rand(nbatch, nz, nz)
    Q = np.matmul(L, L.transpose(0, 2, 1)) + 1e-3 * np.eye(nz)
    G = npr.randn(nbatch, nineq, nz)
    z0 = npr.randn(nbatch, nz)
    s0 = npr.rand(nbatch, nineq)
    p = npr.randn(nbatch, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + s0
    if neq == 0:
        return Q, p, G, h
    A = npr.randn(nbatch, neq, nz)
    return Q, p, G, h, A, np.einsum("bmn,bn->bm", A, z0)


class StepCounter:
    """Refinement steps of the last solve in each package: the port's
    _refine returns its count; the JAX package's factor-and-solve is
    wrapped by a debug callback (its steps run in lax.while_loop)."""

    def __init__(self):
        self.port = self.jax = 0
        orig_t, orig_j = port_pdipm._refine, jax_pdipm._refine

        def wrap_port(*args, **kw):
            out = orig_t(*args, **kw)
            self.port = out[3]
            return out

        def bump():
            self.jax += 1

        def wrap_jax(*args, **kw):
            args = list(args)
            kfs = args[11]

            def counted(*a):
                jax.debug.callback(bump)
                return kfs(*a)

            args[11] = counted
            return orig_j(*args, **kw)

        port_pdipm._refine, jax_pdipm._refine = wrap_port, wrap_jax


def lane_err(z, ref):
    z = np.asarray(z, np.float64)
    return np.linalg.norm(z - ref, axis=1) / np.linalg.norm(ref, axis=1)


def part_dial(B, counter):
    d32 = [v.astype(np.float32) for v in make_problem(B, NZ, NINEQ)]
    t0 = time.time()
    ref = qt.solve_qp_full(
        *[torch.from_numpy(v.astype(np.float64)) for v in d32],
        config=qt.SolverConfig(check_Q_spd=False, eps=1e-9, refine_steps=0),
        device="cpu")
    yard = ref.z.numpy()
    out = dict(batch=B, yardstick=dict(
        iterations=int(ref.stats.iterations),
        score_max=float(ref.stats.best_resids.max()),
        score_median=float(ref.stats.best_resids.median())))
    print(f"yardstick (port, float64, refine_steps=0): {out['yardstick']} "
          f"({time.time() - t0:.0f} s)", flush=True)
    for name, kw in (("dial", dict(eps=1e-8)),
                     ("unrefined", dict(eps=1e-8, refine_steps=0))):
        for pkg in ("port", "jax_kernel_path", "jax_xla_path"):
            t0 = time.time()
            counter.port = counter.jax = 0
            if pkg == "port":
                sol = qt.solve_qp_full(
                    *[torch.from_numpy(v) for v in d32],
                    config=qt.SolverConfig(check_Q_spd=False, verbose=-1,
                                           **kw), device="cpu")
                z, score, steps = sol.z, sol.stats.best_resids, counter.port
            else:
                extra = (dict(use_pallas=True) if pkg == "jax_kernel_path"
                         else {})
                sol = qpth_tpu.solve_qp_full(
                    *[jnp.asarray(v) for v in d32],
                    config=qpth_tpu.SolverConfig(check_Q_spd=False,
                                                 verbose=-1, **kw, **extra))
                jax.effects_barrier()
                z, score, steps = sol.z, sol.stats.best_resids, counter.jax
            e = lane_err(z, yard)
            score = np.asarray(score, np.float64)
            r = dict(steps=steps, iterations=int(sol.stats.iterations),
                     z_err_median=float(np.median(e)),
                     z_err_p90=float(np.quantile(e, 0.9)),
                     z_err_max=float(e.max()),
                     lanes_above_1e_8=int((e > 1e-8).sum()),
                     score_max=float(score.max()),
                     score_median=float(np.median(score)))
            out[f"{name}/{pkg}"] = r
            print(f"{name} {pkg}: {r} ({time.time() - t0:.0f} s)",
                  flush=True)
    return out


def part_linv():
    from qpth_tpu.ops.pallas import factor_inv_lanes, pad_spd_lanes

    B = 128
    Q = make_problem(B, NZ, NINEQ)[0].astype(np.float32)
    exact = np.linalg.inv(np.linalg.cholesky(Q.astype(np.float64)))
    M_t = pad_spd_lanes(jnp.transpose(jnp.asarray(Q), (1, 2, 0)))
    g_jax = jnp.transpose(factor_inv_lanes(
        M_t, jnp.zeros((NZ, B), jnp.float32), interpret=True),
        (2, 0, 1))[:, :NZ, :NZ]
    g_port = kernels.factor_inv_plain(torch.from_numpy(Q), torch.zeros(B, NZ))

    # The plain recurrence with each multiply-subtract rounded once.
    T = torch.from_numpy(Q).clone()
    g_once = torch.eye(NZ).expand(B, NZ, NZ).clone()
    for j in range(NZ):
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
    for name, g in (("jax_kernel_interpret", np.asarray(g_jax)),
                    ("port_plain", g_port.numpy()),
                    ("port_plain_rounded_once", g_once.numpy())):
        e = (np.linalg.norm(g.astype(np.float64) - exact, axis=(1, 2))
             / np.linalg.norm(exact, axis=(1, 2)))
        out[name] = float(np.median(e))
    print(f"inverse Cholesky factor of Q, median relative error over {B} "
          f"lanes: {out}", flush=True)
    return out


def part_lane(lane):
    raw = make_problem(4096, NZ, NINEQ, seed=0, neq=NEQ)  # path 1's batch
    data = [v[lane:lane + 1].astype(np.float32)
            for v in ((raw[0] + np.eye(NZ),) + raw[1:])]
    del raw
    base = dict(check_Q_spd=False, verbose=-1, eps=1e-8)
    start = qt.solve_qp_full(*[torch.from_numpy(v) for v in data],
                             config=qt.SolverConfig(**base, refine_steps=0),
                             device="cpu")
    init = [start.z.numpy(), start.s.numpy(), start.lam.numpy(),
            start.nu.numpy()]
    out = dict(lane=lane, start=dict(
        score=float(start.stats.best_resids[0]), min_s=float(init[1].min()),
        min_lam=float(init[2].min())))
    print(f"lane {lane}: the port's unrefined iterate {out['start']}",
          flush=True)

    def finite_torch(cfg):
        args = [torch.tensor(v, requires_grad=True) for v in data]
        z = qt.solve_qp(*args, config=cfg, device="cpu",
                        init=[torch.from_numpy(v) for v in init])
        (z * z).sum().backward()
        return all(bool(torch.isfinite(a.grad).all()) for a in args)

    def finite_jax(cfg):
        args = [jnp.asarray(v) for v in data]
        ini = tuple(jnp.asarray(v) for v in init)
        g = jax.grad(lambda *a: jnp.sum(qpth_tpu.solve_qp(
            *a, config=cfg, init=ini) ** 2), argnums=tuple(range(6)))(*args)
        return all(bool(jnp.isfinite(x).all()) for x in g)

    from qpth_tpu.ops import kkt as jax_kkt
    from qpth_tpu_torch.ops import kkt as port_kkt

    R = dict(port=port_kkt.pre_factor_kkt(
        *(torch.from_numpy(data[i]) for i in (0, 2, 4))).R[0].double(),
        jax_xla_path=torch.from_numpy(np.asarray(jax_kkt.pre_factor_kkt(
            *(jnp.asarray(data[i]) for i in (0, 2, 4)), inverse=True)
            .R[0], np.float64)))
    c = qt.SolverConfig().grad_clamp

    for k in (1, 2):
        kw = dict(base, refine_steps=k, max_iter=0, warm_start_min=0.0)
        for pkg in ("port", "jax_xla_path"):
            if pkg == "port":
                cfg = qt.SolverConfig(**kw)
                sol = qt.solve_qp_full(
                    *[torch.from_numpy(v) for v in data], config=cfg,
                    init=[torch.from_numpy(v) for v in init], device="cpu")
                fin = finite_torch(cfg)
            else:
                cfg = qpth_tpu.SolverConfig(**kw)
                sol = qpth_tpu.solve_qp_full(
                    *[jnp.asarray(v) for v in data], config=cfg,
                    init=tuple(jnp.asarray(v) for v in init))
                fin = finite_jax(cfg)
            s = np.asarray(sol.s, np.float64)
            s32 = torch.tensor(s[0]).float()
            lam32 = torch.tensor(np.asarray(sol.lam, np.float64)[0]).float()
            dinv = (torch.clamp(s32, min=c) / torch.clamp(lam32, min=c)).double()
            t_min = float(torch.linalg.eigvalsh(R[pkg] + torch.diag(dinv)).min())
            r = dict(rows_s_negative=int((s < 0).sum()),
                     min_s=float(s.min()),
                     max_lam=float(np.asarray(sol.lam).max()),
                     score=float(np.asarray(sol.stats.best_resids)[0]),
                     gradients_finite=fin, backward_T_min_eig=t_min)
            out[f"{k}_steps/{pkg}"] = r
            print(f"lane {lane}, {k} refinement step(s) from that iterate, "
                  f"{pkg}: {r}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--lane", type=int, default=3479)
    ap.add_argument("--parts", default="dial,linv,lane")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    counter = StepCounter()
    result = {}
    parts = args.parts.split(",")
    if "dial" in parts:
        result["dial"] = part_dial(args.batch, counter)
    if "linv" in parts:
        result["linv"] = part_linv()
    if "lane" in parts:
        result["lane"] = part_lane(args.lane)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
