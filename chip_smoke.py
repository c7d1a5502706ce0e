#!/usr/bin/env python3
"""On-card smoke test and timing of the PyTorch/CUDA port (qpth_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels from qpth_tpu_torch/csrc/, holds every
kernel against its plain PyTorch version, and drives the port's paths
through the kernels at full width (B = 4096, float32 unless said):

* bench.py's workload (random dense QPs, nz = nineq = 100), forward and
  forward+backward, and the OptNet pattern (shared Q/G);
* path 1: the same workload with 50 equality rows, fully batched;
* path 2: the OptNet sudoku layer's QP (nz = nineq = 64, neq = 40, shared
  matrices, batched p, gradients to A);
* path 3: the direct x recurrence (untracked residuals, coeff_x=False) and
  a warm-started re-solve;
* path 4: the float64 default (substitution mode), without and with the
  equality rows;
* path 5: the sudoku layer's QP on the diagonal structured tier
  (``solve_qp_diag``, with and without the fused ``diag_step``),
  ``SpQPFunction`` on its COO patterns, and ``nn.OptNetSudoku``;
* path 6: ``use_pallas="blocked"``, the Cholesky-factor backend (kernels C,
  D and E): bench.py's workload in float32 inverse mode and the OptNet
  pattern, path 1's data in float32 substitution mode, both in float64,
  and (6d) the OptNet pattern in substitution mode, float32 and float64,
  whose Q solves run on one shared factor;
* path 7: mixed-precision refinement (eps = 1e-8: float64 residuals, one
  kernel A or kernel C with rhs per step) on the bench workload, path 1's
  data and under "blocked", float64 card against CPU with refinement on,
  escalation of 32 planted cond ~1e8 lanes to the CPU oracle,
  ``QPSolvers.CPU_ORACLE``, ``KKTSolver.FULL`` / ``IR`` and ``verbose=1``;
* path 8: the hybrid blocked path past kernel A's fit (kernel A on the
  diagonal blocks, cuBLAS for the rest) on the config-4 draws of
  benchmarks/prof_large.py: nz = nineq = 512 under "auto" without and with
  64 equality rows, nz = 512 with nineq = 100 (the fused steps over Q's
  blocked factor), one past each fit (float32 238; float64 167, card
  against CPU), float64 512 card against CPU (kernel A's plain version at
  full width there), ``use_pallas="hybrid"`` within the fit, and the blocked
  functions on the card against the same functions on the CPU; phase 10
  times (a) and (b), sweeps the block size and splits one (a)
  forward+backward by kernel class;
* path 9: the banded and general structured tiers (kernel A on every
  block-Thomas stage, kernel 5 on M with equality rows): (a)
  benchmarks/prof_banded.py's chain at nb = 16, bs = 32 with 0 and 32
  equality rows, ``solve_qp_banded_full`` and ``solve_qp_banded``, against
  the card's float64 solve and that against the dense port; (b)
  benchmarks/prof_mpc_banded.py's receding horizon, cold and warm
  started; (c) benchmarks/prof_general.py's scrambled band at n = 512
  through ``SpQPFunction`` (the general tier), (c') a box pattern (the
  banded tier); (d) float64 card against CPU; (e) refinement at eps =
  1e-8 on (c); and the torch MPC and graph-QP scripts;
* D1 (ROADMAP §3): kernel A's and fused step B's float32 error against
  float64 on the inputs in tests/data_torch_d1.npz;
* ``solve_single`` card against CPU, and the torch example scripts for 5
  steps each;
* path 10: ``QPSolvers.CPU_ORACLE`` on the native C++ oracle against the
  numpy copy, a ``profiling.trace`` of one bench forward and
  ``profiling.solve_timings``; then two gloo ranks on the one card
  (``chip_smoke.py --path10-rank``, started after the build): batch
  sharding (the bench workload forward and forward+backward, float64, the
  OptNet pattern's summed gradients) and tensor parallelism
  (``factor_solve_hybrid_tp`` at m = 2048, ``solve_qp_tp`` at
  n = m = 2048 and at 512 with 32 equality rows), each against this
  process's single-process solve.

It checks the results against float64 solves on the card and on the CPU
and times kernels and solves with CUDA events. Any failed check exits
nonzero. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

preceded by a {"kernels": [...]} line. Without CUDA it exits nonzero and
prints no result.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, NZ, NINEQ = 4096, 100, 100     # bench.py's workload
NEQ = 50                          # equality rows added to it (paths 1, 4)
# With equality rows the generator's Q (gram + 1e-3 I, condition 1e5-1e6) is
# beyond float32 inverse mode: R = G Q^-1 G^T - S21 S11^-1 S21^T cancels
# catastrophically (phase 6 prints the error it leaves). The equality
# workload therefore shifts Q by EQ_SHIFT I (condition ~2.5e3; at 0.1 I the
# forward is accurate but 28 of 4096 lanes still give a non-SPD T, hence
# NaN gradients, in the backward); p, G, h, A, b are the draws as they are.
EQ_SHIFT = 1.0
SUDOKU = dict(nx=64, neq=40)      # the OptNet sudoku layer at n = 2
N_F64_CARD, N_F64_CPU = 256, 64   # lanes re-solved in float64
TOL_F32 = 1e-3                    # kernel vs plain, float32, main shape
TOL_F64 = 1e-10                   # kernel vs plain, float64, odd shape
TOL_D64 = 1e-12                   # kernel D vs plain, float64, every shape
# Kernel 5's sizes in phase 2: both ends of each 32-column slot of a lane,
# path 5's 40, the main 100, and kernel A's largest fits (166 f64, 237 f32).
INV_SOLVE_M = (1, 7, 13, 16, 17, 31, 32, 33, 40, 64, 100, 166, 237)
# Backward clamp at which path 5 holds the float32 gradient to A, path 2's:
# at the default 1e-8 a few lanes of the sudoku QP have more than nx - neq
# active bounds and M = A diag(1/H) A^T (condition ~1e9 there) is beyond
# float32. Phase 9b prints the lanes by clamp; the JAX package gives NaN on
# the same lane (tests/test_torch_diag_f32.py).
GRAD_CLAMP5 = 1e-5
# Lanes of path 5 (of B) whose float32 duals may part between the fused and
# the composed step (0.5%). On a few lanes of the sudoku draw the float32
# duals are set by rounding: the composed step parts from itself on as many
# lanes when only its products change. Phase 9b (b) measures that witness
# beside the gate, holds every step of the kernel against its plain version
# and float64, and holds the two steps to each other on every lane in
# float64; tests/test_torch_diag_f32.py pins the effect in the JAX package.
DUAL_LANES_OFF = B // 200
REPS = 20

#: Published peaks (memory bytes/s, float32 and float64 non-tensor FLOP/s)
#: by card; the H100 SXM figures are NVIDIA's data sheet at 700 W.
PEAKS = [("H100 PCIe", 2.0e12, 51e12, 26e12),
         ("H100 NVL", 3.9e12, 60e12, 30e12),
         ("H200", 4.8e12, 67e12, 34e12), ("H100", 3.35e12, 67e12, 34e12)]


def make_problem(nbatch, nz, nineq, seed=0, neq=0):
    """bench.py's generator: random feasible dense QPs, fully batched.
    With ``neq`` it also returns A and b = A z0, drawn after the other
    draws so that Q, p, G, h do not depend on neq."""
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


def make_sudoku(nbatch, nx, neq, seed=0):
    """The QP of the OptNet sudoku layer (upstream qpth's sudoku notebook,
    cell 10) with dense matrices: shared Q = 0.1 I, G = -I, h = 0, shared
    A ~ U(0, 1), and p = -puzzle per example (a quarter of the cells
    given). b = A z0 at the interior point z0 = 2 / nx, about 1 per row:
    with b = 1 exactly, a random A leaves {x >= 0, A x = 1} empty, and an
    infeasible QP has no solution to hold the solver to."""
    npr = np.random.RandomState(seed)
    A = npr.rand(neq, nx)
    p = -(npr.rand(nbatch, nx) < 0.25).astype(np.float64)
    return (0.1 * np.eye(nx), p, -np.eye(nx), np.zeros(nx), A,
            A @ np.full(nx, 2.0 / nx))


def sudoku_diag(nbatch, seed=0):
    """make_sudoku's draws in the diagonal tier's form (q, p, g, h, A, b):
    q = diag(Q) = 0.1, g = diag(G) = -1, shared q, g, h, A and b."""
    Q, p, G, h, A, b = make_sudoku(nbatch, SUDOKU["nx"], SUDOKU["neq"], seed)
    return np.diag(Q).copy(), p, np.diag(G).copy(), h, A, b


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cmd_out(args):
    try:
        r = subprocess.run(args, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (r.stdout or r.stderr).strip()


def rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


# ---- path 8: the hybrid blocked path past kernel A's fit ----
N8 = 512                 # BASELINE config 4 (benchmarks/prof_large.py:62)
NEQ8 = 64                # its equality rows (prof_large.py:63)
NINEQ8C = 100            # path 8c: nz past the fit, nineq within it
N8_F32_EDGE, N8_F64_EDGE = 238, 167   # one past kernel A's fit
NEQ8_F64 = 16            # equality rows of the float64 edge case
N8_F64_LANES = 8         # lanes of the float64 512 case, card vs CPU
E8_DIFF = 1e-3           # path 8e: median z difference, hybrid vs kernels
SWEEP8 = {"float32": (64, 128, 192), "float64": (64, 128, 160)}
B8_F64_SWEEP = 2048      # the float64 sweep's batch: (B, 512, 512) float64
#                          operands are 2.1 GB each at B = 2048
LANES_OFF8 = B // 200    # lanes whose float32 gradient may be non-finite


def make_large(nbatch, n, nineq, neq=0, seed=0):
    """benchmarks/prof_large.py's config-4 draws, in its order and dtype
    (float32 numpy): L ~ U(0, 1) for Q = L L^T + 0.05 n I, G = randn /
    sqrt(n), z0 shared, h = G z0 + U(0, 1), p, and A = randn / sqrt(n) with
    b = A z0. Q, h and b are formed on the card (:func:`large_tensors`)."""
    npr = np.random.RandomState(seed)
    L = npr.rand(nbatch, n, n).astype(np.float32)
    G = npr.randn(nbatch, nineq, n).astype(np.float32)
    G /= np.float32(np.sqrt(n))
    z0 = npr.randn(n).astype(np.float32)
    s0 = npr.rand(nbatch, nineq).astype(np.float32)
    p = npr.randn(nbatch, n).astype(np.float32)
    A = None
    if neq:
        A = npr.randn(nbatch, neq, n).astype(np.float32)
        A /= np.float32(np.sqrt(n))
    return L, G, z0, s0, p, A


def large_tensors(torch, dev, draws, dtype=None):
    """(Q, p, G, h, A, b) on ``dev`` from :func:`make_large`'s draws,
    float32 (products in full float32), or cast to ``dtype`` after."""
    from qpth_tpu_torch.ops.linalg import full_precision

    L, G, z0, s0, p, A = draws
    n = L.shape[-1]
    with torch.no_grad(), full_precision():
        Lt = torch.from_numpy(L).to(dev)
        Q = torch.matmul(Lt, Lt.transpose(1, 2))
        del Lt
        Q += 0.05 * n * torch.eye(n, device=dev)
        Gt = torch.from_numpy(G).to(dev)
        z0t = torch.from_numpy(z0).to(dev)
        h = torch.matmul(Gt, z0t) + torch.from_numpy(s0).to(dev)
        out = [Q, torch.from_numpy(p).to(dev), Gt, h]
        if A is not None:
            At = torch.from_numpy(A).to(dev)
            out += [At, torch.matmul(At, z0t)]
        else:
            out += [None, None]
    if dtype is not None:
        out = [None if v is None else v.to(dtype) for v in out]
    return out


@contextlib.contextmanager
def kernel_a_dims(kernels):
    """Count kernel A's launches on CUDA tensors by (variant, B, m, dtype,
    R shared or batched), through the wrapper every caller goes by."""
    import collections

    seen = collections.Counter()
    orig = kernels.factor_inv

    def counted(R, dinv, rhs=None, z=None):
        if R.device.type == "cuda":
            variant = ("factor_inv" if rhs is None else "factor_inv_solve"
                       if z is None else "factor_inv_solve_rz")
            seen[(variant, int(dinv.shape[0]), int(dinv.shape[1]),
                  str(R.dtype).split(".")[-1],
                  "shared" if R.shape[0] == 1 else "batched")] += 1
        return orig(R, dinv, rhs, z)

    kernels.factor_inv = counted
    try:
        yield seen
    finally:
        kernels.factor_inv = orig


def dims_summary(seen):
    return {f"{v} B={b} m={m} {dt} {sh}": c
            for (v, b, m, dt, sh), c in sorted(seen.items())}


def lane_rel(z, ref):
    """Per-lane relative error of z against ref (float64)."""
    return ((z.double() - ref).norm(dim=1)
            / ref.norm(dim=1).clamp_min(1e-300))


KKT_TOL8 = 1e-9          # the float64 yardstick's relative KKT residuals


def kkt_residuals(args, sol):
    """The KKT conditions of min 1/2 z'Qz + p'z s.t. Gz <= h, Az = b at a
    solution, each the largest lane's max-norm relative to the max norm of
    its terms (at least 1): stationarity Qz + p + G'lam + A'nu, primal
    feasibility Gz + s - h, Az - b, complementarity s lam; and the least s
    and lam. None of it goes through the solver's linear algebra, so it
    certifies a reference solve independently of the path under test.
    Complementarity is max s_i lam_i over max s max lam (at least 1)."""
    Q, p, G, h, A, b = (list(args) + [None, None])[:6]

    def mv(M, v):
        return (M @ v.unsqueeze(-1)).squeeze(-1)

    def rel_(terms, r):
        scale = sum(t.abs().amax(dim=1) for t in terms).clamp_min(1.0)
        return float((r.abs().amax(dim=1) / scale).max())

    Qz, GTl, Gz = mv(Q, sol.z), mv(G.transpose(1, 2), sol.lam), mv(G, sol.z)
    terms = [Qz, p.expand_as(Qz), GTl]
    if A is not None:
        terms.append(mv(A.transpose(1, 2), sol.nu))
    gap = (sol.s * sol.lam).amax(dim=1) / (
        sol.s.amax(dim=1) * sol.lam.amax(dim=1)).clamp_min(1.0)
    out = dict(stationarity=rel_(terms, sum(terms)),
               primal=rel_([Gz, sol.s, h], Gz + sol.s - h),
               complementarity=float(gap.max()),
               min_s=float(sol.s.min()), min_lam=float(sol.lam.min()))
    if A is not None:
        Az = mv(A, sol.z)
        out["equality"] = rel_([Az, b], Az - b)
    return out


def phase_9e(torch, qt, kernels, dev, bench):
    """Path 8: the hybrid blocked path past kernel A's fit
    (``use_pallas="hybrid"``, and "auto" past the fit). ``bench``: the
    bench workload's float32 tensors and phase 3's kernels-backend
    solution, for (e). Returns (launches, facts, data): the counts and
    readings of every case, and (a)/(b)'s float32 tensors for phase 10."""
    from qpth_tpu_torch.ops import hybrid

    launches, facts = {}, {}
    torch.cuda.empty_cache()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    cfg = qt.SolverConfig(check_Q_spd=False)
    cfg64 = qt.SolverConfig(check_Q_spd=False)     # float64 default
    t0 = time.perf_counter()
    draws = make_large(B, N8, N8, neq=NEQ8, seed=0)
    Q, p, G, h, A, b = large_tensors(torch, dev, draws)
    del draws
    print(f"# phase 9e (path 8): config-4 draws B={B} nz=nineq={N8} "
          f"neq={NEQ8} made in {time.perf_counter() - t0:.1f} s; "
          f"{base_mb:.0f} MiB allocated before")

    def run(tag, args, config, expect, allow=()):
        """Forward (counts reset just before, read just after), the z
        error of the float32 solve against the card's float64 solve of the
        first N_F64_CARD lanes, that yardstick certified by its KKT
        residuals (it runs the same path in float64), and forward+backward
        with the finite-lanes gate. ``expect``: the kernels that must
        launch in the forward; ``allow``: those that may launch beside
        them."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with kernel_a_dims(kernels) as dims:
            sol = qt.solve_qp_full(*args, config=config)
            torch.cuda.synchronize()
        fwd = {k: v for k, v in kernels.LAUNCHES.items() if v}
        its_ = int(sol.stats.iterations)
        peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
        for name_ in ("z", "lam", "s"):
            check(bool(torch.isfinite(getattr(sol, name_)).all()),
                  f"{tag}: {name_} not finite")
        check(sum(dims.values()) == sum(
            fwd.get(k, 0) for k in ("factor_inv", "factor_inv_solve",
                                    "factor_inv_solve_rz")),
              f"{tag}: kernel A's dims do not count its launches")
        with torch.no_grad():
            args64 = [None if v is None else v[:N_F64_CARD].double()
                      for v in args]
            ref = qt.solve_qp_full(*args64, config=cfg64)
            cert = kkt_residuals(args64, ref)
            del args64
        err = lane_rel(sol.z[:N_F64_CARD], ref.z)
        med = float(err.median())
        print(f"# {tag}: iterations {its_}, launches {fwd}, kernel A "
              f"launches by dims {dims_summary(dims)}; f32 vs f64 (card) "
              f"over {N_F64_CARD} lanes: median relative z error "
              f"{med:.3e}, max {float(err.max()):.3e} (f64 iterations "
              f"{int(ref.stats.iterations)}); peak memory {peak_f:.2f} GiB")
        print(f"# {tag}: the f64 yardstick's KKT residuals over "
              f"{N_F64_CARD} lanes: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in cert.items()))
        check(max(v for k, v in cert.items() if not k.startswith("min_"))
              <= KKT_TOL8 and cert["min_s"] >= 0 and cert["min_lam"] >= 0,
              f"{tag}: the f64 yardstick fails its KKT conditions {cert}")
        check(med <= 2e-2, f"{tag}: f32 median relative error {med:.3e} "
              "> 2e-2")
        for k in expect:
            check(fwd.get(k, 0) > 0, f"{tag}: {k} did not launch")
        check(set(fwd) <= set(expect) | set(allow),
              f"{tag}: launches {fwd} outside {expect} and {allow}")
        out = dict(iterations=its_, z_err_median=med,
                   z_err_max=float(err.max()), forward_peak_gib=peak_f,
                   kernel_a_dims=dims_summary(dims),
                   kernel_a_m=sorted({k[2] for k in dims}),
                   f64_yardstick_kkt=cert)
        launches_ = dict(forward=fwd)
        del ref, sol
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        leaves = [None if v is None else v.clone().requires_grad_(True)
                  for v in args]
        z = qt.solve_qp(*leaves, config=config)
        (z * z).sum().backward()
        torch.cuda.synchronize()
        launches_["forward_backward"] = {
            k: v for k, v in kernels.LAUNCHES.items() if v}
        bad = torch.zeros(z.shape[0], dtype=torch.bool, device=dev)
        for v in leaves:
            if v is not None:
                bad |= ~torch.isfinite(v.grad.reshape(
                    v.shape[0], -1)).all(dim=1)
        n_bad = int(bad.sum())
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"# {tag}: forward+backward launches "
              f"{launches_['forward_backward']}; lanes with a "
              f"non-finite gradient {n_bad} of {z.shape[0]}; peak "
              f"memory {peak_b:.2f} GiB")
        check(n_bad <= LANES_OFF8,
              f"{tag}: {n_bad} lanes with a non-finite gradient")
        out.update(nonfinite_grad_lanes=n_bad,
                   forward_backward_peak_gib=peak_b)
        del leaves, z
        torch.cuda.empty_cache()
        return out, launches_

    # (a) nz = nineq = 512, neq = 0: "auto" routes to the hybrid backend.
    facts["a"], launches["a"] = run(
        f"phase 9e (path 8a): auto f32 B={B} nz=nineq={N8}",
        (Q, p, G, h), cfg, ("factor_inv",))
    # (b) the same with neq = 64 (S11 within the fit: kernel A on it).
    facts["b"], launches["b"] = run(
        f"phase 9e (path 8b): auto f32 B={B} nz=nineq={N8} neq={NEQ8}",
        (Q, p, G, h, A, b), cfg, ("factor_inv",))
    # (c) nz = 512 past the fit, nineq = 100 within it: Q as facQ, the
    # fused steps over its products (G's first 100 rows, h's with them).
    Gc, hc = G[:, :NINEQ8C].contiguous(), h[:, :NINEQ8C].contiguous()
    within = ("factor_inv_solve_rz", "factor_inv_solve", "inv_solve")
    facts["c"], launches["c"] = run(
        f"phase 9e (path 8c): auto f32 B={B} nz={N8} nineq={NINEQ8C}",
        (Q, p, Gc, hc), cfg, ("factor_inv", "ipm_step_xfree"), within)
    facts["c_eq"], launches["c_eq"] = run(
        f"phase 9e (path 8c): auto f32 B={B} nz={N8} nineq={NINEQ8C} "
        f"neq={NEQ8}", (Q, p, Gc, hc, A, b), cfg,
        ("factor_inv", "ipm_step_eq"), within)
    del Gc, hc

    # (d) one past each fit: float32 238 under "auto"; float64 167, card
    # against CPU, in substitution mode and in inverse mode (facQ); and
    # float64 512 with NEQ8 rows in substitution mode over N8_F64_LANES
    # lanes: T in eight blocks on the card against kernel A's plain
    # version at full width on the CPU, which does not go through
    # ops/hybrid.py.
    e32 = large_tensors(torch, dev, make_large(B, N8_F32_EDGE, N8_F32_EDGE,
                                               seed=1))
    facts["d_f32"], launches["d_f32"] = run(
        f"phase 9e (path 8d): auto f32 B={B} nz=nineq={N8_F32_EDGE}",
        e32[:4], cfg, ("factor_inv",))
    check(facts["d_f32"]["kernel_a_m"] == sorted(
        {hybrid.BLOCK, N8_F32_EDGE % hybrid.BLOCK} - {0}),
          "path 8d: kernel A did not run on the blocks of 238")
    del e32
    eps9 = dict(eps=1e-9, refine_steps=0, check_Q_spd=False)
    d64 = {N8_F64_EDGE: make_large(N_F64_CPU, N8_F64_EDGE, N8_F64_EDGE,
                                   neq=NEQ8_F64, seed=2),
           N8: make_large(N8_F64_LANES, N8, N8, neq=NEQ8, seed=3)}
    for key, n_d, cfg_d in (
            ("d_f64_subst", N8_F64_EDGE, qt.SolverConfig(**eps9)),
            ("d_f64_inverse", N8_F64_EDGE, qt.SolverConfig(
                solve_method="inverse", **eps9)),
            ("d_f64_subst_512", N8, qt.SolverConfig(**eps9))):
        got = {}
        card_args = large_tensors(torch, dev, d64[n_d], torch.float64)
        for device in (dev, "cpu"):
            args = [v.to(device) for v in card_args]
            kernels.reset_launches()
            with kernel_a_dims(kernels) as dims:
                sol = qt.solve_qp_full(*args, config=cfg_d, device=device)
            leaves = [v.clone().requires_grad_(True) for v in args]
            z = qt.solve_qp(*leaves, config=cfg_d, device=device)
            (z * z).sum().backward()
            got[str(device)] = (sol, [v.grad for v in leaves], dims)
        (sc, gc, dims), (sh, gh, _) = got[str(dev)], got["cpu"]
        ez, enu = rel(sc.z.cpu(), sh.z), rel(sc.nu.cpu(), sh.nu)
        eg = {n_: rel(a.cpu(), c) for n_, a, c in zip("QpGhAb", gc, gh)}
        print(f"# phase 9e (path 8d, {key}) f64 nz=nineq={n_d} "
              f"neq={card_args[4].shape[1]}: card vs CPU over "
              f"{card_args[0].shape[0]} lanes: z "
              f"{ez:.3e}, nu {enu:.3e}, gradients "
              + ", ".join(f"{n_} {e:.3e}" for n_, e in eg.items())
              + f"; iterations {int(sc.stats.iterations)} / "
              f"{int(sh.stats.iterations)}; card's kernel A launches "
              f"{dims_summary(dims)}")
        check(ez <= 1e-8 and enu <= 1e-8, f"path 8d {key}: z / nu")
        check(all(e <= 1e-7 for e in eg.values()),
              f"path 8d {key}: gradients")
        check(int(sc.stats.iterations) == int(sh.stats.iterations),
              f"path 8d {key}: iterations differ")
        check(sum(dims.values()) > 0 and all(
            k[2] <= hybrid.BLOCK for k in dims),
              f"path 8d {key}: kernel A did not run on blocks")
        facts[key] = dict(z=ez, nu=enu, grads=eg,
                          iterations=int(sc.stats.iterations),
                          kernel_a_dims=dims_summary(dims))
    del d64, got

    # (e) use_pallas="hybrid" within the fit (one block) against the kernels
    # backend, the same iterations or one more. Two float32 IPM runs whose
    # factors round differently part by the loop's own float32 error (the
    # card read a median difference of 1.955e-04 beside errors of 2.1e-04
    # and 1.7e-04 against float64), not by one rounding: the difference is
    # gated at E8_DIFF, and each error against float64 as below.
    f32b, sol_k, err_k = bench
    cfg_h = qt.SolverConfig(check_Q_spd=False, use_pallas="hybrid")
    kernels.reset_launches()
    sol_h = qt.solve_qp_full(*f32b, config=cfg_h)
    torch.cuda.synchronize()
    le = {k: v for k, v in kernels.LAUNCHES.items() if v}
    with torch.no_grad():
        ref = qt.solve_qp_full(*(v[:N_F64_CARD].double() for v in f32b),
                               config=qt.SolverConfig(
                                   solve_method="inverse", resid_every=7,
                                   check_Q_spd=False))
    err_h = float(lane_rel(sol_h.z[:N_F64_CARD], ref.z).median())
    diff = float(lane_rel(sol_h.z, sol_k.z.double()).median())
    its_h, its_k = int(sol_h.stats.iterations), int(sol_k.stats.iterations)
    print(f"# phase 9e (path 8e): use_pallas='hybrid' f32 B={B} nz=nineq="
          f"{NZ}: iterations {its_h} (kernels backend {its_k}), launches "
          f"{le}; median relative z error vs f64 {err_h:.3e} (kernels "
          f"backend {err_k:.3e}); median relative z difference between "
          f"the two {diff:.3e}")
    check(its_h in (its_k, its_k + 1), "path 8e: iterations")
    check(diff <= E8_DIFF, f"path 8e: hybrid and kernels backends part by "
          f"{diff:.3e} > {E8_DIFF}")
    check(err_h <= max(2 * err_k, 1e-6) and err_h <= 2e-2,
          "path 8e: hybrid error above twice the kernels backend's")
    check(le.get("factor_inv", 0) > 0 and not le.get("ipm_step_xfree"),
          "path 8e: the hybrid backend did not run kernel A alone")
    facts["e"] = dict(iterations=its_h, kernels_iterations=its_k,
                      z_err_median=err_h, kernels_z_err_median=err_k,
                      z_diff_median=diff)
    launches["e"] = dict(forward=le)
    del sol_h, ref

    # (f) the blocked functions on the card against the same functions on
    # the CPU (kernel A's plain version), phase 2 style.
    errs_f = {}
    for dtype, m_, tol in ((torch.float32, N8, TOL_F32),
                           (torch.float32, N8_F32_EDGE, TOL_F32),
                           (torch.float64, N8, TOL_F64),
                           (torch.float64, N8_F64_EDGE, TOL_F64)):
        g_ = torch.Generator(device=dev).manual_seed(80 + m_)
        Lr = torch.rand(64, m_, m_, generator=g_, device=dev,
                        dtype=torch.float64)
        T_ = (Lr @ Lr.transpose(1, 2) / m_ + torch.eye(
            m_, device=dev, dtype=torch.float64)).to(dtype)
        v_ = torch.rand(64, m_, generator=g_, device=dev,
                        dtype=torch.float64).to(dtype) - 0.5
        V_ = torch.rand(64, m_, 96, generator=g_, device=dev,
                        dtype=torch.float64).to(dtype) - 0.5
        dinv_ = torch.rand(64, m_, generator=g_, device=dev,
                           dtype=torch.float64).to(dtype)

        def funcs(T, v, V, dinv):
            fac, x = hybrid.factor_solve_hybrid(T, v, dinv=dinv)
            fac0 = hybrid.factor_hybrid(T)
            return dict(
                factor=tuple(fac.Gs) + tuple(fac.Ps[:-1]),
                factor_solve=x, solve=hybrid.solve_hybrid(fac0, v),
                solve_mat=hybrid.solve_hybrid_mat(fac0, V),
                spd_inv=hybrid.spd_inv_hybrid(T))

        kernels.reset_launches()
        with kernel_a_dims(kernels) as dims:
            card = funcs(T_, v_, V_, dinv_)
            torch.cuda.synchronize()
        print(f"# phase 9e (path 8f): {dtype} m={m_}: kernel A launches by "
              f"dims {dims_summary(dims)}")
        check(sum(dims.values()) == kernels.LAUNCHES["factor_inv"] > 0,
              f"path 8f: kernel A did not launch on the blocks at m={m_}")
        host = funcs(*(t.cpu() for t in (T_, v_, V_, dinv_)))
        for name_ in card:
            a_ = card[name_] if isinstance(card[name_], tuple) else (
                card[name_],)
            c_ = host[name_] if isinstance(host[name_], tuple) else (
                host[name_],)
            e_abs = max(float((x.cpu() - y).abs().max())
                        for x, y in zip(a_, c_))
            scale = max(float(y.abs().max()) for y in c_)
            e_sc = e_abs / max(scale, 1.0)
            errs_f[f"{name_} {str(dtype).split('.')[-1]} m={m_}"] = e_abs
            print(f"# phase 9e (path 8f): {name_} {dtype} B=64 m={m_}: max "
                  f"abs err {e_abs:.3e}, scaled {e_sc:.3e} (tol {tol:.0e})")
            check(e_sc <= tol, f"path 8f: {name_} {dtype} m={m_} "
                  f"{e_sc:.3e} > {tol}")
    facts["f_max_abs_err"] = errs_f
    return launches, facts, dict(a=(Q, p, G, h), b=(Q, p, G, h, A, b))


def d1_measure(torch, kernels, dev):
    """ROADMAP §3's D1 on the card: kernel A's float32 inverse factor of
    bench.py's Q and of one iteration's T, and fused step B on that
    iteration, against float64 on the same inputs
    (tests/data_torch_d1.npz, written on the CPU by
    tests/make_torch_d1_data.py beside the CPU readings)."""
    data = np.load(os.path.join(ROOT, "tests", "data_torch_d1.npz"))
    n = data["s"].shape[1]
    ii, jj = np.tril_indices(n)

    def sym(P):
        M = np.zeros((P.shape[0], n, n), np.float32)
        M[:, ii, jj] = P
        M[:, jj, ii] = P
        return torch.from_numpy(M).to(dev)

    def linv_err(G_, T64):
        exact = torch.linalg.solve_triangular(
            torch.linalg.cholesky(T64),
            torch.eye(n, dtype=torch.float64, device=dev), upper=False)
        return ((G_.double() - exact).norm(dim=(1, 2))
                / exact.norm(dim=(1, 2)))

    s, z, q = (torch.from_numpy(data[k]).to(dev) for k in ("s", "z", "q"))
    out = {}
    for key, M, dinv in (("Q", sym(data["Q"]), torch.zeros_like(s)),
                         ("T", sym(data["R"]), s / z)):
        T64 = M.double() + torch.diag_embed(dinv.double())
        e_card = linv_err(kernels.factor_inv(M, dinv.contiguous()), T64)
        e_host = linv_err(kernels.factor_inv_plain(
            M.cpu(), dinv.cpu()).to(dev), T64)
        out[key] = dict(
            card_median=float(e_card.median()), card_max=float(e_card.max()),
            plain_cpu_median=float(e_host.median()),
            **{f"{k}_median": float(np.median(data[f"err_{key}_{k}"]))
               for k in ("jax_kernel", "port_plain",
                         "port_plain_rounded_once")})
        print(f"# D1: inverse factor of {key} (B={M.shape[0]}, m={n}, f32) "
              f"against f64: kernel A on the card median "
              f"{out[key]['card_median']:.3e} max {out[key]['card_max']:.3e}"
              f"; plain version on this host's CPU "
              f"{out[key]['plain_cpu_median']:.3e}; stored CPU readings: "
              f"JAX kernel {out[key]['jax_kernel_median']:.3e}, port plain "
              f"{out[key]['port_plain_median']:.3e}, rounded once "
              f"{out[key]['port_plain_rounded_once_median']:.3e}")
    R = sym(data["R"])
    zeta = kernels.ipm_step_xfree(R, s, z, q)[0]
    zeta64 = kernels.ipm_step_xfree_plain(R.double(), s.double(), z.double(),
                                          q.double())[0]
    zeta32 = kernels.ipm_step_xfree_plain(R.cpu(), s.cpu(), z.cpu(),
                                          q.cpu())[0].to(dev)
    e_b, e_p = lane_rel(zeta, zeta64), lane_rel(zeta32, zeta64)
    out["B_zeta"] = dict(card_median=float(e_b.median()),
                         card_max=float(e_b.max()),
                         plain_cpu_median=float(e_p.median()),
                         plain_cpu_max=float(e_p.max()))
    print(f"# D1: fused step B on iteration {int(data['iteration'])}'s "
          f"(R, s, z, q) (it returns no Linv; its output zeta = z + dz "
          f"against the plain step in f64): card median "
          f"{out['B_zeta']['card_median']:.3e} max "
          f"{out['B_zeta']['card_max']:.3e}; plain version on the CPU "
          f"median {out['B_zeta']['plain_cpu_median']:.3e} max "
          f"{out['B_zeta']['plain_cpu_max']:.3e}")
    return out


def phase_9f(torch, qt, kernels, dev):
    """``solve_single`` on one bench-sized QP (float64, card against CPU at
    1e-9) and each torch example script for 5 steps on the card."""
    import importlib.util

    Q, p, G, h = (v[0] for v in make_problem(1, NZ, NINEQ, seed=0))
    Q = Q + np.eye(NZ)
    got = {}
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        sol = qt.solve_single(*(torch.tensor(v) for v in (Q, p, G, h)),
                              device=device)
        got[str(device)] = (sol, time.perf_counter() - t0)
    (sc, tc), (sh, th) = got[str(dev)], got["cpu"]
    e = rel(sc.z.cpu(), sh.z)
    print(f"# phase 9f: solve_single f64 nz=nineq={NZ}: card vs CPU z "
          f"{e:.3e}, iterations {int(sc.iterations)} / {int(sh.iterations)}"
          f", resid {float(sc.resid):.3e}; {tc:.2f} s on the card, {th:.2f}"
          " s on the CPU")
    check(e <= 1e-9 and int(sc.iterations) == int(sh.iterations),
          "solve_single card vs CPU")
    out = dict(solve_single=dict(z=e, iterations=int(sc.iterations)))
    for name in ("torch_cls_layer", "torch_sudoku"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses, acc = mod.main(["--steps", "5", "--device", "cuda"])
        torch.cuda.synchronize()
        lk = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"# phase 9f: examples/{name}.py, 5 steps on the card: losses "
              + ", ".join(f"{v:.5f}" for v in losses)
              + f"; final accuracy {acc:.3f}; launches {lk}")
        check(len(losses) == 5 and all(np.isfinite(losses)),
              f"{name}: non-finite loss")
        check(sum(lk.values()) > 0, f"{name}: no kernel launched")
        out[name] = dict(losses=losses, accuracy=acc, launches=lk)
    return out


def path8_timings(torch, qt, kernels, dev, data, host_ms, report, spread):
    """Phase 10 for path 8: forward and forward+backward ms of (a) and (b)
    (median of 5), the block-size sweep (forward ms, median of 3; float64
    at B8_F64_SWEEP lanes), and the device split of one (a)
    forward+backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qpth_tpu_torch.ops import hybrid

    cfg = qt.SolverConfig(check_Q_spd=False)

    def grads(args):
        leaves = [v.clone().requires_grad_(True) for v in args]
        z = qt.solve_qp(*leaves, config=cfg)
        (z * z).sum().backward()

    out = {}
    for key in ("a", "b"):
        args = data[key]
        fwd = report(f"path8 ({key}) forward", host_ms(
            lambda: qt.solve_qp_full(*args, config=cfg)))
        lo_f, hi_f = spread["last"]
        fb = report(f"path8 ({key}) forward+backward", host_ms(
            lambda: grads(args)))
        lo_b, hi_b = spread["last"]
        out[key] = dict(forward_ms=fwd, forward_min=lo_f, forward_max=hi_f,
                        forward_backward_ms=fb, forward_backward_min=lo_b,
                        forward_backward_max=hi_b)

    sweep = {}
    for dt_name, blocks in SWEEP8.items():
        dtype = getattr(torch, dt_name)
        nb = B if dtype == torch.float32 else B8_F64_SWEEP
        args = [v[:nb].to(dtype) for v in data["a"]]
        keep = hybrid.BLOCK
        sweep[dt_name] = {"batch": nb}
        try:
            for blk in blocks:
                check(kernels.fits(blk, dtype), f"sweep: block {blk} does "
                      f"not fit kernel A in {dt_name}")
                hybrid.BLOCK = blk
                ms = host_ms(lambda: qt.solve_qp_full(*args, config=cfg),
                             reps=3)
                lo, hi = spread["last"]
                its_ = int(qt.solve_qp_full(*args,
                                            config=cfg).stats.iterations)
                print(f"# phase 10: path8 sweep {dt_name} B={nb} nz=nineq="
                      f"{N8} block {blk}: forward {ms:.2f} ms (min {lo:.2f}"
                      f", max {hi:.2f}), iterations {its_}"
                      + (" (default)" if blk == keep else ""))
                sweep[dt_name][str(blk)] = dict(forward_ms=ms, min=lo,
                                                max=hi, iterations=its_)
        finally:
            hybrid.BLOCK = keep
        sweep[dt_name]["default"] = keep
        del args
        torch.cuda.empty_cache()
    out["sweep"] = sweep

    # Device split of one (a) forward+backward by kernel class.
    args = data["a"]
    grads(args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads(args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = [(e.self_device_time_total / 1e3, e.count, e.key)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in by)

    def cls(name):
        n_ = name.lower()
        if "factor_inv" in n_:
            return "kernel A"
        if "ipm_step" in n_ or "inv_solve" in n_:
            return "other hand kernels"
        if any(s in n_ for s in ("gemm", "gemv", "cutlass", "xmma",
                                 "sm90_", "dot_kernel", "splitk")):
            return "GEMM/GEMV (cuBLAS)"
        return "elementwise, reductions, copies"

    split = {}
    for t, c, k in by:
        s_ = split.setdefault(cls(k), [0.0, 0])
        s_[0] += t
        s_[1] += c
    out["trace"] = dict(
        wall_ms=wall, device_busy_ms=busy or None,
        device_idle_share=(1 - busy / wall) if busy else None,
        split={k: dict(ms=v[0], launches=v[1]) for k, v in split.items()},
        top=[dict(ms=t, count=c, name=k[:80])
             for t, c, k in sorted(by, reverse=True)[:8]])
    if busy:
        print(f"# phase 10: trace of one path 8 (a) forward+backward: wall "
              f"{wall:.2f} ms, device busy {busy:.2f} ms, idle share "
              f"{1 - busy / wall:.3f}; by class: " + ", ".join(
                  f"{k} {v[0]:.2f} ms x{v[1]}" for k, v in sorted(
                      split.items(), key=lambda kv: -kv[1][0])))
        for t, c, k in sorted(by, reverse=True)[:8]:
            print(f"#   {t:9.3f} ms  x{c:<5d} {k[:90]}")
    else:
        print("# phase 10: trace (path 8 a): the profiler saw no device "
              "time (not measured)")
    return out



# ---- path 9: the banded and general structured tiers ----
NB9, BS9, NEQ9 = 16, 32, 32   # benchmarks/prof_banded.py's chain at nz = 512
N9B, BS9B = 256, 16           # benchmarks/prof_mpc_banded.py's defaults
STEPS9B, DRIFT9B = 8, 0.02
N9C, W9C = 512, 8             # benchmarks/prof_general.py, n = 512 (w = 8)
N9_BOX = 512                  # (c') diagonal Q with box rows [I; -I]
STAGE_M9 = (3, 16, 32)        # stage widths: examples/mpc.py, (b), (a)


def make_chain(torch, dev, nbatch, nb, bs, neq, seed=0, coupling=0.35):
    """benchmarks/prof_banded.py:40-56's ``make_chain`` draws (float64
    numpy, in its order); the block products are formed on the card in
    float64. Returns (Qd, Qe, p, g, h, A, b), float64 on ``dev``."""
    rng = np.random.RandomState(seed)
    n = nb * bs
    Ld = np.tril(rng.randn(nbatch, nb, bs, bs) * 0.4) + np.eye(bs) * 1.8
    Le = coupling * rng.randn(nbatch, nb - 1, bs, bs)
    g = np.where(np.abs(rng.randn(nbatch, n)) < 0.3, 0.7,
                 rng.randn(nbatch, n))
    z0 = rng.randn(nbatch, n)
    h = g * z0 + rng.rand(nbatch, n) + 0.2
    p = rng.randn(nbatch, n)
    A = rng.randn(neq, n) / np.sqrt(n)
    b = z0 @ A.T
    with torch.no_grad():
        Ld, Le = (torch.from_numpy(v).to(dev) for v in (Ld, Le))
        Qd = Ld @ Ld.transpose(-1, -2)
        Qd[:, 1:] += Le @ Le.transpose(-1, -2)
        Qe = Le @ Ld[:, :-1].transpose(-1, -2)
    return [Qd, Qe] + [torch.from_numpy(v).to(dev) for v in (p, g, h, A, b)]


def make_mpc_chain(torch, dev, nbatch, n, bs, steps, drift, seed=0):
    """benchmarks/prof_mpc_banded.py:51-63's draws (float32 numpy; Qd's
    product on the card in full float32), then its drift sequence
    (:78-79). Returns ((Qd, Qe, p, g, h), drifts), float32 on ``dev``."""
    from qpth_tpu_torch.ops.linalg import full_precision

    npr = np.random.RandomState(seed)
    nb = n // bs
    Ld = np.tril(npr.rand(nbatch, nb, bs, bs).astype(np.float32) * 0.3) \
        + np.eye(bs, dtype=np.float32)
    Qe = (0.1 * npr.randn(nbatch, nb - 1, bs, bs)).astype(np.float32)
    g = np.where(np.abs(npr.randn(nbatch, n)) < 0.3, 0.7,
                 npr.randn(nbatch, n)).astype(np.float32)
    z0 = npr.randn(nbatch, n).astype(np.float32)
    h = (g * z0 + npr.rand(nbatch, n) + 0.2).astype(np.float32)
    p = npr.randn(nbatch, n).astype(np.float32)
    drifts = [torch.from_numpy(
        drift * npr.randn(nbatch, n).astype(np.float32)).to(dev)
        for _ in range(steps)]
    with torch.no_grad(), full_precision():
        Ld = torch.from_numpy(Ld).to(dev)
        Qd = Ld @ Ld.transpose(-1, -2) + torch.eye(bs, device=dev)
    return [Qd] + [torch.from_numpy(v).to(dev) for v in (Qe, p, g, h)], \
        drifts


def scrambled_pattern(rng, n, w):
    """benchmarks/prof_general.py:49-58's pattern draws: a banded Q of
    width w under a random permutation, and two-entry G rows."""
    perm0 = rng.permutation(n)
    qi = [(i, j) for i in range(n) for j in range(n) if abs(i - j) <= w]
    Qi = np.array([(perm0[i], perm0[j]) for (i, j) in qi]).T
    gi = []
    for r in range(n):
        c = rng.randint(0, n - 1)
        gi.append((r, perm0[c]))
        gi.append((r, perm0[c + 1]))
    return Qi, np.array(gi).T


def make_scrambled(nbatch, n, w, seed=0):
    """benchmarks/prof_general.py:49-75's ``make_scrambled`` draws
    (float32 numpy, RandomState(seed) as its ``main`` seeds it), without
    its dense Q and G: h = G z0 + U(0, 1) + 0.2 is formed from the
    pattern (two nonzeros a row, so the sum is the dense one's). Returns
    (Qi, Qv, Gi, Gv, p, h)."""
    rng = np.random.RandomState(seed)
    Qi, Gi = scrambled_pattern(rng, n, w)
    Qv = np.zeros((nbatch, Qi.shape[1]), np.float32)
    look = {}
    for k, (i, j) in enumerate(zip(*Qi)):
        if i == j:
            Qv[:, k] = 2.0 * w + 1 + rng.rand(nbatch)
        elif (int(j), int(i)) in look:
            Qv[:, k] = Qv[:, look[(int(j), int(i))]]
        else:
            Qv[:, k] = rng.randn(nbatch) * 0.3
            look[(int(i), int(j))] = k
    Gv = rng.randn(nbatch, Gi.shape[1]).astype(np.float32)
    p = rng.randn(nbatch, n).astype(np.float32)
    z0 = rng.randn(nbatch, n)
    Gz = np.zeros((n, nbatch))
    np.add.at(Gz, Gi[0], (Gv * z0[:, Gi[1]]).T)
    h = (Gz.T + rng.rand(nbatch, n) + 0.2).astype(np.float32)
    return Qi, Qv, Gi, Gv, p, h


def general_stage_width(qt):
    """The block size the general planner picks for (c)'s pattern."""
    Qi, Gi = scrambled_pattern(np.random.RandomState(0), N9C, W9C)
    f = qt.SpQPFunction(Qi, (N9C, N9C), Gi, (N9C, N9C),
                        np.zeros((2, 0), int), (0, N9C), device="cpu")
    check(f.structure == "general", f"path 9c plans {f.structure}")
    return f._band[1]


def phase_9g(torch, qt, kernels, dev):
    """Path 9: the banded and general structured tiers at B = 4096, float32
    defaults unless said. Returns (launches, facts, data): the counts and
    readings of every case, and the tensors phase 10 times."""
    from qpth_tpu_torch.core import banded as band_core

    launches, facts = {}, {}
    cfg = qt.SolverConfig(check_Q_spd=False)
    # The float64 yardstick: the card's solve of the float32 data, loop
    # alone (eps = 1e-9, refine_steps=0), on N_F64_CARD lanes.
    cfg64 = qt.SolverConfig(check_Q_spd=False, eps=1e-9, refine_steps=0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chain64 = make_chain(torch, dev, B, NB9, BS9, NEQ9)
    chain = [v.float() for v in chain64]
    print(f"# phase 9g (path 9a): prof_banded chain draws B={B} nb={NB9} "
          f"bs={BS9} (n={NB9 * BS9}) neq={NEQ9} made in "
          f"{time.perf_counter() - t0:.1f} s")

    def forward(tag, fn, expect):
        """One forward with the counts set to 0 just before and read just
        after; kernel A's launches by dims; every output finite."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        with kernel_a_dims(kernels) as dims:
            t_ = time.perf_counter()
            sol = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t_) * 1e3
        fwd = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for name_ in ("z", "lam", "s", "nu"):
            check(bool(torch.isfinite(getattr(sol, name_)).all()),
                  f"{tag}: {name_} not finite")
        for k in expect:
            check(fwd.get(k, 0) > 0, f"{tag}: {k} did not launch")
        print(f"# {tag}: forward {wall:.1f} ms (first call), iterations "
              f"{int(sol.stats.iterations)}, launches {fwd}, kernel A by "
              f"dims {dims_summary(dims)}")
        return sol, fwd, dims_summary(dims)

    def backward(tag, fn, leaves, expect):
        """One forward+backward (counts as above); lanes with a non-finite
        gradient among the batched leaves at most B/200."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        z = fn()
        (z * z).sum().backward()
        torch.cuda.synchronize()
        fb = {k: v for k, v in kernels.LAUNCHES.items() if v}
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for v in leaves:
            check(v.grad is not None, f"{tag}: a leaf got no gradient")
            if v.shape[0] == B:
                bad |= ~torch.isfinite(v.grad.reshape(B, -1)).all(dim=1)
            else:
                check(bool(torch.isfinite(v.grad).all()),
                      f"{tag}: a shared gradient is not finite")
        n_bad = int(bad.sum())
        for k in expect:
            check(fb.get(k, 0) > 0, f"{tag}: {k} did not launch")
        print(f"# {tag}: forward+backward launches {fb}; lanes with a "
              f"non-finite gradient {n_bad} of {B}")
        check(n_bad <= LANES_OFF8, f"{tag}: {n_bad} lanes with a non-finite "
              "gradient")
        return fb, n_bad

    def against_f64(tag, z32, z64):
        err = lane_rel(z32[:z64.shape[0]], z64)
        med = float(err.median())
        print(f"# {tag}: f32 vs f64 (card) over {z64.shape[0]} lanes: median "
              f"relative z error {med:.3e}, p90 {float(err.quantile(0.9)):.3e}"
              f", max {float(err.max()):.3e}")
        check(med <= 2e-2, f"{tag}: f32 median relative error {med:.3e} > "
              "2e-2")
        return med

    # (a) the chain, neq = 0 and 32: solve_qp_banded_full, then
    # solve_qp_banded forward+backward; z against the card's float64 banded
    # solve, and that solve against the dense port on the densified problem
    # (nz = 512: past kernel A's fit, the hybrid path) in float64.
    for neq in (0, NEQ9):
        key = f"a_neq{neq}"
        tag = f"phase 9g (path 9a): banded f32 B={B} n={NB9 * BS9} neq={neq}"
        args = chain[:5] + (chain[5:] if neq else [])
        expect = ("factor_inv",) + (("inv_solve",) if neq else ())
        sol, fwd, dims = forward(tag, lambda: qt.solve_qp_banded_full(
            *args, config=cfg), expect)
        its_ = int(sol.stats.iterations)
        a64 = [v[:N_F64_CARD] if v.shape[0] == B else v
               for v in chain64[:5] + (chain64[5:] if neq else [])]
        with torch.no_grad():
            ref = qt.solve_qp_banded_full(*a64, config=cfg64)
        med = against_f64(tag, sol.z, ref.z)
        # The float64 banded solve against the dense port on 64 lanes.
        L_ = N_F64_CPU
        Qd, Qe = a64[0][:L_], a64[1][:L_]
        n_ = NB9 * BS9
        Qden = torch.zeros(L_, n_, n_, dtype=torch.float64, device=dev)
        for i in range(NB9):
            s_ = slice(i * BS9, (i + 1) * BS9)
            Qden[:, s_, s_] = Qd[:, i]
            if i + 1 < NB9:
                t_ = slice((i + 1) * BS9, (i + 2) * BS9)
                Qden[:, t_, s_] = Qe[:, i]
                Qden[:, s_, t_] = Qe[:, i].transpose(-1, -2)
        Gden = torch.diag_embed(a64[3][:L_])
        dense = [Qden, a64[2][:L_], Gden, a64[4][:L_]] + (
            [a64[5], a64[6][:L_]] if neq else [])
        with torch.no_grad():
            zb = qt.solve_qp_banded_full(
                *[v[:L_] if v.shape[0] == N_F64_CARD else v for v in a64],
                config=qt.SolverConfig(check_Q_spd=False)).z
            zd = qt.solve_qp_full(*dense, config=qt.SolverConfig(
                check_Q_spd=False)).z
        e_dense = rel(zb, zd)
        print(f"# {tag}: f64 banded vs the dense port (hybrid path, n = "
              f"{n_} past the fit) over {L_} lanes: z {e_dense:.3e}")
        check(e_dense <= 1e-8, f"{tag}: f64 banded vs dense {e_dense:.3e}")
        del Qden, Gden, dense, zb, zd, ref
        leaves = [v.clone().requires_grad_(True) for v in args]
        fb, n_bad = backward(tag, lambda: qt.solve_qp_banded(
            *leaves, config=cfg), leaves, expect)
        launches[key] = dict(forward=fwd, forward_backward=fb)
        facts[key] = dict(iterations=its_, z_err_median=med,
                          f64_vs_dense=e_dense, kernel_a_dims=dims,
                          nonfinite_grad_lanes=n_bad)
        del leaves, sol
    torch.cuda.empty_cache()

    # (b) receding-horizon MPC on the banded tier: cold and warm started
    # over the same drift sequence; iterations and wall per step.
    mpc, drifts = make_mpc_chain(torch, dev, B, N9B, BS9B, STEPS9B, DRIFT9B)
    Qd_b, Qe_b, p_b, g_b, h_b = mpc
    arms = {}
    for arm in ("cold", "warm"):
        pp, init, its_, ms_, zs = p_b, None, [], [], []
        kernels.reset_launches()
        for step in range(STEPS9B):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            sol = qt.solve_qp_banded_full(Qd_b, Qe_b, pp, g_b, h_b,
                                          config=cfg, init=init)
            its_.append(int(sol.stats.iterations))
            ms_.append((time.perf_counter() - t_) * 1e3)
            check(bool(torch.isfinite(sol.z).all()),
                  f"path 9b {arm} step {step}: z not finite")
            zs.append(sol.z)
            if arm == "warm":
                init = (sol.z, sol.s, sol.lam, None)
            pp = pp + drifts[step]
        arms[arm] = dict(iterations=its_, ms=ms_, z=zs,
                         launches={k: v for k, v in kernels.LAUNCHES.items()
                                   if v})
    diff = max(float(lane_rel(a, b_.double()).median())
               for a, b_ in zip(arms["warm"]["z"], arms["cold"]["z"]))
    for arm in ("cold", "warm"):
        print(f"# phase 9g (path 9b): MPC B={B} n={N9B} bs={BS9B}, {arm}: "
              f"iterations per step {arms[arm]['iterations']}, ms per step "
              + ", ".join(f"{v:.1f}" for v in arms[arm]["ms"])
              + f"; launches over the {STEPS9B} steps {arms[arm]['launches']}")
    print(f"# phase 9g (path 9b): warm against cold z, largest per-step "
          f"median relative difference {diff:.3e}")
    check(diff <= 2e-2, "path 9b: warm and cold solves part")
    check(arms["cold"]["launches"].get("factor_inv", 0) > 0,
          "path 9b: kernel A did not launch")
    launches["b"] = {arm: arms[arm]["launches"] for arm in arms}
    facts["b"] = dict(warm_cold_z_diff=diff, **{
        arm: dict(iterations=arms[arm]["iterations"], ms=arms[arm]["ms"])
        for arm in arms})
    del arms, mpc, drifts, sol
    torch.cuda.empty_cache()

    # (c) the general tier: the scrambled band through SpQPFunction
    # ("auto" picks general in float32 at n >= GENERAL_F32_MIN_N).
    t0 = time.perf_counter()
    Qi, Qv, Gi, Gv, p_c, h_c = make_scrambled(B, N9C, W9C)
    f = qt.SpQPFunction(Qi, (N9C, N9C), Gi, (N9C, N9C),
                        np.zeros((2, 0), int), (0, N9C), config=cfg)
    vals = [torch.from_numpy(v).to(dev) for v in (Qv, p_c, Gv, h_c)]
    empty = torch.zeros(B, 0, device=dev)
    check(f.structure == "general" and f._tier(vals[0]) == "general",
          f"path 9c: {f.structure} / {f._tier(vals[0])}")
    _, bs_c, nb_c, _ = f._band
    print(f"# phase 9g (path 9c): prof_general make_scrambled B={B} n={N9C} "
          f"w={W9C}: structure {f.structure}, bs={bs_c} nb={nb_c} after RCM; "
          f"draws {time.perf_counter() - t0:.1f} s")
    tag = f"phase 9g (path 9c): general f32 B={B} n={N9C}"
    sol_c, fwd, dims = forward(tag, lambda: f.solve_full(*vals, empty, empty),
                               ("factor_inv",))
    f64 = qt.SpQPFunction(Qi, (N9C, N9C), Gi, (N9C, N9C),
                          np.zeros((2, 0), int), (0, N9C), config=cfg64)
    with torch.no_grad():
        ref_c = f64.solve_full(*(v[:N_F64_CARD].double() for v in vals),
                               empty[:N_F64_CARD].double(),
                               empty[:N_F64_CARD].double())
    print(f"# {tag}: f64 yardstick score max "
          f"{float(ref_c.stats.best_resids.max()):.3e} median "
          f"{float(ref_c.stats.best_resids.median()):.3e}, iterations "
          f"{int(ref_c.stats.iterations)}")
    med_c = against_f64(tag, sol_c.z, ref_c.z)
    e_unref = lane_rel(sol_c.z[:N_F64_CARD], ref_c.z)
    leaves = [v.clone().requires_grad_(True) for v in vals]
    fb, n_bad = backward(tag, lambda: f(*leaves, empty, empty), leaves,
                         ("factor_inv",))
    launches["c"] = dict(forward=fwd, forward_backward=fb)
    facts["c"] = dict(iterations=int(sol_c.stats.iterations),
                      z_err_median=med_c, bs=bs_c, nb=nb_c,
                      kernel_a_dims=dims, nonfinite_grad_lanes=n_bad)
    del leaves

    # (e) refinement at eps = 1e-8 on (c) (the general tier's float32
    # plateau breaker): the refined median >= 100x and the p90 >= 10x below
    # the unrefined ones, as path 7 gates them; the steps are counted.
    n_fac = []
    fac_orig = band_core._Band.factor

    def fac_counted(self, d):
        n_fac.append(1)
        return fac_orig(self, d)

    cfg_e = qt.SolverConfig(check_Q_spd=False, eps=1e-8)
    band_core._Band.factor = fac_counted
    try:
        f_e = qt.SpQPFunction(Qi, (N9C, N9C), Gi, (N9C, N9C),
                              np.zeros((2, 0), int), (0, N9C), config=cfg_e)
        sol_e, fwd_e, _ = forward(f"{tag} eps=1e-8 (refined)",
                                  lambda: f_e.solve_full(*vals, empty, empty),
                                  ("factor_inv",))
        n_ref = len(n_fac)
        n_fac.clear()
        f_e0 = qt.SpQPFunction(
            Qi, (N9C, N9C), Gi, (N9C, N9C), np.zeros((2, 0), int), (0, N9C),
            config=dataclasses.replace(cfg_e, refine_steps=0))
        its_e0 = int(f_e0.solve_full(*vals, empty, empty).stats.iterations)
        steps_e = n_ref - len(n_fac)
    finally:
        band_core._Band.factor = fac_orig
    e_ref = lane_rel(sol_e.z[:N_F64_CARD], ref_c.z)
    q = {k: dict(median=float(e.median()), p90=float(e.quantile(0.9)),
                 max=float(e.max())) for k, e in (("refined", e_ref),
                                                  ("unrefined", e_unref))}
    print(f"# {tag} eps=1e-8: refinement steps {steps_e} (loop iterations "
          f"{int(sol_e.stats.iterations)}, {its_e0} without refinement); "
          f"score max {float(sol_e.stats.best_resids.max()):.3e}; z error "
          f"over {N_F64_CARD} lanes: refined median "
          f"{q['refined']['median']:.3e} p90 {q['refined']['p90']:.3e} max "
          f"{q['refined']['max']:.3e}, unrefined median "
          f"{q['unrefined']['median']:.3e} p90 {q['unrefined']['p90']:.3e}")
    check(q["unrefined"]["median"] >= 100.0 * q["refined"]["median"],
          "path 9e: refinement gained less than 100x on the median")
    check(q["unrefined"]["p90"] >= 10.0 * q["refined"]["p90"],
          "path 9e: refinement gained less than 10x on the p90")
    launches["e"] = dict(forward=fwd_e)
    facts["e"] = dict(refinement_steps=steps_e, z_err=q,
                      iterations=int(sol_e.stats.iterations))
    del sol_e, f_e, f_e0

    # (c') the box pattern (diagonal Q, G = [I; -I]) through SpQPFunction:
    # it dispatches to the banded tier.
    r_ = np.random.RandomState(1)
    n_ = N9_BOX
    Qi_b = np.stack([np.arange(n_), np.arange(n_)])
    Gi_b = np.stack([np.arange(2 * n_), np.tile(np.arange(n_), 2)])
    u = r_.rand(B, n_) + 0.5
    lo = -(r_.rand(B, n_) + 0.5)
    box = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
        1.0 + r_.rand(B, n_), r_.randn(B, n_),
        np.concatenate([np.ones((B, n_)), -np.ones((B, n_))], 1),
        np.concatenate([u, -lo], 1))]
    f_b = qt.SpQPFunction(Qi_b, (n_, n_), Gi_b, (2 * n_, n_),
                          np.zeros((2, 0), int), (0, n_), config=cfg)
    check(f_b.structure == "banded", f"path 9c': {f_b.structure}")
    tag = f"phase 9g (path 9c'): box pattern f32 B={B} n={n_}"
    sol_b, fwd, _ = forward(tag, lambda: f_b.solve_full(*box, empty, empty),
                            ("factor_inv",))
    zb = sol_b.z.double().cpu().numpy()
    viol = float(max((zb - u).max(), (lo - zb).max()))
    print(f"# {tag}: bs={f_b._band[1]} nb={f_b._band[2]}; largest box "
          f"violation {viol:.3e}")
    check(viol <= 1e-4, f"{tag}: the box is violated by {viol:.3e}")
    leaves = [v.clone().requires_grad_(True) for v in box]
    fb, n_bad = backward(tag, lambda: f_b(*leaves, empty, empty), leaves,
                         ("factor_inv",))
    launches["c_box"] = dict(forward=fwd, forward_backward=fb)
    facts["c_box"] = dict(iterations=int(sol_b.stats.iterations),
                          box_violation=viol, nonfinite_grad_lanes=n_bad)
    del leaves, box, sol_b

    # (d) float64, card against CPU on N_F64_CPU lanes of (a, neq = 32)
    # and of (c): z and nu to 1e-8, gradients to 1e-7, equal iterations.
    L_ = N_F64_CPU
    a_card = [v[:L_] if v.shape[0] == B else v for v in chain64]
    c_card = [v[:L_].double() for v in vals]
    f_cpu = qt.SpQPFunction(Qi, (N9C, N9C), Gi, (N9C, N9C),
                            np.zeros((2, 0), int), (0, N9C), config=cfg,
                            device="cpu")
    e0 = torch.zeros(L_, 0, dtype=torch.float64)
    for key, full, diff_fn, card_args in (
            ("d_chain", lambda a, d: qt.solve_qp_banded_full(
                *a, config=cfg, device=d),
             lambda a, d: qt.solve_qp_banded(*a, config=cfg, device=d),
             a_card),
            ("d_general", lambda a, d: (f if d == dev else f_cpu).solve_full(
                *a, e0.to(d), e0.to(d)),
             lambda a, d: (f if d == dev else f_cpu)(*a, e0.to(d), e0.to(d)),
             c_card)):
        got = {}
        for device in (dev, "cpu"):
            args = [v.to(device) for v in card_args]
            kernels.reset_launches()
            sol = full(args, device)
            its_ = int(sol.stats.iterations)
            leaves = [v.clone().requires_grad_(True) for v in args]
            z = diff_fn(leaves, device)
            (z * z).sum().backward()
            got[str(device)] = (sol, [v.grad for v in leaves], its_,
                                dict(kernels.LAUNCHES))
        (sc, gc, ic, lc), (sh, gh, ih, lh) = got[str(dev)], got["cpu"]
        ez = rel(sc.z.cpu(), sh.z)
        enu = rel(sc.nu.cpu(), sh.nu) if sh.nu.numel() else 0.0
        eg = [rel(a.cpu(), c) for a, c in zip(gc, gh)]
        print(f"# phase 9g (path 9d, {key}) f64 card vs CPU over {L_} lanes: "
              f"z {ez:.3e}, nu {enu:.3e}, gradients "
              + ", ".join(f"{e:.3e}" for e in eg)
              + f"; iterations {ic} / {ih}; score max card "
              f"{float(sc.stats.best_resids.max()):.3e} CPU "
              f"{float(sh.stats.best_resids.max()):.3e}; card launches "
              f"{ {k: v for k, v in lc.items() if v} }")
        check(ez <= 1e-8 and enu <= 1e-8, f"path 9d {key}: z / nu")
        check(all(e <= 1e-7 for e in eg), f"path 9d {key}: gradients")
        check(ic == ih, f"path 9d {key}: iterations differ")
        check(lc.get("factor_inv", 0) > 0 and not any(lh.values()),
              f"path 9d {key}: kernel A on the card, none on the CPU")
        facts[key] = dict(z=ez, nu=enu, grads=eg, iterations=ic)
    del a_card, c_card, chain64
    torch.cuda.empty_cache()
    return launches, facts, dict(a=chain, c=(f, vals, empty))


def path9_timings(torch, qt, kernels, dev, data, host_ms, report, spread,
                  cuda_ms, device_ms, bound, elt):
    """Phase 10 for path 9: forward and forward+backward ms of (a) at neq
    = 0 and 32 and of (c) (median of 5); kernel A at the stage width m =
    32 (B = 4096, no shift, as every stage runs it) against its bound, its
    plain version and the library; and the device split of one (a)
    forward+backward (neq = 32) by kernel class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = qt.SolverConfig(check_Q_spd=False)
    chain = data["a"]
    f, vals, empty = data["c"]

    def grads(fn, args):
        leaves = [v.clone().requires_grad_(True) for v in args]
        z = fn(leaves)
        (z * z).sum().backward()

    def banded(a):
        return qt.solve_qp_banded(*a, config=cfg)

    out = {}
    for key, args in (("a_neq0", chain[:5]), (f"a_neq{NEQ9}", chain)):
        ms_f = report(f"path9 ({key}) forward", host_ms(
            lambda: qt.solve_qp_banded_full(*args, config=cfg)))
        lo_f, hi_f = spread["last"]
        ms_b = report(f"path9 ({key}) forward+backward", host_ms(
            lambda: grads(banded, args)))
        lo_b, hi_b = spread["last"]
        out[key] = dict(forward_ms=ms_f, forward_min=lo_f, forward_max=hi_f,
                        forward_backward_ms=ms_b, forward_backward_min=lo_b,
                        forward_backward_max=hi_b)
    ms_f = report("path9 (c) general forward", host_ms(
        lambda: f.solve_full(*vals, empty, empty)))
    lo_f, hi_f = spread["last"]
    ms_b = report("path9 (c) general forward+backward", host_ms(
        lambda: grads(lambda a: f(*a, empty, empty), vals)))
    lo_b, hi_b = spread["last"]
    out["c"] = dict(forward_ms=ms_f, forward_min=lo_f, forward_max=hi_f,
                    forward_backward_ms=ms_b, forward_backward_min=lo_b,
                    forward_backward_max=hi_b)

    # Kernel A at the stage width: R's triangle and dinv in, Linv out.
    m9 = BS9
    g_ = torch.Generator(device=dev).manual_seed(96)
    Lr = torch.rand(B, m9, m9, generator=g_, device=dev, dtype=torch.float64)
    C9 = (Lr @ Lr.transpose(1, 2) / m9 + torch.eye(
        m9, device=dev, dtype=torch.float64)).float().contiguous()
    zero9 = torch.zeros(B, m9, device=dev)
    eye9 = torch.eye(m9, device=dev).expand(B, m9, m9)

    def kernel9():
        return kernels.factor_inv(C9, zero9)

    def library9():
        L9, _ = torch.linalg.cholesky_ex(C9)
        return torch.linalg.solve_triangular(L9, eye9, upper=False)

    nbytes9 = B * (m9 * (m9 + 1) // 2 + m9 + m9 * m9) * elt
    b_ms, b_by = bound(nbytes9, B * (2.0 / 3.0) * m9 ** 3)
    stage = dict(
        ms=cuda_ms(kernel9),
        plain_ms=cuda_ms(lambda: kernels.factor_inv_plain(C9, zero9)),
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes9,
        library_ms=cuda_ms(library9), device_ms=device_ms(kernel9),
        library_device_ms=device_ms(library9), dtype="float32", m=m9,
        library_call="torch.linalg.cholesky_ex + "
                     "torch.linalg.solve_triangular (two calls)")
    d_, ld_ = stage["device_ms"], stage["library_device_ms"]
    print(f"# phase 10: factor_inv at path 9's stage width (B={B} m={m9} "
          f"float32, no shift): {stage['ms']:.3f} ms, device "
          + (f"{d_:.4f}" if d_ is not None else "not measured")
          + f" (plain {stage['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}, {nbytes9 / 1e6:.1f} MB, library {stage['library_ms']:.3f}"
          " ms, device "
          + (f"{ld_:.4f}" if ld_ is not None else "not measured") + ")")
    out["kernel_a_stage"] = stage
    del C9, zero9, eye9, Lr

    # Device split of one (a) forward+backward with the equality rows.
    grads(banded, chain)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads(banded, chain)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = [(e.self_device_time_total / 1e3, e.count, e.key)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in by)

    def cls(name):
        n_ = name.lower()
        if "factor_inv" in n_:
            return "kernel A"
        if "inv_solve" in n_:
            return "kernel 5"
        if any(s in n_ for s in ("gemm", "gemv", "cutlass", "xmma",
                                 "sm90_", "dot_kernel", "splitk")):
            return "GEMM/GEMV (cuBLAS)"
        if any(s in n_ for s in ("index", "scatter", "gather")):
            return "index, scatter, gather"
        return "elementwise, reductions, copies"

    split = {}
    for t, c, k in by:
        s_ = split.setdefault(cls(k), [0.0, 0])
        s_[0] += t
        s_[1] += c
    out["trace"] = dict(
        wall_ms=wall, device_busy_ms=busy or None,
        device_idle_share=(1 - busy / wall) if busy else None,
        launches=sum(c for _, c, _ in by),
        split={k: dict(ms=v[0], launches=v[1]) for k, v in split.items()},
        top=[dict(ms=t, count=c, name=k[:80])
             for t, c, k in sorted(by, reverse=True)[:8]])
    if busy:
        print(f"# phase 10: trace of one path 9 (a, neq={NEQ9}) forward+"
              f"backward: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
              f"idle share {1 - busy / wall:.3f}, "
              f"{out['trace']['launches']} device launches; by class: "
              + ", ".join(f"{k} {v[0]:.2f} ms x{v[1]}" for k, v in sorted(
                  split.items(), key=lambda kv: -kv[1][0])))
        for t, c, k in sorted(by, reverse=True)[:8]:
            print(f"#   {t:9.3f} ms  x{c:<5d} {k[:90]}")
    else:
        print("# phase 10: trace (path 9 a): the profiler saw no device "
              "time (not measured)")
    return out


def path9_examples(torch, kernels):
    """The two example scripts of path 9 for 5 steps each on the card:
    ``examples/torch_mpc.py`` in both formulations and
    ``examples/torch_graph_qp.py`` on the general tier."""
    import importlib.util

    out = {}
    for key, name, argv in (
            ("mpc_banded", "torch_mpc", ["--formulation", "banded"]),
            ("mpc_condensed", "torch_mpc", ["--formulation", "condensed"]),
            ("graph_general", "torch_graph_qp", ["--structure", "general"])):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv + ["--steps", "5", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lk = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if name == "torch_mpc":
            vals = [r["error"] for r in res]
            its = [r["iterations"] for r in res]
            print(f"# phase 9g: examples/{name}.py {' '.join(argv)}, 5 steps "
                  f"on the card ({wall:.1f} s): mean |pos - target| "
                  + ", ".join(f"{v:.4f}" for v in vals)
                  + f"; iterations {its}; launches {lk}")
            out[key] = dict(errors=vals, iterations=its, launches=lk,
                            seconds=wall)
        else:
            vals, base, tier = res
            print(f"# phase 9g: examples/{name}.py {' '.join(argv)}, 5 steps "
                  f"on the card ({wall:.1f} s), tier {tier}: losses "
                  + ", ".join(f"{v:.5f}" for v in vals)
                  + f" (noisy input {base:.5f}); launches {lk}")
            check(tier == "general", f"{name}: ran the {tier} tier")
            out[key] = dict(losses=vals, noisy_mse=base, tier=tier,
                            launches=lk, seconds=wall)
        check(len(vals) == 5 and all(np.isfinite(vals)),
              f"{name} {argv}: non-finite result")
        check(lk.get("factor_inv", 0) > 0, f"{name} {argv}: kernel A did "
              "not launch")
    return out


# ---- path 10: multi-process solves, the native oracle, profiling ----
WORLD10 = 2                   # gloo ranks sharing the one card
N10_F64 = 64                  # float64 lanes per rank (the f64 check)
M10_TP, B10_TP = 2048, 2      # factor_solve_hybrid_tp's T
N10_TP = 2048                 # solve_qp_tp (tests/test_intra_tp.py:130-149)
N10_EQ, NEQ10 = 512, 32       # solve_qp_tp with equality rows (:173-185)
N10_ORACLE = 64               # CPU_ORACLE lanes, native against numpy
P10_TIMEOUT = 420             # seconds for both ranks, start-up included


def make_tp_matrix(m, nbatch, seed=3):
    """A batch of SPD T = L L^T (L lower, 0.1 randn + 3 I), v and dinv
    (tests/test_intra_tp.py::test_tp_hybrid_factor_m1024's draw)."""
    npr = np.random.RandomState(seed)
    L = np.tril(npr.randn(nbatch, m, m) * 0.1) + 3 * np.eye(m)
    return (np.matmul(L, L.transpose(0, 2, 1)), npr.randn(nbatch, m),
            0.5 + npr.rand(nbatch, m))


def make_huge_qp(n, neq=0):
    """One QP (B = 1) of tests/test_intra_tp.py's end-to-end draws: float32
    gram + I Q, G (and A) scaled by 1 / sqrt(n); n = m = 2048 without
    equality rows (seed 11, :130-149), 512 with (seed 5, :173-185)."""
    f32 = np.float32
    if neq == 0:
        npr = np.random.RandomState(11)
        W = npr.randn(n, n).astype(f32) * (1.0 / np.sqrt(n))
        Q = W @ W.T + 1.0 * np.eye(n, dtype=f32)
        G = npr.randn(n, n).astype(f32) / np.sqrt(n)
        z0 = npr.randn(n).astype(f32)
        h = G @ z0 + npr.rand(n).astype(f32)
        p = npr.randn(n).astype(f32)
        return [v.astype(f32)[None] for v in (Q, p, G, h)] + [None, None]
    npr = np.random.RandomState(5)
    W = npr.randn(n, n).astype(f32) / np.sqrt(n)
    Q = W @ W.T + np.eye(n, dtype=f32)
    G = npr.randn(n, n).astype(f32) / np.sqrt(n)
    A = npr.randn(neq, n).astype(f32) / np.sqrt(n)
    z0 = npr.randn(n).astype(f32)
    h = G @ z0 + npr.rand(n).astype(f32) + 0.1
    b = A @ z0
    p = npr.randn(n).astype(f32)
    return [v.astype(f32)[None] for v in (Q, p, G, h, A, b)]


def optnet_problem():
    """Phase 5's OptNet pattern: shared Q and G, batched p and h."""
    Qs, _, Gs, _ = make_problem(1, NZ, NINEQ, seed=1)
    npr = np.random.RandomState(2)
    ps = npr.randn(B, NZ)
    hs = (np.einsum("mn,bn->bm", Gs[0], npr.randn(B, NZ))
          + npr.rand(B, NINEQ))
    return Qs[0], ps, Gs[0], hs


def path10_rank(rank, world, init_file, out):
    """One rank of path 10 (``chip_smoke.py --path10-rank ...``): joins a
    gloo group of ``world`` ranks on the one card through ``init_file``,
    drives (a) batch sharding and (b) tensor parallelism, and writes its
    results to ``out`` (``.npz`` and ``.json``). Any failure exits
    nonzero."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    check(torch.cuda.is_available(), f"path 10 rank {rank}: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=P10_TIMEOUT))
    sys.path.insert(0, ROOT)
    import qpth_tpu_torch as qt
    from qpth_tpu_torch.ops.cuda import kernels
    from qpth_tpu_torch.parallel import (factor_solve_hybrid_tp,
                                         local_batch_slice, solve_qp_sharded,
                                         solve_qp_tp)
    from qpth_tpu_torch.parallel.intra import tp_band

    group = dist.group.WORLD
    arrays, facts = {}, {}
    sl = local_batch_slice(B, group)

    def on(arrs, dtype, lanes=sl):
        return [None if v is None else torch.tensor(
            v[lanes] if v.ndim in (2, 3) and v.shape[0] == B else v,
            dtype=dtype, device=dev) for v in arrs]

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    exit_tests = []
    orig = dist.all_reduce

    def counting_all_reduce(t, *a, **k):
        exit_tests.append(t.numel())
        return orig(t, *a, **k)

    # (a) batch sharding, the bench workload: B / world lanes per rank.
    bench = make_problem(B, NZ, NINEQ, seed=0)
    cfg = qt.SolverConfig(check_Q_spd=False, process_group=group)
    f32 = on(bench, torch.float32)
    kernels.reset_launches()
    sol = qt.solve_qp_full(*f32, config=cfg)
    torch.cuda.synchronize()
    facts["a_forward_launches"] = dict(kernels.LAUNCHES)
    facts["a_forward_iterations"] = int(sol.stats.iterations)
    arrays["a_z"] = sol.z.cpu().numpy()

    def fwd_bwd(arrs, config):
        ts = [t.clone().requires_grad_(True) for t in arrs]
        z = solve_qp_sharded(*ts, group=group, config=config)
        (z * z).sum().backward()
        return z, [t.grad for t in ts]

    kernels.reset_launches()
    dist.all_reduce = counting_all_reduce
    try:
        z_fb, g_fb = fwd_bwd(f32, cfg)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = orig
    facts["a_fb_launches"] = dict(kernels.LAUNCHES)
    # The loop's packed exit test is the all_reduce of 3 or 4 scalars.
    facts["a_fb_iterations"] = sum(1 for n in exit_tests if n in (3, 4))
    facts["a_fb_all_reduces"] = len(exit_tests)
    arrays["a_fb_z"] = z_fb.detach().cpu().numpy()
    arrays["a_fb_dp"] = g_fb[1].cpu().numpy()
    facts["a_forward_ms"] = timed(lambda: qt.solve_qp_full(*f32, config=cfg))
    facts["a_fb_ms"] = timed(lambda: fwd_bwd(f32, cfg))
    # float64: N10_F64 lanes per rank, the float64 default.
    lanes64 = slice(rank * N10_F64, (rank + 1) * N10_F64)
    cfg64 = qt.SolverConfig(check_Q_spd=False, process_group=group)
    sol64 = qt.solve_qp_full(*on(bench, torch.float64, lanes64),
                             config=cfg64)
    arrays["a_f64_z"] = sol64.z.cpu().numpy()
    facts["a_f64_iterations"] = int(sol64.stats.iterations)
    # The OptNet pattern in float64: the gradients of the shared Q and G,
    # summed over the ranks.
    opt = on(optnet_problem(), torch.float64)
    _, g_opt = fwd_bwd(opt, cfg64)
    arrays["a_opt_dQ"] = g_opt[0].cpu().numpy()
    arrays["a_opt_dG"] = g_opt[2].cpu().numpy()
    arrays["a_opt_dp"] = g_opt[1].cpu().numpy()
    del f32, sol, z_fb, g_fb, opt, g_opt

    # (b) tensor parallelism: T's rows split over the ranks.
    T, v, dinv = make_tp_matrix(M10_TP, B10_TP)
    r0, r1 = tp_band(M10_TP, group)
    for dt in ("float32", "float64"):
        tt = lambda a: torch.tensor(a, dtype=getattr(torch, dt), device=dev)
        T_rows, v_, d_ = tt(T[:, r0:r1]), tt(v), tt(dinv)
        kernels.reset_launches()
        fac, x = factor_solve_hybrid_tp(T_rows, v_, group=group, dinv=d_)
        torch.cuda.synchronize()
        facts[f"b_fs_{dt}_launches"] = dict(kernels.LAUNCHES)
        facts[f"b_fs_{dt}_bytes"] = fac.nbytes()
        arrays[f"b_fs_{dt}_x"] = x.cpu().numpy()
        facts[f"b_fs_{dt}_ms"] = timed(lambda: factor_solve_hybrid_tp(
            T_rows, v_, group=group, dinv=d_))
        del fac, x, T_rows
    del T
    for tag, n, neq, its in (("tp", N10_TP, 0, 8), ("tp_eq", N10_EQ, NEQ10,
                                                    6)):
        args = [None if a is None else torch.tensor(a, device=dev)
                for a in make_huge_qp(n, neq)]
        tcfg = qt.SolverConfig(check_Q_spd=False, verbose=-1, max_iter=its)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        sol = solve_qp_tp(*args, group=group, config=tcfg)
        torch.cuda.synchronize()
        facts[f"b_{tag}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        facts[f"b_{tag}_launches"] = dict(kernels.LAUNCHES)
        facts[f"b_{tag}_iterations"] = int(sol.stats.iterations)
        arrays[f"b_{tag}_z"] = sol.z.cpu().numpy()
        facts[f"b_{tag}_ms"] = timed(lambda: solve_qp_tp(
            *args, group=group, config=tcfg), reps=1)
        del args, sol
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(facts, f)
    dist.destroy_process_group()
    print(f"rank {rank}: done")


def phase_10x(torch, qt, kernels, dev, smi, fwd_ms, fb_ms, rows):
    """Path 10: (c) the native oracle and (d) profiling in this process,
    then (a) batch sharding and (b) tensor parallelism on WORLD10 gloo ranks
    that share the card (``path10_rank``), each held against this
    process's single-process solves. Returns the path's facts."""
    from qpth_tpu_torch import native, profiling
    from qpth_tpu_torch.ops import hybrid
    from qpth_tpu_torch.solvers.oracle import solve_qp_batch_np

    t_path = time.perf_counter()
    facts = {"card": smi}
    bench = make_problem(B, NZ, NINEQ, seed=0)
    cfg = qt.SolverConfig(check_Q_spd=False)

    def tensors(arrs, dtype, lanes=None):
        return [torch.tensor(v[lanes] if lanes is not None
                             and v.shape[0] == B else v, dtype=dtype,
                             device=dev) for v in arrs]

    # (c) the native oracle: it must build here; CPU_ORACLE on N10_ORACLE
    # bench lanes against the numpy copy.
    check(native.is_available(),
          f"path 10 (c): the native oracle did not build: "
          f"{native.build_error()}")
    lanes = slice(0, N10_ORACLE)
    o64 = tensors(bench, torch.float64, lanes)
    ocfg = qt.SolverConfig(solver=qt.QPSolvers.CPU_ORACLE,
                           check_Q_spd=False)
    qt.solve_qp_full(*tensors(bench, torch.float64, slice(0, 2)),
                     config=ocfg)
    t0 = time.perf_counter()
    sol_o = qt.solve_qp_full(*o64, config=ocfg)
    torch.cuda.synchronize()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_np = solve_qp_batch_np(*(v[lanes] for v in bench))[0]
    t_numpy = time.perf_counter() - t0
    e_o = float(np.abs(sol_o.z.cpu().numpy() - x_np).max()
                / np.abs(x_np).max())
    print(f"# path 10 (c): CPU_ORACLE on {N10_ORACLE} bench lanes through "
          f"the native oracle ({' '.join(native.built_with[1])}): "
          f"{t_native / N10_ORACLE:.4f} host s per lane; the numpy copy "
          f"{t_numpy / N10_ORACLE:.4f} s per lane; z rel diff {e_o:.3e} "
          f"[{smi}]")
    check(e_o <= 1e-9, f"path 10 (c): native vs numpy oracle {e_o:.3e}")
    facts["c_native_s_per_lane"] = t_native / N10_ORACLE
    facts["c_numpy_s_per_lane"] = t_numpy / N10_ORACLE
    facts["c_rel_diff"] = e_o

    # (d) profiling: a trace of one bench forward, and solve_timings.
    f32 = tensors(bench, torch.float32)
    tdir = os.path.join(ROOT, "build", "path10_trace")
    if os.path.isdir(tdir):
        for f_ in os.listdir(tdir):
            os.unlink(os.path.join(tdir, f_))
    with profiling.trace(tdir):
        qt.solve_qp_full(*f32, config=cfg)
    tfiles = [os.path.join(tdir, f_) for f_ in os.listdir(tdir)]
    tbytes = sum(os.path.getsize(f_) for f_ in tfiles)
    check(len(tfiles) == 1 and tbytes > 0, "path 10 (d): no trace written")
    with open(tfiles[0]) as f_:
        ev = json.load(f_)["traceEvents"]
    check(len(ev) > 0, "path 10 (d): the trace holds no event")
    n_dev = sum(1 for e in ev if e.get("cat") == "kernel")
    first_s, best_s = profiling.solve_timings(
        lambda *a: qt.solve_qp_full(*a, config=cfg), *f32, trials=5)
    print(f"# path 10 (d): profiling.trace of one bench forward: "
          f"{tbytes} bytes, {len(ev)} events, {n_dev} device kernel events;"
          f" solve_timings: first {first_s * 1e3:.2f} ms, best of 5 "
          f"{best_s * 1e3:.2f} ms (phase 10's median {fwd_ms:.2f} ms) "
          f"[{smi}]")
    facts.update(d_trace_bytes=tbytes, d_trace_kernel_events=n_dev,
                 d_first_ms=first_s * 1e3, d_best_ms=best_s * 1e3)

    # Single-process yardsticks: the bench forward and forward+backward in
    # float32, and float64 z and dp (of sum(z^2), so a lane's dp is its
    # own) on N_F64_CARD lanes, half from each rank's shard.
    sol1 = qt.solve_qp_full(*f32, config=cfg)
    its1 = int(sol1.stats.iterations)
    ts1 = [t.clone().requires_grad_(True) for t in f32]
    z1 = qt.solve_qp(*ts1, config=cfg)
    (z1 * z1).sum().backward()
    dp1 = ts1[1].grad
    per = B // WORLD10
    yl = np.concatenate([np.arange(r * per, r * per + N_F64_CARD // WORLD10)
                         for r in range(WORLD10)])
    ts64 = [t.requires_grad_(True)
            for t in tensors(bench, torch.float64, yl)]
    z64_ = qt.solve_qp(*ts64, config=qt.SolverConfig(
        solve_method="inverse", resid_every=7, check_Q_spd=False))
    (z64_ * z64_).sum().backward()
    ref64, dp64 = z64_.detach(), ts64[1].grad
    del ts1, z1, ts64, z64_

    def med(e):
        return float(torch.nan_to_num(e, nan=float("inf")).median())

    def acc(z, want=None):
        """The median per-lane relative error on the yardstick's lanes."""
        want = ref64 if want is None else want
        return med(lane_rel(torch.as_tensor(z, device=dev)[yl], want))

    acc1, gacc1 = acc(sol1.z), acc(dp1, dp64)
    del sol1
    opt64 = tensors(optnet_problem(), torch.float64)
    opt64 = [t.requires_grad_(True) for t in opt64]
    z_o = qt.solve_qp(*opt64, config=cfg)
    (z_o * z_o).sum().backward()
    want_opt = [t.grad for t in opt64]
    want_64 = qt.solve_qp_full(*tensors(bench, torch.float64,
                                        slice(0, WORLD10 * N10_F64)),
                               config=cfg).z
    want_fs, base_fs = {}, {}
    for dt in ("float32", "float64"):
        T, v, dinv = (torch.tensor(a, dtype=getattr(torch, dt), device=dev)
                      for a in make_tp_matrix(M10_TP, B10_TP))
        fac, want_fs[dt] = hybrid.factor_solve_hybrid(T, v, dinv=dinv)
        base_fs[dt] = sum(t.numel() * t.element_size() for t in
                          fac.Gs + [P for P in fac.Ps if P is not None])
        del T, fac
    want_tp = {}
    for tag, n, neq, its in (("tp", N10_TP, 0, 8), ("tp_eq", N10_EQ, NEQ10,
                                                    6)):
        args = [None if a is None else torch.tensor(a, device=dev)
                for a in make_huge_qp(n, neq)]
        tcfg = qt.SolverConfig(check_Q_spd=False, verbose=-1, max_iter=its,
                               use_pallas="hybrid_xla")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        s_ = qt.solve_qp_full(*args, config=tcfg)
        torch.cuda.synchronize()
        want_tp[tag] = (s_.z, int(s_.stats.iterations),
                        torch.cuda.max_memory_allocated() - base,
                        dict(kernels.LAUNCHES))
        t0 = time.perf_counter()
        qt.solve_qp_full(*args, config=tcfg)
        torch.cuda.synchronize()
        want_tp[tag] += ((time.perf_counter() - t0) * 1e3,)
        del args, s_
    torch.cuda.empty_cache()

    # The ranks: started after phase 1 built every library, so no two
    # processes run nvcc into the same file.
    wdir = os.path.join(ROOT, "build", "path10")
    os.makedirs(wdir, exist_ok=True)
    init_file = os.path.join(wdir, "rendezvous")
    if os.path.exists(init_file):
        os.unlink(init_file)
    outs = [os.path.join(wdir, f"rank{r}") for r in range(WORLD10)]
    logs = [open(o + ".log", "w") for o in outs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--path10-rank", str(r),
         str(WORLD10), init_file, outs[r]], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=ROOT) for r in range(WORLD10)]
    try:
        while any(p_.poll() is None for p_ in procs):
            if (any(p_.poll() not in (None, 0) for p_ in procs)
                    or time.perf_counter() - t0 > P10_TIMEOUT):
                break
            time.sleep(0.2)
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
            p_.wait()
        for f_ in logs:
            f_.close()
    wall = time.perf_counter() - t0
    for r, p_ in enumerate(procs):
        if p_.returncode != 0:
            with open(outs[r] + ".log") as f_:
                print(f_.read()[-6000:], file=sys.stderr)
            fail(f"path 10: rank {r} exited {p_.returncode}")
    res = []
    for o in outs:
        with open(o + ".json") as f_:
            rf = json.load(f_)
        res.append((dict(np.load(o + ".npz")), rf))
    print(f"# path 10: {WORLD10} gloo ranks on the one card ran in "
          f"{wall:.1f} s, start-up included [{smi}]")

    # (a) against the single-process solve.
    z_a = np.concatenate([a["a_z"] for a, _ in res])
    z_fb = np.concatenate([a["a_fb_z"] for a, _ in res])
    dp_fb = np.concatenate([a["a_fb_dp"] for a, _ in res])
    acc_a, acc_fb, gacc_fb = acc(z_a), acc(z_fb), acc(dp_fb, dp64)
    for r, (_, rf) in enumerate(res):
        print(f"# path 10 (a) rank {r}: B={B // WORLD10} of {B} lanes: "
              f"forward {rf['a_forward_ms']:.2f} ms, iterations "
              f"{rf['a_forward_iterations']}, launches "
              f"{ {k: v for k, v in rf['a_forward_launches'].items() if v} };"
              f" forward+backward {rf['a_fb_ms']:.2f} ms, iterations "
              f"{rf['a_fb_iterations']}, all_reduces "
              f"{rf['a_fb_all_reduces']}, launches "
              f"{ {k: v for k, v in rf['a_fb_launches'].items() if v} } "
              f"[{smi}]")
        check(rf["a_forward_iterations"] == its1
              and rf["a_fb_iterations"] == its1,
              f"path 10 (a) rank {r}: iterations differ from the "
              f"single-process solve's {its1}")
        check(rf["a_forward_launches"].get("ipm_step_xfree", 0) > 0,
              f"path 10 (a) rank {r}: the fused step did not run")
    print(f"# path 10 (a): single process B={B}: forward {fwd_ms:.2f} ms, "
          f"forward+backward {fb_ms:.2f} ms (phase 10), iterations {its1}."
          " Two ranks share one card here: their walls are no scaling "
          "number")
    print(f"# path 10 (a): median relative error against f64 over "
          f"{N_F64_CARD} lanes, {N_F64_CARD // WORLD10} of each rank: z "
          f"sharded forward {acc_a:.3e}, forward+backward {acc_fb:.3e}, "
          f"single process {acc1:.3e}; dp sharded {gacc_fb:.3e}, single "
          f"process {gacc1:.3e}")
    check(acc_a <= 1.1 * acc1 and acc_fb <= 1.1 * acc1
          and gacc_fb <= 1.1 * gacc1,
          "path 10 (a): sharded accuracy not within 10% of the "
          "single-process solve's")
    # Each rank's lanes against the single-process solve of the same lanes:
    # the sharded result may differ from it by less than the float32
    # result's own error (the medians above).
    z1_all = qt.solve_qp_full(*f32, config=cfg).z
    for r, (a, _) in enumerate(res):
        lanes_r = slice(r * per, (r + 1) * per)
        d_z = lane_rel(torch.tensor(a["a_fb_z"], device=dev),
                       z1_all[lanes_r].double())
        d_p = lane_rel(torch.tensor(a["a_fb_dp"], device=dev),
                       dp1[lanes_r].double())
        bad = [int((~torch.isfinite(torch.as_tensor(x)).all(1)).sum())
               for x in (a["a_fb_dp"], dp1[lanes_r].cpu())]
        print(f"# path 10 (a) rank {r}: forward+backward against the "
              f"single process on its {per} lanes: z median "
              f"{med(d_z):.3e} max {float(d_z.max()):.3e}, dp median "
              f"{med(d_p):.3e}; lanes with a non-finite dp {bad[0]} "
              f"(single process {bad[1]})")
        check(med(d_z) <= acc1 and med(d_p) <= gacc1,
              f"path 10 (a) rank {r}: sharded forward+backward parts from "
              "the single-process solve by more than its own error")
    del z1_all, dp1
    z64 = np.concatenate([a["a_f64_z"] for a, _ in res])
    e64 = rel(torch.tensor(z64), want_64.cpu())
    e_q = max(rel(torch.tensor(a["a_opt_dQ"]), want_opt[0].cpu())
              for a, _ in res)
    e_g = max(rel(torch.tensor(a["a_opt_dG"]), want_opt[2].cpu())
              for a, _ in res)
    e_p = rel(torch.tensor(np.concatenate([a["a_opt_dp"] for a, _ in res])),
              want_opt[1].cpu())
    print(f"# path 10 (a): float64, {N10_F64} lanes per rank against the "
          f"single-process solve: z rel {e64:.3e}; OptNet pattern float64 "
          f"B={B}: summed dQ rel {e_q:.3e}, dG {e_g:.3e}, per-lane dp "
          f"{e_p:.3e}")
    check(e64 <= 1e-10, f"path 10 (a): float64 sharded z {e64:.3e}")
    check(max(e_q, e_g, e_p) <= 1e-7,
          "path 10 (a): OptNet pattern gradients beyond 1e-7")

    # (b) against the single-process blocked functions and solve.
    for dt, tol in (("float32", 1e-5), ("float64", 1e-10)):
        for r, (a, rf) in enumerate(res):
            e = rel(torch.tensor(a[f"b_fs_{dt}_x"]), want_fs[dt].cpu())
            print(f"# path 10 (b) rank {r}: factor_solve_hybrid_tp m="
                  f"{M10_TP} B={B10_TP} {dt}: x rel {e:.3e}, factor "
                  f"{rf[f'b_fs_{dt}_bytes']} bytes of {base_fs[dt]} "
                  f"single-process, {rf[f'b_fs_{dt}_ms']:.2f} ms, kernel A "
                  f"launches {rf[f'b_fs_{dt}_launches'].get('factor_inv', 0)}"
                  f" [{smi}]")
            check(e <= tol, f"path 10 (b) rank {r}: factor_solve {dt} "
                  f"{e:.3e} > {tol}")
    for tag, n, neq in (("tp", N10_TP, 0), ("tp_eq", N10_EQ, NEQ10)):
        z1, its_1, peak1, l1, ms1 = want_tp[tag]
        print(f"# path 10 (b): single-process 'hybrid_xla' n=m={n} neq="
              f"{neq}: peak {peak1 / 2**20:.1f} MiB above its start, "
              f"kernel A launches {l1.get('factor_inv', 0)}, iterations "
              f"{its_1}, {ms1:.1f} ms")
        for r, (a, rf) in enumerate(res):
            e = rel(torch.tensor(a[f"b_{tag}_z"]), z1.cpu())
            print(f"# path 10 (b) rank {r}: solve_qp_tp n=m={n} neq={neq}: "
                  f"z rel {e:.3e}, iterations {rf[f'b_{tag}_iterations']}, "
                  f"peak {rf[f'b_{tag}_peak_bytes'] / 2**20:.1f} MiB above "
                  f"its start, kernel A launches "
                  f"{rf[f'b_{tag}_launches'].get('factor_inv', 0)}, "
                  f"{rf[f'b_{tag}_ms']:.1f} ms [{smi}]")
            check(e <= 1e-5, f"path 10 (b) rank {r}: solve_qp_tp {tag} "
                  f"{e:.3e} > 1e-5")
            check(rf[f"b_{tag}_iterations"] == its_1,
                  f"path 10 (b) rank {r}: solve_qp_tp iterations")
            check(rf[f"b_{tag}_launches"].get("factor_inv", 0) > 0,
                  f"path 10 (b) rank {r}: kernel A did not run")
    facts.update(
        ranks=[rf for _, rf in res], wall_s=wall, single_forward_ms=fwd_ms,
        single_fb_ms=fb_ms, single_iterations=its1, acc_single=acc1,
        acc_sharded_forward=acc_a, acc_sharded_fb=acc_fb,
        grad_acc_single=gacc1, grad_acc_sharded_fb=gacc_fb, f64_rel=e64,
        optnet_dQ_rel=e_q, optnet_dG_rel=e_g,
        tp_single={t: dict(iterations=w[1], peak_bytes=w[2], launches=w[3],
                           ms=w[4]) for t, w in want_tp.items()},
        path_s=time.perf_counter() - t_path)
    for r_ in rows:
        key = {f"qpth_tpu/ops/pallas/lanes.py:{ln}": k for ln, k in (
            (531, "factor_inv"), (550, "factor_inv_solve_rz"),
            (540, "factor_inv_solve"), (1103, "ipm_step_xfree"),
            (567, "inv_solve"), (918, "ipm_step"),
            (1158, "ipm_step_eq"))}.get(r_["replaces"])
        if key:
            r_["path10_launches_per_rank"] = [
                {c: rf[f"{c}_launches"].get(key, 0) for c in (
                    "a_forward", "a_fb", "b_fs_float32", "b_tp", "b_tp_eq")}
                for _, rf in res]
    print(f"# path 10: {facts['path_s']:.1f} s in all")
    return facts


def main():
    import torch

    # ---- phase 0: facts ----
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to drive", file=sys.stderr)
        sys.exit(2)
    smi = cmd_out(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    print(smi)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    nvcc = cmd_out([os.path.join(os.environ.get("CUDA_HOME",
                                                "/usr/local/cuda"),
                                 "bin", "nvcc"), "--version"])
    print("# nvcc: " + next((ln for ln in nvcc.splitlines()
                             if "release" in ln), nvcc.splitlines()[0]))
    try:
        import triton
        print(f"# triton {triton.__version__} imports")
    except ImportError as e:
        print(f"# triton does not import ({e})")
    print(f"# tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32} (the port turns both "
          "off during a solve)")
    name = torch.cuda.get_device_name(0)
    mem_bw, f32_peak, f64_peak = next((pk[1:] for pk in PEAKS
                                       if pk[0] in name), PEAKS[-1][1:])

    sys.path.insert(0, ROOT)
    import qpth_tpu_torch as qt
    from qpth_tpu_torch.ops import cholesky as chol_ops
    from qpth_tpu_torch.ops import hybrid
    from qpth_tpu_torch.ops.cuda import build, kernels

    dev = torch.device("cuda")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"# phase 1: built {[os.path.basename(str(p)) for p in libs]} "
          f"in {time.perf_counter() - t0:.2f} s")
    # Registers and spills of every kernel instantiation, from ptxas's
    # report that the build keeps beside each library.
    for lib in libs:
        log = lib.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        entries = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) "
                             r"bytes spill stores.*?Used (\d+) registers",
                             text, re.S)
        stem = lib.stem[len("lib"):].rsplit("_", 1)[0]
        print(f"# phase 1: {stem}: registers (spill stores) per "
              "instantiation: " + ", ".join(
                  f"{'f32' if 'kernelIf' in e else 'f64'} {r} ({sp} B)"
                  for e, sp, r in entries))

    # ---- phase 2: each kernel against its plain version ----
    def spd(bR, m, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        L = torch.rand(bR, m, m, generator=g, device=dev,
                       dtype=torch.float64)
        R = L @ L.transpose(1, 2) / m + torch.eye(m, device=dev,
                                                  dtype=torch.float64)
        return R.to(dtype).contiguous()

    def vecs(nb, m, dtype, seed, k=4):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [(torch.rand(nb, m, generator=g, device=dev,
                            dtype=torch.float64) + 0.5).to(dtype)
                for _ in range(k)]

    # Kernel C's variants are keyed apart: with the shift (T's factor),
    # without it (Q's and S11's factors), with the fused solve.
    errs = {k: 0.0 for k in list(kernels.LAUNCHES) + ["chol_shift"]}

    def compare(tag, got, want, tol, key=None):
        """Every output within tol * max(1, max |plain|) of the plain
        version; records the max absolute difference under ``key`` and
        returns it."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        e = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                for a, b in zip(got, want))
        ok = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"# phase 2: {tag}: max abs err {e_abs:.3e}, scaled "
              f"{e:.3e} (tol {tol:g})")
        check(ok and e <= tol, f"{tag}: kernel disagrees with its plain "
              f"version ({e:.3e} > {tol:g}) or is not finite")
        if key is not None:
            errs[key] = max(errs[key], e_abs)
        return e_abs

    variants = (("factor_inv", 0), ("factor_inv_solve", 1),
                ("factor_inv_solve_rz", 2))
    for shared in (False, True):
        bR = 1 if shared else B
        R = spd(bR, NINEQ, torch.float32, 1)
        dinv, rhs, z, q = vecs(B, NINEQ, torch.float32, 2)
        for name_, nv in variants:
            args = (R, dinv, rhs, z)[:2 + nv]
            got = kernels.factor_inv(*args)
            torch.cuda.synchronize()
            compare(f"{name_} f32 B={B} m={NINEQ} bR={bR}", got,
                    kernels.factor_inv_plain(*args), TOL_F32, name_)
        for nc in (0, 2):
            got = kernels.ipm_step_xfree(R, dinv, z, q - 1.0, nc)
            torch.cuda.synchronize()
            compare(f"ipm_step_xfree f32 B={B} m={NINEQ} bR={bR} "
                    f"n_correctors={nc}", got,
                    kernels.ipm_step_xfree_plain(R, dinv, z, q - 1.0, nc),
                    TOL_F32, "ipm_step_xfree")
    # Kernel A at the shapes path 8 (phase 9e) gives it: B batched blocks of
    # the default width and the last partial block one past each fit (238
    # in float32, 167 in float64), with T's shift and without one (Q's and
    # S11's blocks).
    for dtype, tol, m_edge in ((torch.float32, TOL_F32, N8_F32_EDGE),
                               (torch.float64, TOL_F64, N8_F64_EDGE)):
        dt = str(dtype).split(".")[-1]
        for m_ in (hybrid.BLOCK, m_edge % hybrid.BLOCK):
            R = spd(B, m_, dtype, 5)
            dinv = vecs(B, m_, dtype, 6, k=1)[0]
            for shift in (True, False):
                d_ = dinv if shift else torch.zeros_like(dinv)
                got = kernels.factor_inv(R, d_)
                torch.cuda.synchronize()
                compare(f"factor_inv {dt} B={B} m={m_} bR={B} shift={shift}"
                        " (path 8's blocks)", got,
                        kernels.factor_inv_plain(R, d_), tol,
                        "factor_inv" if dtype == torch.float32 else None)
    del R, dinv, d_, got
    # Kernel A at path 9's stage widths, B = 4096, without the shift (each
    # block-Thomas stage is inverted so): examples/mpc.py's 3, path 9b's 16,
    # 9a's 32, and the general planner's block for 9c.
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        dt = str(dtype).split(".")[-1]
        for m_ in sorted(set(STAGE_M9) | {general_stage_width(qt)}):
            R = spd(B, m_, dtype, 7)
            d_ = torch.zeros(B, m_, dtype=dtype, device=dev)
            got = kernels.factor_inv(R, d_)
            torch.cuda.synchronize()
            compare(f"factor_inv {dt} B={B} m={m_} no shift (path 9's "
                    "stages)", got, kernels.factor_inv_plain(R, d_), tol,
                    "factor_inv" if dtype == torch.float32 else None)
    del R, d_, got

    # float64 at an odd shape: a tight check catches indexing faults. One
    # lane is made non-SPD; both versions must freeze exactly that lane.
    Bo, mo = 64, 37
    for shared in (False, True):
        R = spd(1 if shared else Bo, mo, torch.float64, 3)
        dinv, rhs, z, q = vecs(Bo, mo, torch.float64, 4)
        for name_, nv in variants:
            args = (R, dinv, rhs, z)[:2 + nv]
            compare(f"{name_} f64 B={Bo} m={mo} shared={shared}",
                    kernels.factor_inv(*args),
                    kernels.factor_inv_plain(*args), TOL_F64)
        # R - 2 I + diag(s/z) is SPD for s/z >= 3 (R >= I) and not SPD for
        # lane 5's s/z = 0.1.
        Rb = (R - 2.0 * torch.eye(mo, device=dev,
                                  dtype=torch.float64)).contiguous()
        sb = z * (3.0 + dinv)
        sb[5] = 0.1 * z[5]
        for nc in (0, 2):
            got = kernels.ipm_step_xfree(Rb, sb, z, q - 1.0, nc)
            compare(f"ipm_step_xfree f64 B={Bo} m={mo} shared={shared} "
                    f"n_correctors={nc} (lane 5 frozen)", got,
                    kernels.ipm_step_xfree_plain(Rb, sb, z, q - 1.0, nc),
                    TOL_F64)
            check(float(got[3][5]) == 0.0, "non-SPD lane was not frozen")

    # inv_solve and the fused steps with the direct x update: float32 at
    # the main shapes with batched and with shared (stride-0) operands,
    # then float64 at a shape with nz != m != neq and one non-SPD lane.
    def rnd(shape, dtype, seed, scale=0.5):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (scale * (torch.rand(*shape, generator=g, device=dev,
                                    dtype=torch.float64) - 0.5)).to(dtype)

    def step_operands(nb, m, nz, neq, shared, dtype, seed):
        """(matrices, vectors) of ``ipm_step_eq``; ``shared`` names the
        matrix groups given with batch 1: "R", "g" (Q^-1 G^T), "eq" (S21,
        W, S11^-1, S11, Q^-1 A^T)."""
        def b(key):
            return 1 if key in shared else nb

        be = b("eq")
        mats = (spd(b("R"), m, dtype, seed),
                rnd((b("g"), nz, m), dtype, seed + 1),
                rnd((be, m, neq), dtype, seed + 2),
                rnd((be, neq, m), dtype, seed + 3),
                rnd((be, neq, neq), dtype, seed + 4),
                rnd((be, neq, neq), dtype, seed + 5),
                rnd((be, nz, neq), dtype, seed + 6))
        s_, z_, q_ = vecs(nb, m, dtype, seed + 7, k=3)
        x_, ip_ = (rnd((nb, nz), dtype, seed + k, 2.0) for k in (8, 9))
        y_, rb_ = (rnd((nb, neq), dtype, seed + k, 2.0) for k in (10, 11))
        return mats, (x_, s_, z_, y_, q_ - 1.0, ip_, rb_)

    def no_eq(mats, v):
        """``ipm_step``'s operands out of ``ipm_step_eq``'s."""
        x_, s_, z_, _, q_, ip_, _ = v
        return (mats[0], mats[1], x_, s_, z_, q_, ip_)

    Linv = kernels.factor_inv(spd(B, NINEQ, torch.float32, 1),
                              vecs(B, NINEQ, torch.float32, 2)[0])
    rhs = vecs(B, NINEQ, torch.float32, 3)[0] - 1.0
    got = kernels.inv_solve(Linv, rhs)
    torch.cuda.synchronize()
    inv_solve_f32_err = compare(f"inv_solve f32 B={B} m={NINEQ}", got,
                                kernels.inv_solve_plain(Linv, rhs), TOL_F32)
    # float64 at the main shape: what the float64 default (path 4) launches,
    # kernel A's factor_solve once per iteration and inv_solve after it. The
    # inv_solve row of the kernels line is this instantiation's.
    R64 = spd(B, NINEQ, torch.float64, 1)
    dinv64, rhs64 = vecs(B, NINEQ, torch.float64, 2, k=2)
    got = kernels.factor_inv(R64, dinv64, rhs64)
    torch.cuda.synchronize()
    compare(f"factor_inv_solve f64 B={B} m={NINEQ}", got,
            kernels.factor_inv_plain(R64, dinv64, rhs64), TOL_F64)
    compare(f"inv_solve f64 B={B} m={NINEQ}",
            kernels.inv_solve(got[0], rhs64 - 1.0),
            kernels.inv_solve_plain(got[0], rhs64 - 1.0), TOL_F64,
            "inv_solve")
    # common.cuh states whether kernel A's Linv is bit-identical to the plain
    # version's in float64; this is the measurement at the main width.
    got, want = (fn(R64, dinv64) for fn in (kernels.factor_inv,
                                              kernels.factor_inv_plain))
    lanes_equal = int(torch.eq(got, want).all(dim=(1, 2)).sum())
    f64_linv = dict(max_abs_diff=float((got - want).abs().max()),
                    bit_identical=bool(torch.equal(got, want)),
                    lanes_bit_identical=lanes_equal)
    print(f"# phase 2: factor_inv f64 B={B} m={NINEQ} against its plain "
          f"version: max abs diff {f64_linv['max_abs_diff']:.3e}, "
          f"bit-identical {f64_linv['bit_identical']} ({lanes_equal} of "
          f"{B} lanes)")
    del R64, dinv64, rhs64, got, want
    for shared in ((), ("R", "g")):
        mats, v = step_operands(B, NINEQ, NZ, NEQ, shared, torch.float32, 20)
        for nc in (0, 2):
            args = no_eq(mats, v) + (nc,)
            got = kernels.ipm_step(*args)
            torch.cuda.synchronize()
            compare(f"ipm_step f32 B={B} m={NINEQ} nz={NZ} shared={shared} "
                    f"n_correctors={nc}", got, kernels.ipm_step_plain(*args),
                    TOL_F32, "ipm_step")
    eq_shapes = [(NINEQ, NZ, NEQ, sh) for sh in
                 ((), ("R", "g", "eq"), ("R", "eq"))]
    eq_shapes.append((SUDOKU["nx"], SUDOKU["nx"], SUDOKU["neq"],
                      ("R", "g", "eq")))
    # Path 8c's shape: nz = 512 past the block's THREADS = 256 lanes.
    eq_shapes.append((NINEQ8C, N8, NEQ8, ()))
    for m_, nz_, neq_, shared in eq_shapes:
        mats, v = step_operands(B, m_, nz_, neq_, shared, torch.float32, 40)
        for nc in (0, 2):
            got = kernels.ipm_step_eq(*mats, *v, nc)
            torch.cuda.synchronize()
            compare(f"ipm_step_eq f32 B={B} m={m_} nz={nz_} neq={neq_} "
                    f"shared={shared} n_correctors={nc}", got,
                    kernels.ipm_step_eq_plain(*mats, *v, nc), TOL_F32,
                    "ipm_step_eq")
    Bo, mo, nzo, neqo = 64, 17, 33, 5
    for shared in ((), ("R", "g", "eq")):
        mats, v = step_operands(Bo, mo, nzo, neqo, shared, torch.float64, 60)
        Linv = kernels.factor_inv(mats[0], v[1])
        compare(f"inv_solve f64 B={Bo} m={mo} shared={shared}",
                kernels.inv_solve(Linv, v[4]),
                kernels.inv_solve_plain(Linv, v[4]), TOL_F64)
        # As above: lane 5 alone is not SPD and must come back frozen.
        Rb = (mats[0] - 2.0 * torch.eye(mo, device=dev,
                                        dtype=torch.float64)).contiguous()
        x_, s_, z_, y_, q_, ip_, rb_ = v
        sb = z_ * (3.0 + s_)
        sb[5] = 0.1 * z_[5]
        mats, v = (Rb,) + mats[1:], (x_, sb, z_, y_, q_, ip_, rb_)
        for nc in (0, 2):
            for name_, fn, plain, args in (
                    ("ipm_step", kernels.ipm_step, kernels.ipm_step_plain,
                     no_eq(mats, v) + (nc,)),
                    ("ipm_step_eq", kernels.ipm_step_eq,
                     kernels.ipm_step_eq_plain, mats + v + (nc,))):
                got = fn(*args)
                compare(f"{name_} f64 B={Bo} m={mo} nz={nzo} neq={neqo} "
                        f"shared={shared} n_correctors={nc} (lane 5 "
                        "frozen)", got, plain(*args), TOL_F64)
                check(float(got[-1][5]) == 0.0
                      and bool(torch.equal(got[0][5], x_[5])),
                      f"{name_}: non-SPD lane was not frozen")
    del Linv, mats, v, got

    # Kernel 5 at every m from 1 to kernel A's largest fit, at B = 1, 64 and
    # B + 1 (a ragged last block of QPs). The kernel gets Linv with NaN above
    # the diagonal, which it must not read (the plain version gets the
    # zeros); where B > 3, lane 3 holds a NaN on its diagonal that must stay
    # in lane 3. Rows of whole 16-byte vectors take the vector path; any
    # other m, or an rhs one element off a 16-byte boundary, the scalar path.
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        elt_ = torch.empty((), dtype=dtype).element_size()
        for m_ in INV_SOLVE_M:
            if not kernels.fits(m_, dtype):
                continue
            Linv_all = kernels.factor_inv(
                spd(B + 1, m_, dtype, 130), vecs(B + 1, m_, dtype, 131,
                                                 k=1)[0])
            rhs_all = vecs(B + 1, m_, dtype, 132, k=1)[0] - 1.0
            upper = torch.ones(m_, m_, dtype=torch.bool, device=dev).triu(1)
            for nb in (1, 64, B + 1):
                clean = Linv_all[:nb].clone()
                if nb > 3:
                    clean[3, m_ // 2, m_ // 2] = float("nan")
                dirty = clean.masked_fill(upper, float("nan"))
                offsets = (0, 1) if nb == B + 1 and m_ in (40, NINEQ) else (0,)
                for off in offsets:
                    buf = torch.empty(nb * m_ + off, dtype=dtype, device=dev)
                    rhs_ = buf[off:].view(nb, m_)
                    rhs_.copy_(rhs_all[:nb])
                    got = kernels.inv_solve(dirty, rhs_)
                    torch.cuda.synchronize()
                    want = kernels.inv_solve_plain(clean, rhs_)
                    bad = torch.isnan(got).any(dim=1)
                    check(bool(torch.equal(bad, torch.isnan(want).any(dim=1)))
                          and bad.tolist() == [k == 3 and nb > 3
                                               for k in range(nb)],
                          f"inv_solve {dtype} B={nb} m={m_}: the NaN lane is "
                          "not NaN alone, or the upper triangle was read")
                    path = ("16-byte" if (m_ * elt_) % 16 == 0 and off == 0
                            else "scalar")
                    compare(f"inv_solve {dtype} B={nb} m={m_} ({path} path, "
                            "NaN above the diagonal)", got[~bad], want[~bad],
                            tol)
            del Linv_all, rhs_all, clean, dirty, buf, rhs_

    # Kernel 11 (diag_step): float32 at path 5's shape (n = 64, neq = 40)
    # with g shared and batched, float64 at an odd shape with n beyond the
    # block's threads and one lane whose M is not SPD (frozen by both).
    def diag_operands(nb, n, neq, g_batched, dtype, seed, nan_lane=None):
        """One interior iterate of a diagonal-tier QP with a shared A and
        M = A diag(1/H) A^T from it: diag_step's operands."""
        g_ = torch.Generator(device=dev).manual_seed(seed)

        def r(*shape):
            return torch.rand(*shape, generator=g_, device=dev,
                              dtype=torch.float64)

        A = r(1, neq, n)
        g = -(0.5 + r(nb if g_batched else 1, n))
        s_, z_ = 0.5 + r(nb, n), 0.5 + r(nb, n)
        H = 0.1 + g * g * z_ / s_
        M = torch.matmul(A * (1.0 / H).unsqueeze(-2), A.transpose(-1, -2))
        if nan_lane is not None:
            M[nan_lane] = -M[nan_lane]
        vs = [r(nb, n) - 0.5, r(nb, n) - 0.5, r(nb, neq) - 0.5,
              r(nb, n) - 0.5, s_, z_, r(nb, neq) - 0.5]
        return [x_.to(dtype).contiguous() for x_ in [M, A, g, H] + vs]

    for g_batched in (False, True):
        args = diag_operands(B, SUDOKU["nx"], SUDOKU["neq"], g_batched,
                             torch.float32, 90)
        for nc in (0, 2):
            got = kernels.diag_step(*args, nc)
            torch.cuda.synchronize()
            compare(f"diag_step f32 B={B} n={SUDOKU['nx']} "
                    f"neq={SUDOKU['neq']} g_batched={g_batched} "
                    f"n_correctors={nc}", got,
                    kernels.diag_step_plain(*args, nc), TOL_F32,
                    "diag_step")
    for n_, neq_ in ((37, 11), (300, 20)):
        args = diag_operands(64, n_, neq_, True, torch.float64, 91,
                             nan_lane=5)
        for nc in (0, 2):
            got = kernels.diag_step(*args, nc)
            compare(f"diag_step f64 B=64 n={n_} neq={neq_} n_correctors="
                    f"{nc} (lane 5 frozen)", got,
                    kernels.diag_step_plain(*args, nc), TOL_F64)
            check(all(bool(torch.equal(o[5], a_[5]))
                      for o, a_ in zip(got, args[7:])),
                  "diag_step: the lane with a non-SPD M was not frozen")
    del args, got

    # The one-tile recurrence (common.cuh::chol_inv_smem) at the largest m
    # of kernels.fits (B = 64), with an nz and neq that fill the rest of the
    # block: kernel A's three variants (lane 3 of the batched R not SPD: NaN
    # in that lane alone) and the three fused-step modes (lane 5's T not
    # SPD: frozen), R batched and shared; kernel 11 at a width of M beyond
    # the old two-tile fit, with the largest n beside it.
    tile_max = {torch.float32: (237, 7, 8), torch.float64: (166, 100, 16)}
    for dtype, (m_, nz_, neq_) in tile_max.items():
        tol = TOL_F32 if dtype == torch.float32 else TOL_F64
        check(kernels.fits(m_, dtype, nz_, neq_)
              and not kernels.fits(m_ + 1, dtype)
              and not kernels.fits(m_, dtype, nz_ + 1, neq_),
              f"fits' largest m, nz, neq for {dtype}")
        for shared in (False, True):
            R_ = spd(1 if shared else 64, m_, dtype, 130)
            if not shared:
                R_[3] = -R_[3]
            dinv_, rhs_, z_ = vecs(64, m_, dtype, 131, k=3)
            for name_, nv in variants:
                args = (R_, dinv_, rhs_, z_)[:2 + nv]
                got = kernels.factor_inv(*args)
                torch.cuda.synchronize()
                want = kernels.factor_inv_plain(*args)
                got_t = got if isinstance(got, tuple) else (got,)
                want_t = want if isinstance(want, tuple) else (want,)
                bad = torch.isnan(got_t[0]).any(dim=(1, 2))
                check((bool(bad[3]) and int(bad.sum()) == 1
                       if not shared else not bool(bad.any()))
                      and all(bool(torch.equal(torch.isnan(a), torch.isnan(
                          b_))) for a, b_ in zip(got_t, want_t)),
                      f"{name_}: the non-SPD lane is not NaN alone")
                keep = ~bad
                compare(f"{name_} {dtype} B=64 m={m_} shared={shared} "
                        f"(largest fit; lane 3 NaN: {not shared})",
                        tuple(a[keep] for a in got_t),
                        tuple(b_[keep] for b_ in want_t), tol)
                check(not bool(torch.triu(got_t[0], 1).any()),
                      f"{name_}: nonzero entries above the diagonal")
        for shared in ((), ("R", "g", "eq")):
            mats, v = step_operands(64, m_, nz_, neq_, shared, dtype, 140)
            x_, s_, z_, y_, q_, ip_, rb_ = v
            Rb = (mats[0] - 2.0 * torch.eye(m_, device=dev,
                                            dtype=dtype)).contiguous()
            sb = z_ * (3.0 + s_)
            sb[5] = 0.1 * z_[5]
            mats = (Rb,) + mats[1:]
            for name_, fn, plain, args in (
                    ("ipm_step_xfree", kernels.ipm_step_xfree,
                     kernels.ipm_step_xfree_plain, (Rb, sb, z_, q_, 2)),
                    ("ipm_step", kernels.ipm_step, kernels.ipm_step_plain,
                     no_eq(mats, (x_, sb, z_, y_, q_, ip_, rb_)) + (2,)),
                    ("ipm_step_eq", kernels.ipm_step_eq,
                     kernels.ipm_step_eq_plain,
                     mats + (x_, sb, z_, y_, q_, ip_, rb_, 2))):
                got = fn(*args)
                torch.cuda.synchronize()
                compare(f"{name_} {dtype} B=64 m={m_} nz={nz_} neq={neq_} "
                        f"shared={shared} n_correctors=2 (largest fit; lane "
                        "5 frozen)", got, plain(*args), tol)
                check(float(got[-1][5]) == 0.0
                      and int((got[-1] > 0).sum()) == 63,
                      f"{name_}: the non-SPD lane alone must be frozen")
    for dtype, n_, neq_ in ((torch.float32, 3170, 160),
                            (torch.float64, 264, 160)):
        check(kernels.diag_step_fits(n_, neq_, dtype)
              and not kernels.diag_step_fits(n_ + 1, neq_, dtype),
              f"diag_step_fits' largest n at neq = {neq_} for {dtype}")
        args = diag_operands(64, n_, neq_, True, dtype, 141, nan_lane=5)
        got = kernels.diag_step(*args, 2)
        torch.cuda.synchronize()
        compare(f"diag_step {dtype} B=64 n={n_} neq={neq_} n_correctors=2 "
                "(largest n at this neq; lane 5 frozen)", got,
                kernels.diag_step_plain(*args, 2),
                TOL_F32 if dtype == torch.float32 else TOL_F64)
        check(all(bool(torch.equal(o[5], a_[5]))
                  for o, a_ in zip(got, args[7:])),
              "diag_step: the lane with a non-SPD M was not frozen")
    del R_, dinv_, rhs_, z_, mats, v, Rb, sb, args, got, want

    # Kernels C (chol), D (cho_solve) and E (trinv): float32 and float64 at
    # the main shape m = 100 (B = 4096), at the ragged panel sizes m = 1,
    # 31, 32, 33, 37, 65 (panels of 32 rows) and at the largest m chol_fits
    # allows (B = 64), with R batched and shared, with and without the
    # shift and the rhs; one lane of the batched R is not SPD and must come
    # back NaN in that lane alone.
    m_max = {torch.float32: 239, torch.float64: 168}
    for dtype in (torch.float32, torch.float64):
        check(kernels.chol_fits(m_max[dtype], dtype)
              and not kernels.chol_fits(m_max[dtype] + 1, dtype),
              f"chol_fits' largest m for {dtype}")
        tol = TOL_F32 if dtype == torch.float32 else TOL_F64
        for nb, m_ in ((B, NINEQ), (64, 1), (64, 31), (64, 32), (64, 33),
                       (64, 37), (64, 65), (64, m_max[dtype])):
            for shared in (False, True):
                R_ = spd(1 if shared else nb, m_, dtype, 110)
                dinv_, rhs_ = vecs(nb, m_, dtype, 111, k=2)
                if not shared:
                    R_[3] = -R_[3]                # lane 3 is not SPD
                for key, args in (
                        ("chol", (R_.expand(nb, m_, m_).contiguous(),)
                         if shared else (R_,)),
                        ("chol_shift", (R_, dinv_)),
                        ("chol_solve", (R_, dinv_, rhs_ - 1.0)),
                        ("chol_solve", (R_, None, rhs_ - 1.0))):
                    got = kernels.chol(*args)
                    torch.cuda.synchronize()
                    want = kernels.chol_plain(*args)
                    got_t = got if isinstance(got, tuple) else (got,)
                    want_t = want if isinstance(want, tuple) else (want,)
                    bad = torch.isnan(got_t[0]).any(dim=(1, 2))
                    nan_ok = (bool(bad[3]) and int(bad.sum()) == 1
                              if not shared else not bool(bad.any()))
                    check(nan_ok and all(
                        bool(torch.equal(torch.isnan(a), torch.isnan(b_)))
                        for a, b_ in zip(got_t, want_t)),
                        f"{key}: the non-SPD lane is not NaN alone")
                    keep = ~bad
                    compare(f"{key} {dtype} B={nb} m={m_} shared={shared}"
                            f" shift={args[1] is not None if len(args) > 1 else False}"
                            f" (lane 3 NaN: {not shared})",
                            tuple(a[keep] for a in got_t),
                            tuple(b_[keep] for b_ in want_t), tol,
                            key if (nb, m_, dtype) == (B, NINEQ,
                                                       torch.float32)
                            else None)
                    check(not bool(torch.tril(got_t[0][keep], -1).any()),
                          f"{key}: nonzero entries below the diagonal")
        # Kernel D in both regimes, a factor per lane (Lt of T, batched L_Q)
        # and one shared factor (L_Q of the OptNet pattern), upper and
        # lower, at n = 1, 37, 100 and the largest fit and B = 1, 64, 4096
        # (128 tiles of 32 right-hand sides) and 4097. Entries across the
        # diagonal hold noise the kernel must not read. Where B > 3, lane 3's
        # factor (per lane) or right-hand side (shared) holds a NaN that must
        # stay in lane 3.
        tol_d = TOL_F32 if dtype == torch.float32 else TOL_D64
        n_all = max(64, B + 1)
        for n_ in (1, 37, NINEQ, m_max[dtype]):
            Lt_all = kernels.chol(spd(n_all, n_, dtype, 112))
            v_all = vecs(n_all, n_, dtype, 113, k=1)[0] - 1.0
            gn = torch.Generator(device=dev).manual_seed(115)
            for nb in (1, 64, B, B + 1):
                for shared in (False, True):
                    for lower in (False, True):
                        F_ = Lt_all[:1 if shared else nb]
                        F_ = (F_.transpose(1, 2) if lower else F_).clone(
                            memory_format=torch.contiguous_format)
                        if n_ > 1:
                            noise = torch.randn(F_.shape, generator=gn,
                                                device=dev, dtype=dtype)
                            F_ += (torch.triu(noise, 1) if lower
                                   else torch.tril(noise, -1))
                        v_ = v_all[:nb].clone()
                        if nb > 3 and shared:
                            v_[3, 0] = float("nan")
                        elif nb > 3:
                            F_[3, n_ // 2, n_ // 2] = float("nan")
                        got = kernels.cho_solve(F_, v_, lower=lower)
                        torch.cuda.synchronize()
                        want = kernels.cho_solve_plain(F_, v_, lower)
                        bad = torch.isnan(got).any(dim=1)
                        check(bool(torch.equal(torch.isnan(got),
                                               torch.isnan(want)))
                              and bad.tolist() == [k == 3 and nb > 3
                                                   for k in range(nb)],
                              f"cho_solve n={n_} B={nb} shared={shared} "
                              f"lower={lower}: the NaN lane is not NaN "
                              "alone")
                        keep = ~bad
                        compare(f"cho_solve {dtype} B={nb} n={n_} "
                                f"shared={shared} lower={lower}",
                                got[keep], want[keep], tol_d,
                                ("cho_solve_shared" if shared else
                                 "cho_solve") if (nb, n_, dtype)
                                == (B, NINEQ, torch.float32) else None)
            del Lt_all, v_all
        # Kernel E at the ragged panel sizes and up to the largest fit: one
        # tile now, so float32 n = 200, 239 and float64 n = 150, 168 launch
        # (two tiles fitted only n <= 169 / 120); spd_inverse (kernel C,
        # kernel E, the Gram product) at the largest two.
        big = (200, 239) if dtype == torch.float32 else (150, 168)
        for nb, n_ in ((B, NINEQ), (64, 1), (64, 31), (64, 32), (64, 33),
                       (64, 37), (64, 65)) + tuple((64, k) for k in big):
            A_ = spd(nb, n_, dtype, 114)
            Lt_ = kernels.chol(A_)
            got = kernels.trinv(Lt_)
            torch.cuda.synchronize()
            compare(f"trinv {dtype} B={nb} n={n_}", got,
                    kernels.trinv_plain(Lt_), tol,
                    "trinv" if (nb, n_, dtype) == (B, NINEQ, torch.float32)
                    else None)
            check(not bool(torch.triu(got, 1).any()),
                  "trinv: nonzero entries above the diagonal")
            if n_ in big:
                Ai = chol_ops.spd_inverse(A_)
                torch.cuda.synchronize()
                Lp_ = kernels.trinv_plain(kernels.chol_plain(A_))
                compare(f"spd_inverse {dtype} B={nb} n={n_}", Ai,
                        torch.matmul(Lp_.transpose(-1, -2), Lp_), tol)
    del R_, dinv_, rhs_, Lt_, F_, v_, got, want, noise, A_, Ai, Lp_

    # Refinement's solve (path 7): kernel A with rhs under "auto", kernel C
    # with rhs under "blocked", on T = R + diag(1/d) with refinement's
    # clamped d = max(z, c) / max(s, c), c = 1e-10. Active rows (s -> 0)
    # give d ~ 1e10, inactive ones (z -> 0) d ~ 1e-10, so T's diagonal
    # holds 1/d from ~1e-10 to ~1e10 beside R's O(1) entries.
    def refine_dinv(nb, m, dtype, seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand(nb, m, generator=g_, device=dev, dtype=torch.float64)
        active = torch.rand(nb, m, generator=g_, device=dev) < 0.5
        tiny, big = 10.0 ** (-16.0 + 6.0 * u), 0.5 + u
        s_ = torch.where(active, tiny, big)
        z_ = torch.where(active, big, tiny)
        d_ = z_.clamp(min=1e-10) / s_.clamp(min=1e-10)
        return (1.0 / d_).to(dtype)

    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        dinv_ = refine_dinv(B, NINEQ, dtype, 150)
        rhs_ = vecs(B, NINEQ, dtype, 151, k=1)[0] - 1.0
        for shared in (False, True):
            R_ = spd(1 if shared else B, NINEQ, dtype, 152)
            for key, fn, plain in (
                    ("factor_inv_solve", kernels.factor_inv,
                     kernels.factor_inv_plain),
                    ("chol_solve", kernels.chol, kernels.chol_plain)):
                got = fn(R_, dinv_, rhs_)
                torch.cuda.synchronize()
                compare(f"{key} {dtype} B={B} m={NINEQ} shared={shared} on "
                        "refinement's clamped diagonal (1/d from "
                        f"{float(dinv_.min()):.1e} to "
                        f"{float(dinv_.max()):.1e})", got,
                        plain(R_, dinv_, rhs_), tol)
    del R_, dinv_, rhs_, got

    # ---- phase 3: forward at full width through the kernels ----
    Q, p, G, h = make_problem(B, NZ, NINEQ, seed=0)
    f32 = [torch.tensor(v, dtype=torch.float32, device=dev)
           for v in (Q, p, G, h)]
    cfg = qt.SolverConfig(check_Q_spd=False)
    kernels.reset_launches()
    sol = qt.solve_qp_full(*f32, config=cfg)
    torch.cuda.synchronize()
    fwd_launches = dict(kernels.LAUNCHES)
    its = int(sol.stats.iterations)
    print(f"# phase 3: forward f32 B={B}: iterations {its}, launches "
          f"{fwd_launches}, best_resids max "
          f"{float(sol.stats.best_resids.max()):.3e} median "
          f"{float(sol.stats.best_resids.median()):.3e}")
    check(fwd_launches["factor_inv"] == 1, "prefactor did not launch "
          "factor_inv once")
    check(fwd_launches["factor_inv_solve_rz"] == 1, "init did not launch "
          "factor_inv_solve_rz once")
    check(fwd_launches["ipm_step_xfree"] in (its - 1, its)
          and fwd_launches["ipm_step_xfree"] > 0,
          "ipm_step_xfree did not run once per stepped iteration")
    for name_ in ("z", "lam", "s"):
        check(bool(torch.isfinite(getattr(sol, name_)).all()),
              f"forward {name_} not finite")
    check(tuple(sol.z.shape) == (B, NZ), "forward z shape")

    cfg64 = qt.SolverConfig(solve_method="inverse", resid_every=7,
                            check_Q_spd=False)

    def f64(arrs, n, device):
        return [torch.tensor(v[:n], dtype=torch.float64, device=device)
                for v in arrs]

    sol64 = qt.solve_qp_full(*f64((Q, p, G, h), N_F64_CARD, dev),
                             config=cfg64)
    z32 = sol.z[:N_F64_CARD].double()
    lane_err = ((z32 - sol64.z).norm(dim=1)
                / sol64.z.norm(dim=1).clamp_min(1e-300))
    med = float(lane_err.median())
    print(f"# phase 3: f32 vs f64 (card) over {N_F64_CARD} lanes: median "
          f"relative z error {med:.3e}, max {float(lane_err.max()):.3e}")
    check(med <= 2e-2, f"f32 median relative error {med:.3e} > 2e-2")
    card64 = qt.solve_qp_full(*f64((Q, p, G, h), N_F64_CPU, dev),
                              config=cfg64)
    t0 = time.perf_counter()
    cpu64 = qt.solve_qp_full(*f64((Q, p, G, h), N_F64_CPU, "cpu"),
                             config=cfg64, device="cpu")
    e = rel(card64.z.cpu(), cpu64.z)
    print(f"# phase 3: f64 card vs CPU over {N_F64_CPU} lanes: z rel err "
          f"{e:.3e}, iterations {int(card64.stats.iterations)} / "
          f"{int(cpu64.stats.iterations)} (CPU solve "
          f"{time.perf_counter() - t0:.1f} s)")
    check(e <= 1e-8, f"f64 card vs CPU z {e:.3e} > 1e-8")
    check(int(card64.stats.iterations) == int(cpu64.stats.iterations),
          "f64 card vs CPU iterations differ")

    # ---- phase 4: forward + backward at full width (the main path) ----
    def fwd_bwd(arrs, config, device):
        Qt, pt, Gt, ht = arrs
        Qt = Qt.clone().requires_grad_(True)
        pt = pt.clone().requires_grad_(True)
        z = qt.solve_qp(Qt, pt, Gt, ht, config=config, device=device)
        (z * z).sum().backward()
        return z, Qt.grad, pt.grad

    kernels.reset_launches()
    z, gQ, gp = fwd_bwd(f32, cfg, dev)
    torch.cuda.synchronize()
    main_launches = dict(kernels.LAUNCHES)
    print(f"# phase 4: forward+backward f32 B={B}: launches "
          f"{main_launches}")
    check(bool(torch.isfinite(gQ).all() and torch.isfinite(gp).all()),
          "gradients not finite")
    check(main_launches["factor_inv_solve"] == 1,
          "backward did not launch factor_inv_solve once")
    missing = [k for k in ("factor_inv", "factor_inv_solve",
                           "factor_inv_solve_rz", "ipm_step_xfree")
               if main_launches[k] == 0]
    check(not missing, f"main path launched no {missing}")
    _, gQc, gpc = fwd_bwd(f64((Q, p, G, h), N_F64_CPU, dev), cfg64, dev)
    _, gQh, gph = fwd_bwd(f64((Q, p, G, h), N_F64_CPU, "cpu"), cfg64, "cpu")
    eg = max(rel(gQc.cpu(), gQh), rel(gpc.cpu(), gph))
    print(f"# phase 4: f64 gradients card vs CPU over {N_F64_CPU} lanes: "
          f"rel err {eg:.3e}")
    check(eg <= 1e-7, f"f64 gradients card vs CPU {eg:.3e} > 1e-7")

    # ---- phase 5: the OptNet pattern (shared Q/G, batched p/h) ----
    Qs, _, Gs, _ = make_problem(1, NZ, NINEQ, seed=1)
    npr = np.random.RandomState(2)
    ps = npr.randn(B, NZ)
    hs = (np.einsum("mn,bn->bm", Gs[0], npr.randn(B, NZ))
          + npr.rand(B, NINEQ))
    shared = (Qs[0], ps, Gs[0], hs)
    sh32 = [torch.tensor(v, dtype=torch.float32, device=dev) for v in shared]
    kernels.reset_launches()
    sol_s = qt.solve_qp_full(*sh32, config=cfg)
    torch.cuda.synchronize()
    print(f"# phase 5: OptNet pattern f32 B={B}: iterations "
          f"{int(sol_s.stats.iterations)}, launches {dict(kernels.LAUNCHES)}"
          f", best_resids median {float(sol_s.stats.best_resids.median()):.3e}")
    check(kernels.LAUNCHES["ipm_step_xfree"] > 0
          and bool(torch.isfinite(sol_s.z).all()),
          "OptNet pattern did not run through the kernels")
    def sh64(device):
        Qv, pv, Gv, hv = shared
        return [torch.tensor(v, dtype=torch.float64, device=device)
                for v in (Qv, pv[:N_F64_CPU], Gv, hv[:N_F64_CPU])]

    c64 = qt.solve_qp_full(*sh64(dev), config=cfg64)
    h64 = qt.solve_qp_full(*sh64("cpu"), config=cfg64, device="cpu")
    e = rel(c64.z.cpu(), h64.z)
    print(f"# phase 5: f64 card vs CPU over {N_F64_CPU} lanes: z rel err "
          f"{e:.3e}")
    check(e <= 1e-8 and int(c64.stats.iterations)
          == int(h64.stats.iterations), "OptNet pattern f64 card vs CPU")

    # ---- phases 6-9: this slice's paths, each with its own counts ----
    def tensors(arrs, dtype, device, n=None):
        """Arrays to tensors; ``n`` cuts the batch of those that carry
        it (leading dimension B)."""
        return [torch.tensor(v[:n] if n and v.shape[0] == B else v,
                             dtype=dtype, device=device) for v in arrs]

    def drive(tag, arrs, config, **kw):
        """One forward through the entry point with the counts set to 0
        just before and read just after."""
        kernels.reset_launches()
        sol = qt.solve_qp_full(*arrs, config=config, **kw)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        its_ = int(sol.stats.iterations)
        print(f"# {tag}: iterations {its_}, launches "
              f"{ {k: v for k, v in launches.items() if v} }, best_resids "
              f"max {float(sol.stats.best_resids.max()):.3e} median "
              f"{float(sol.stats.best_resids.median()):.3e}")
        for name_ in ("z", "nu", "lam", "s"):
            check(bool(torch.isfinite(getattr(sol, name_)).all()),
                  f"{tag}: {name_} not finite")
        return sol, launches, its_

    def fused_once_per_step(tag, launches, its_, key):
        """The fused kernel ``key`` ran once per stepped iteration and no
        other step kernel ran."""
        others = {"ipm_step", "ipm_step_eq", "ipm_step_xfree",
                  "inv_solve"} - {key}
        check(launches[key] in (its_ - 1, its_) and launches[key] > 0
              and not any(launches[k] for k in others),
              f"{tag}: {key} did not run once per stepped iteration")

    def grads_of(arrs, config, device, **kw):
        """z and the gradients of sum(z^2) to every parameter."""
        args = [t.clone().requires_grad_(True) for t in arrs]
        z_ = qt.solve_qp(*args, config=config, device=device, **kw)
        (z_ * z_).sum().backward()
        return z_.detach(), [a.grad for a in args]

    def f32_error(tag, z32_, arrs_np, config64, limit=2e-2,
                  solve=qt.solve_qp_full):
        """Median relative z error of the float32 solve against a float64
        solve of the first N_F64_CARD lanes on the card; ``limit`` None
        reports it without a check."""
        ref = solve(*tensors(arrs_np, torch.float64, dev, N_F64_CARD),
                    config=config64)
        err = ((z32_[:N_F64_CARD].double() - ref.z).norm(dim=1)
               / ref.z.norm(dim=1).clamp_min(1e-300))
        med_ = float(err.median())
        print(f"# {tag}: f32 vs f64 (card) over {N_F64_CARD} lanes: median "
              f"relative z error {med_:.3e}, max {float(err.max()):.3e}")
        check(limit is None or med_ <= limit, f"{tag}: f32 median relative "
              f"error {med_:.3e} > {limit}")
        return med_

    def card_vs_cpu(tag, arrs_np, config, names, same_iterations=True):
        """float64 on the card against float64 on the CPU over N_F64_CPU
        lanes: z and nu to 1e-8, the gradients named in ``names`` to 1e-7
        (relative to the largest entry)."""
        out = {}
        for device in (dev, "cpu"):
            arrs = tensors(arrs_np, torch.float64, device, N_F64_CPU)
            sol_ = qt.solve_qp_full(*arrs, config=config, device=device)
            _, g_ = grads_of(arrs, config, device)
            out[device] = (sol_, g_)
        (sc_, gc_), (sh_, gh_) = out[dev], out["cpu"]
        ez = rel(sc_.z.cpu(), sh_.z)
        enu = rel(sc_.nu.cpu(), sh_.nu) if sh_.nu.shape[1] else 0.0
        eg = {n: rel(gc_[i].cpu(), gh_[i])
              for i, n in enumerate("QpGhAb"[:len(gc_)]) if n in names}
        print(f"# {tag}: f64 card vs CPU over {N_F64_CPU} lanes: z "
              f"{ez:.3e}, nu {enu:.3e}, gradients "
              + ", ".join(f"{n} {e:.3e}" for n, e in eg.items())
              + f"; iterations {int(sc_.stats.iterations)} / "
              f"{int(sh_.stats.iterations)}")
        check(ez <= 1e-8 and enu <= 1e-8, f"{tag}: f64 card vs CPU z/nu")
        check(all(e <= 1e-7 for e in eg.values()),
              f"{tag}: f64 card vs CPU gradients")
        if same_iterations:
            check(int(sc_.stats.iterations) == int(sh_.stats.iterations),
                  f"{tag}: f64 card vs CPU iterations differ")
        return dict(z=ez, nu=enu, grads=eg)

    path_launches, path_facts = {}, {}

    # ---- phase 6 (path 1): equality constraints, fully batched ----
    eq_raw = make_problem(B, NZ, NINEQ, seed=0, neq=NEQ)
    check(all(np.array_equal(a, c) for a, c in zip(eq_raw, (Q, p, G, h))),
          "the equality rows changed the draws of Q, p, G, h")
    eq_np = (eq_raw[0] + EQ_SHIFT * np.eye(NZ),) + eq_raw[1:]
    eq32 = tensors(eq_np, torch.float32, dev)
    sol1, l1, its1 = drive(f"phase 6 (path 1): eq forward f32 B={B} "
                           f"neq={NEQ}", eq32, cfg)
    fused_once_per_step("path 1", l1, its1, "ipm_step_eq")
    check(l1["factor_inv"] == 2 and l1["factor_inv_solve_rz"] == 1,
          "path 1: prefactor (Q and S11) and init launches")
    med1 = f32_error("phase 6 (path 1)", sol1.z, eq_np, cfg64)
    kernels.reset_launches()
    _, g1 = grads_of(eq32, cfg, dev)
    torch.cuda.synchronize()
    path_launches["path1_eq_batched"] = dict(forward=l1,
                                             forward_backward=dict(
                                                 kernels.LAUNCHES))
    print(f"# phase 6 (path 1): forward+backward launches "
          f"{path_launches['path1_eq_batched']['forward_backward']}")
    check(all(bool(torch.isfinite(g_).all()) for g_ in g1)
          and len(g1) == 6, "path 1: gradients to all six not finite")
    check(kernels.LAUNCHES["factor_inv_solve"] == 1
          and kernels.LAUNCHES["ipm_step_eq"] > 0,
          "path 1: backward did not launch factor_inv_solve once")
    # The generator's own Q, reported and not held to a limit: float32
    # inverse mode cannot solve it with equality rows (the JAX package's
    # float32 path leaves the same error; tests/test_torch_qp_eq.py).
    cfg_quiet = qt.SolverConfig(check_Q_spd=False, verbose=-1)
    sol1r, _, its1r = drive("phase 6 (path 1, Q unshifted, not gated)",
                            tensors(eq_raw, torch.float32, dev), cfg_quiet)
    med1r = f32_error("phase 6 (path 1, Q unshifted, not gated)", sol1r.z,
                      eq_raw, cfg64, limit=None)
    path_facts["path1_eq_batched"] = dict(
        iterations=its1, f32_median_rel_err=med1, q_shift=EQ_SHIFT,
        unshifted=dict(iterations=its1r, f32_median_rel_err=med1r),
        card_vs_cpu=card_vs_cpu("phase 6 (path 1)", eq_np, cfg64, "QpGhAb"))
    del g1, sol1r

    # ---- phase 7 (path 2): the OptNet sudoku pattern ----
    # R = G Q^-1 G^T - S21 W = 10 (I - P_A) is singular here, so in the
    # backward T = R + diag(s / lam) leans on its diagonal. At the default
    # backward clamp (1e-8) s / lam reaches 1e-17 and 58 of 4096 lanes give
    # a T that is not SPD in float32 (NaN in the A gradient, which sums
    # over lanes); float32 needs grad_clamp = 1e-5 on this QP.
    cfg_sud = qt.SolverConfig(check_Q_spd=False, grad_clamp=1e-5)
    sud_np = make_sudoku(B, SUDOKU["nx"], SUDOKU["neq"], seed=0)
    sud32 = tensors(sud_np, torch.float32, dev)
    sol2, l2, its2 = drive(f"phase 7 (path 2): sudoku pattern f32 B={B} "
                           f"nz=nineq={SUDOKU['nx']} neq={SUDOKU['neq']}",
                           sud32, cfg_sud)
    fused_once_per_step("path 2", l2, its2, "ipm_step_eq")
    med2 = f32_error("phase 7 (path 2)", sol2.z, sud_np, cfg64)
    kernels.reset_launches()
    _, g2 = grads_of(sud32, cfg_sud, dev)
    torch.cuda.synchronize()
    path_launches["path2_sudoku"] = dict(forward=l2, forward_backward=dict(
        kernels.LAUNCHES))
    check(tuple(g2[4].shape) == (SUDOKU["neq"], SUDOKU["nx"])
          and bool(torch.isfinite(g2[4]).all())
          and kernels.LAUNCHES["ipm_step_eq"] > 0,
          "path 2: gradient to the shared A")
    # How good the float32 gradient is: against float64 with the same
    # clamp, per lane (A given per lane over N_F64_CARD lanes) and for the
    # shared A (the sum over all lanes, where the lanes' errors meet
    # cancellation). The QP is degenerate (x_i = 0 with lam_i near 0 in
    # many coordinates), so a float32 forward error of 1e-3 moves some
    # lanes' d = lam / s a long way: the per-lane median is the metric.
    cfg64_sud = qt.SolverConfig(solve_method="inverse", resid_every=7,
                                check_Q_spd=False, grad_clamp=1e-5)
    _, g2_64 = grads_of(tensors(sud_np, torch.float64, dev), cfg64_sud, dev)
    cos_gA = float(torch.nn.functional.cosine_similarity(
        g2[4].double().flatten(), g2_64[4].flatten(), dim=0))
    lanes_np = [v[:N_F64_CARD] if v.shape[0] == B else v for v in sud_np]
    lanes_np[4] = np.broadcast_to(sud_np[4], (N_F64_CARD,)
                                  + sud_np[4].shape).copy()
    per_lane = [grads_of(tensors(lanes_np, dt, dev), c_, dev)[1][4]
                .double().flatten(1)
                for dt, c_ in ((torch.float32, cfg_sud),
                               (torch.float64, cfg64_sud))]
    lane_err = ((per_lane[0] - per_lane[1]).norm(dim=1)
                / per_lane[1].norm(dim=1).clamp_min(1e-300))
    med_gA = float(lane_err.median())
    print(f"# phase 7 (path 2): gradient to A, f32 vs f64 on the card "
          f"(grad_clamp 1e-5): per lane over {N_F64_CARD} lanes median rel "
          f"err {med_gA:.3e}, 90th percentile "
          f"{float(lane_err.quantile(0.9)):.3e}; shared A over all {B} "
          f"lanes: max-norm rel err {rel(g2[4].double(), g2_64[4]):.3e}, "
          f"cosine {cos_gA:.4f}")
    check(med_gA <= 5e-2 and cos_gA >= 0.9,
          f"path 2: f32 gradient to A (per-lane median {med_gA:.3e}, "
          f"cosine {cos_gA:.4f})")
    # The layer's own b = 1, reported and not held to a limit: with a
    # random A the set {x >= 0, A x = 1} is empty, so there is no solution
    # to hold the solver to: it returns its least-bad iterate, A z = 1 with
    # some z_i < 0, and its best score stays of order 1.
    b1_np = sud_np[:5] + (np.ones(SUDOKU["neq"]),)
    b1_facts = {}
    for dt, c_ in ((torch.float64, cfg64), (torch.float32, cfg_sud)):
        arrs = tensors(b1_np, dt, dev, N_F64_CARD)
        sol_b1 = qt.solve_qp_full(*arrs, config=dataclasses.replace(
            c_, verbose=-1))
        r_eq = (sol_b1.z @ arrs[4].T - arrs[5]).abs().amax(dim=1)
        z_min = sol_b1.z.amin(dim=1)
        b1_facts[str(dt).split(".")[-1]] = dict(
            iterations=int(sol_b1.stats.iterations),
            best_resids_median=float(sol_b1.stats.best_resids.median()),
            best_resids_min=float(sol_b1.stats.best_resids.min()),
            eq_residual_median=float(r_eq.median()),
            z_min_median=float(z_min.median()))
        print(f"# phase 7 (path 2, b = 1, not gated) {dt} over "
              f"{N_F64_CARD} lanes: iterations "
              f"{int(sol_b1.stats.iterations)}, best_resids min "
              f"{float(sol_b1.stats.best_resids.min()):.3e} median "
              f"{float(sol_b1.stats.best_resids.median()):.3e}, max |A z - "
              f"1| per lane median {float(r_eq.median()):.3e}, min z per "
              f"lane median {float(z_min.median()):.3e}")
    path_facts["path2_sudoku"] = dict(
        iterations=its2, f32_median_rel_err=med2, b_equal_1=b1_facts,
        grad_A_f32_vs_f64=dict(per_lane_median=med_gA, shared_cosine=cos_gA),
        card_vs_cpu=card_vs_cpu("phase 7 (path 2)", sud_np, cfg64, "pAb"))
    del g2, g2_64, per_lane

    # ---- phase 8 (path 3): the direct x recurrence and a warm start ----
    cfg_r1 = qt.SolverConfig(check_Q_spd=False, resid_every=1)
    cfg_cx = qt.SolverConfig(check_Q_spd=False, coeff_x=False)
    sol3, l3, its3 = drive(f"phase 8 (path 3): resid_every=1 f32 B={B}",
                           f32, cfg_r1)
    fused_once_per_step("path 3 resid_every=1", l3, its3, "ipm_step")
    med3 = f32_error("phase 8 (path 3) resid_every=1", sol3.z,
                     (Q, p, G, h), cfg64)
    sol3c, l3c, its3c = drive(f"phase 8 (path 3): coeff_x=False f32 B={B}",
                              f32, cfg_cx)
    fused_once_per_step("path 3 coeff_x=False", l3c, its3c, "ipm_step")
    # Receding-horizon re-solve: p moves a little, the last solution
    # starts the next solve.
    p2 = p + 0.05 * np.random.RandomState(3).randn(B, NZ)
    warm32 = [f32[0], torch.tensor(p2, dtype=torch.float32, device=dev),
              f32[2], f32[3]]
    init = (sol3c.z, sol3c.s, sol3c.lam, None)
    sol3w, l3w, its3w = drive("phase 8 (path 3): warm-started re-solve",
                              warm32, cfg_cx, init=init)
    fused_once_per_step("path 3 warm start", l3w, its3w, "ipm_step")
    sol3k, _, its3k = drive("phase 8 (path 3): the same re-solve, cold",
                            warm32, cfg_cx)
    med3w = f32_error("phase 8 (path 3) warm start", sol3w.z,
                      (Q, p2, G, h), cfg64)
    path_launches["path3_direct_x"] = dict(resid_every_1=l3,
                                           coeff_x_false=l3c, warm=l3w)
    cfg64_r1 = qt.SolverConfig(solve_method="inverse", resid_every=1,
                               eps=1e-9, refine_steps=0, check_Q_spd=False)
    path_facts["path3_direct_x"] = dict(
        iterations=dict(resid_every_1=its3, coeff_x_false=its3c,
                        warm=its3w, cold=its3k),
        f32_median_rel_err=dict(resid_every_1=med3, warm=med3w),
        card_vs_cpu=card_vs_cpu("phase 8 (path 3) resid_every=1, eps=1e-9",
                                (Q, p, G, h), cfg64_r1, "Qp"))

    # ---- phase 9 (path 4): the float64 default (substitution mode) ----
    cfg_d64 = qt.SolverConfig(check_Q_spd=False)
    cfg_d64_e9 = qt.SolverConfig(check_Q_spd=False, eps=1e-9,
                                 refine_steps=0)

    def score_trajectory(arrs_np, device):
        """Per-lane best score after k = 1 .. max_iter scorings of the
        float64 default with both exits off (eps = 0, a window that never
        closes), over N_F64_CPU lanes: (max_iter, N_F64_CPU)."""
        arrs = tensors(arrs_np, torch.float64, device, N_F64_CPU)
        return torch.stack([qt.solve_qp_full(*arrs, config=qt.SolverConfig(
            check_Q_spd=False, eps=0.0, not_improved_lim=10 ** 6,
            max_iter=k, verbose=-1), device=device).stats.best_resids.cpu()
            for k in range(1, cfg_d64.max_iter + 1)])

    def exit_of(traj):
        """(iterations, test that fires) of the default exits replayed on
        a trajectory: the global not-improved window, then max best < eps."""
        n_not = 0
        for k in range(traj.shape[0]):
            improved = k == 0 or bool((traj[k] < traj[k - 1]).any())
            n_not = 0 if improved else n_not + 1
            if n_not >= cfg_d64.not_improved_lim:
                return k + 1, "window"
            if float(traj[k].max()) < cfg_d64.eps:
                return k + 1, "eps"
        return traj.shape[0], "max_iter"

    def exit_diagnosis(tag, arrs_np):
        """Where the card's and the CPU's float64 default part over the
        N_F64_CPU lanes: the best score per iteration on both, the exit
        each trajectory gives, and their agreement above the rounding
        floor (held to 1e-2 relative + 1e-11)."""
        tc, th = (score_trajectory(arrs_np, d_) for d_ in (dev, "cpu"))
        print(f"# {tag}: best score per iteration over {N_F64_CPU} lanes, "
              "exits off: iteration, max (card, CPU), lanes that improved "
              "(card, CPU)")
        for k in range(tc.shape[0]):
            imp = [int((t_[k] < t_[k - 1]).sum()) if k else N_F64_CPU
                   for t_ in (tc, th)]
            print(f"#   {k + 1:2d}  {float(tc[k].max()):.3e} "
                  f"{float(th[k].max()):.3e}  {imp[0]:3d} {imp[1]:3d}")
        gap = (tc - th).abs() - (1e-2 * th + 1e-11)
        exits = dict(card=exit_of(tc), cpu=exit_of(th))
        print(f"# {tag}: replayed exits: card {exits['card']}, CPU "
              f"{exits['cpu']}; worst lane's floor: card "
              f"{float(tc[-1].max()):.3e}, CPU {float(th[-1].max()):.3e} "
              f"(eps {cfg_d64.eps:g})")
        check(bool((gap <= 0).all()), f"{tag}: the card's and the CPU's "
              "score trajectories part above the rounding floor")
        return dict(exits=exits, floor_card=float(tc[-1].max()),
                    floor_cpu=float(th[-1].max()))

    for key, arrs_np in (("path4_f64_default", (Q, p, G, h)),
                         ("path4_f64_default_eq", eq_np)):
        d64 = tensors(arrs_np, torch.float64, dev)
        tag = f"phase 9 ({key}) f64 B={B}"
        sol4, l4, its4 = drive(tag, d64, cfg_d64)
        stepped = l4["inv_solve"]       # one corrector solve per step
        check(stepped in (its4 - 1, its4) and stepped > 0
              and l4["factor_inv_solve"] == stepped + 1
              and not any(l4[k] for k in ("ipm_step", "ipm_step_eq",
                                          "ipm_step_xfree")),
              f"{key}: the composed step did not run kernel A's "
              "factor_solve and inv_solve once per stepped iteration")
        check(float(sol4.stats.best_resids.max()) < 1e-10,
              f"{key}: float64 residuals {sol4.stats.best_resids.max()}")
        kernels.reset_launches()
        _, g4 = grads_of(d64, cfg_d64, dev)
        torch.cuda.synchronize()
        path_launches[key] = dict(forward=l4, forward_backward=dict(
            kernels.LAUNCHES))
        check(all(bool(torch.isfinite(g_).all()) for g_ in g4)
              and kernels.LAUNCHES["inv_solve"] > 0,
              f"{key}: gradients not finite")
        # The default eps = 1e-12 sits at the float64 rounding floor of
        # the worst lane's score at this width, so rounding decides whether
        # max best < eps ever fires: the solutions are held at the default,
        # the iteration counts at eps = 1e-9, and exit_diagnosis shows
        # where the two devices part and that each exit follows from its
        # own trajectory.
        names = "QpGhAb"[:len(arrs_np)]
        facts = dict(
            iterations=its4,
            best_resids_max=float(sol4.stats.best_resids.max()),
            card_vs_cpu=card_vs_cpu(tag, arrs_np, cfg_d64, names,
                                    same_iterations=False),
            card_vs_cpu_eps_1e9=card_vs_cpu(tag + " eps=1e-9", arrs_np,
                                            cfg_d64_e9, names),
            exit=exit_diagnosis(tag, arrs_np))
        for device in (dev, "cpu"):
            its_d = int(qt.solve_qp_full(
                *tensors(arrs_np, torch.float64, device, N_F64_CPU),
                config=cfg_d64, device=device).stats.iterations)
            replay = facts["exit"]["exits"]["cpu" if device == "cpu"
                                            else "card"]
            check(its_d == replay[0], f"{key}: the default solve on "
                  f"{device} took {its_d} iterations, its replayed "
                  f"trajectory {replay}")
        path_facts[key] = facts
        del d64, g4, sol4

    # ---- phase 9b (path 5): the diagonal structured tier ----
    # Path 2's draws with Q and G given by their diagonals: per iteration
    # one (neq x neq) M = A diag(1/H) A^T instead of path 2's (64 x 64) T.
    dg_np = sudoku_diag(B)
    nx, neq5 = SUDOKU["nx"], SUDOKU["neq"]
    cfg5 = qt.SolverConfig()
    cfg5f = qt.SolverConfig(fused_diag_step=True)
    cfg5_64 = qt.SolverConfig()          # the float64 default
    d32 = tensors(dg_np, torch.float32, dev)

    def diag_drive(tag, arrs, config):
        """One solve_qp_diag_full with the counts set to 0 just before and
        read just after (the nonzero ones)."""
        kernels.reset_launches()
        sol_ = qt.solve_qp_diag_full(*arrs, config=config)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        its_ = int(sol_.stats.iterations)
        print(f"# {tag}: iterations {its_}, launches {launches}, "
              f"best_resids max {float(sol_.stats.best_resids.max()):.3e} "
              f"median {float(sol_.stats.best_resids.median()):.3e}")
        for name_ in ("z", "nu", "lam", "s"):
            check(bool(torch.isfinite(getattr(sol_, name_)).all()),
                  f"{tag}: {name_} not finite")
        return sol_, launches, its_

    def diag_grads(arrs, config, device, lane_A=False):
        """z and the gradients of sum(z^2) to all six; ``lane_A`` gives A
        per lane, so its gradient is per lane too."""
        args = [a_.clone() for a_ in arrs]
        if lane_A:
            args[4] = args[4].expand(args[1].shape[0],
                                     *args[4].shape).contiguous()
        args = [a_.requires_grad_(True) for a_ in args]
        z_ = qt.solve_qp_diag(*args, config=config, device=device)
        (z_ * z_).sum().backward()
        return z_.detach(), [a_.grad for a_ in args]

    def fwd_bwd_launches(arrs, config, fwd):
        """Launches of one forward+backward; the backward adds one kernel A
        factor of M and one inv_solve."""
        kernels.reset_launches()
        _, g_ = diag_grads(arrs, config, dev)
        torch.cuda.synchronize()
        fb = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = dict(fwd, factor_inv=fwd.get("factor_inv", 0) + 1,
                    inv_solve=fwd.get("inv_solve", 0) + 1)
        check(fb == want, f"path 5 forward+backward launches {fb}, "
              f"expected {want}")
        return fb, g_

    # (a) the float32 default: kernel A factors M, inv_solve solves on it.
    sol5a, l5a, its5a = diag_drive(
        f"phase 9b (path 5a): diagonal tier f32 default B={B} n={nx} "
        f"neq={neq5}", d32, cfg5)
    steps5 = l5a.get("factor_inv", 0) - 1        # one more at init
    check(steps5 in (its5a - 1, its5a) and steps5 > 0
          and l5a == dict(factor_inv=steps5 + 1, inv_solve=1 + (
              2 + cfg5.n_correctors) * steps5),
          "path 5a: kernel A and inv_solve did not run once per stepping "
          "iteration (and at init)")
    med5 = f32_error("phase 9b (path 5a)", sol5a.z, dg_np, cfg5_64,
                     solve=qt.solve_qp_diag_full)
    l5a_fb, g5 = fwd_bwd_launches(d32, cfg5, l5a)
    check(tuple(g5[4].shape) == (neq5, nx), "path 5a: gradient to A shape")

    # Lanes whose gradient to A is NaN, A given per lane, by backward
    # clamp: the diagonal tier against the dense tier (path 2's solver).
    def nan_lanes(solve, arrs, config):
        """The lanes whose gradient to A (given per lane) has a NaN."""
        args = [a_.clone() for a_ in arrs]
        args[4] = args[4].expand(B, *args[4].shape).contiguous()
        args[4].requires_grad_(True)
        z_ = solve(*args, config=config, device=dev)
        (z_ * z_).sum().backward()
        return torch.nonzero(torch.isnan(args[4].grad).flatten(1).any(1)
                             ).flatten().tolist()

    nan5 = {f"{c_:g}": nan_lanes(qt.solve_qp_diag, d32,
                                 qt.SolverConfig(grad_clamp=c_))
            for c_ in (1e-8, 1e-7, 1e-6, 1e-5)}
    nan_dense = len(nan_lanes(qt.solve_qp, sud32,
                              qt.SolverConfig(check_Q_spd=False)))
    print(f"# phase 9b (path 5a): lanes of {B} with a NaN gradient to A, "
          f"by grad_clamp: diagonal tier {nan5}; dense tier (path 2) at "
          f"1e-8: {nan_dense} lanes; the shared A's gradient at the default "
          f"clamp is finite: {bool(torch.isfinite(g5[4]).all())}")
    nan5 = {k: len(v) for k, v in nan5.items()}
    check(nan5[f"{GRAD_CLAMP5:g}"] == 0, f"path 5a: NaN gradients to A at "
          f"grad_clamp {GRAD_CLAMP5:g}")
    # How good the float32 gradient is at that clamp: per lane over
    # N_F64_CARD lanes and for the shared A over all lanes, against f64.
    cfg5c = qt.SolverConfig(grad_clamp=GRAD_CLAMP5)
    per_lane5 = [diag_grads(tensors(dg_np, dt, dev, N_F64_CARD), cfg5c, dev,
                            lane_A=True)[1][4].double().flatten(1)
                 for dt in (torch.float32, torch.float64)]
    lane_err5 = ((per_lane5[0] - per_lane5[1]).norm(dim=1)
                 / per_lane5[1].norm(dim=1).clamp_min(1e-300))
    med_gA5 = float(lane_err5.median())
    gA32 = diag_grads(d32, cfg5c, dev)[1][4].double().flatten()
    gA64 = diag_grads(tensors(dg_np, torch.float64, dev), cfg5c,
                      dev)[1][4].flatten()
    cos_gA5 = float(torch.nn.functional.cosine_similarity(gA32, gA64, dim=0))
    print(f"# phase 9b (path 5a): gradient to A, f32 vs f64 on the card "
          f"(grad_clamp {GRAD_CLAMP5:g}): per lane over {N_F64_CARD} lanes "
          f"median rel err {med_gA5:.3e}, 90th percentile "
          f"{float(lane_err5.quantile(0.9)):.3e}; shared A over all {B} "
          f"lanes: cosine {cos_gA5:.4f}")
    check(med_gA5 <= 5e-2 and cos_gA5 >= 0.9, f"path 5a: f32 gradient to "
          f"A (per-lane median {med_gA5:.3e}, cosine {cos_gA5:.4f})")
    del per_lane5, gA32, gA64

    # (b) the fused step: one diag_step per stepping iteration.
    sol5b, l5b, its5b = diag_drive(
        f"phase 9b (path 5b): fused diag_step f32 B={B}", d32, cfg5f)
    steps5b = l5b.get("diag_step", 0)
    check(steps5b in (its5b - 1, its5b) and steps5b > 0
          and l5b == dict(factor_inv=1, inv_solve=1, diag_step=steps5b),
          "path 5b: diag_step did not run once per stepping iteration")
    l5b_fb, _ = fwd_bwd_launches(d32, cfg5f, l5b)

    # Float64 on all B lanes, where rounding does not decide the duals: the
    # fused step against the composed one, every lane, z, lam and nu.
    d64 = tensors(dg_np, torch.float64, dev)
    sol5_64 = qt.solve_qp_diag_full(*d64, config=cfg5_64)
    sol5_64f = qt.solve_qp_diag_full(*d64, config=qt.SolverConfig(
        fused_diag_step=True))

    def lane_rel(a_, b_):
        """Per lane max |a - b| / max |b|."""
        return ((a_.double() - b_.double()).abs().amax(-1)
                / b_.double().abs().amax(-1).clamp_min(1e-300))

    e64 = {k: float(lane_rel(getattr(sol5_64f, k), getattr(sol5_64, k)).max())
           for k in ("z", "lam", "nu")}
    its64 = (int(sol5_64f.stats.iterations), int(sol5_64.stats.iterations))
    print(f"# phase 9b (path 5b): f64 fused vs composed on all {B} lanes: "
          f"per-lane relative error max " + ", ".join(
              f"{k} {v:.3e}" for k, v in e64.items())
          + f"; iterations {its64[0]} / {its64[1]}")
    check(max(e64.values()) <= 1e-7 and its64[0] == its64[1],
          "path 5b: f64 fused step against the composed one")

    # Every float32 launch of (b) replayed: the kernel's step and its plain
    # version's, on the card from the same inputs, each against the step in
    # float64. The run is (b) again with the launches recorded.
    steps = []
    launch = kernels.diag_step

    def recorded(*args):
        out = launch(*args)
        steps.append((args, out))
        return out

    kernels.diag_step = recorded
    try:
        sol_rec = qt.solve_qp_diag_full(*d32, config=cfg5f)
    finally:
        kernels.diag_step = launch
    check(torch.equal(sol_rec.lam, sol5b.lam), "path 5b: the recorded run "
          "is not (b)'s")

    def step_err(out, ref):
        return torch.stack([(o_.double() - r_).abs().amax(-1)
                            / r_.abs().amax(-1).clamp_min(1e-30)
                            for o_, r_ in zip(out, ref)]).amax(0)

    e_k, e_p, e_kp = [], [], []
    for args, out in steps:
        ref = kernels.diag_step_plain(*[a_.double() if torch.is_tensor(a_)
                                        else a_ for a_ in args])
        plain = kernels.diag_step_plain(*args)
        e_k.append(step_err(out, ref))
        e_p.append(step_err(plain, ref))
        e_kp.append(step_err(out, [v.double() for v in plain]))
    e_k, e_p, e_kp = (torch.stack(v).flatten() for v in (e_k, e_p, e_kp))
    qs = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=dev)
    q_k, q_p = e_k.quantile(qs).tolist(), e_p.quantile(qs).tolist()
    worse = float((e_k > e_p).double().mean())
    del steps, sol_rec
    print(f"# phase 9b (path 5b): {len(e_k) // B} f32 launches x {B} lanes "
          f"replayed: step error against float64 (per lane, relative) "
          f"kernel q50/q90/q99 " + "/".join(f"{v:.3e}" for v in q_k)
          + ", plain " + "/".join(f"{v:.3e}" for v in q_p)
          + f"; kernel worse than plain on {worse:.3f} of (step, lane); "
          f"kernel vs plain max {float(e_kp.max()):.3e}")
    check(all(a_ <= 2 * b_ + 1e-7 for a_, b_ in zip(q_k, q_p)),
          "path 5b: the kernel's float32 steps are less accurate than its "
          "plain version's")

    # Float32 agreement with (a) at the reference's fused-vs-composed
    # tolerance: z on every lane, lam and nu on all but DUAL_LANES_OFF.
    # Beside it the witness: the composed step against itself with A given
    # per lane (other products) and with p moved by one ulp.
    def excess(a_, b_):
        """Per lane: how far |a - b| exceeds 2e-4 + 1e-3 |b| (<= 0: within
        the tolerance)."""
        return ((a_.double() - b_.double()).abs()
                - (2e-4 + 1e-3 * b_.double().abs())).amax(dim=-1).cpu()

    def parted(sol_, ref_):
        return {k: torch.nonzero(excess(getattr(sol_, k), getattr(ref_, k))
                                 > 0).flatten().tolist()
                for k in ("z", "lam", "nu")}

    lane_A = list(d32)
    lane_A[4] = d32[4].expand(B, neq5, nx).contiguous()
    sol_lane = qt.solve_qp_diag_full(*lane_A, config=cfg5)
    ulp = list(d32)
    ulp[1] = d32[1] * (1 + 2.0 ** -23)
    off = parted(sol5b, sol5a)
    wit = {"A per lane": parted(sol_lane, sol5a),
           "p one ulp": parted(qt.solve_qp_diag_full(*ulp, config=cfg5),
                               sol5a)}
    print(f"# phase 9b (path 5b): fused vs composed: iterations {its5b} / "
          f"{its5a}; max abs diff z "
          f"{float((sol5b.z - sol5a.z).abs().max()):.3e}; lanes beyond "
          f"atol 2e-4 rtol 1e-3: {off}; the composed step against itself "
          f"(witness): " + "; ".join(f"{k}: {v}" for k, v in wit.items()))
    for k in ("lam", "nu"):
        for i in off[k][:10]:
            ref = getattr(sol5_64, k)[i]
            print(f"#   {k} lane {i}: |fused - composed| "
                  f"{float((getattr(sol5b, k)[i] - getattr(sol5a, k)[i]).abs().max()):.3e}, "
                  f"|composed - f64| "
                  f"{float((getattr(sol5a, k)[i].double() - ref).abs().max()):.3e}, "
                  f"|fused - f64| "
                  f"{float((getattr(sol5b, k)[i].double() - ref).abs().max()):.3e}")
    off = {k: len(v) for k, v in off.items()}
    wit = {k: {kk: len(vv) for kk, vv in v.items()} for k, v in wit.items()}
    check(off["z"] == 0 and off["lam"] <= DUAL_LANES_OFF
          and off["nu"] <= DUAL_LANES_OFF,
          "path 5b: the fused step disagrees with the composed one")
    del d64, lane_A, ulp

    # (c) float64, card against CPU, composed and fused; and the diagonal
    # tier against the dense tier (path 2's solver) on the same draws.
    def diag_card_vs_cpu(tag, config):
        out = {}
        for device in (dev, "cpu"):
            arrs = tensors(dg_np, torch.float64, device, N_F64_CPU)
            out[device] = (qt.solve_qp_diag_full(*arrs, config=config,
                                                 device=device),
                           diag_grads(arrs, config, device)[1])
        (sc_, gc_), (sh_, gh_) = out[dev], out["cpu"]
        ez, enu = rel(sc_.z.cpu(), sh_.z), rel(sc_.nu.cpu(), sh_.nu)
        eg = {nm: rel(gc_[i].cpu(), gh_[i]) for i, nm in enumerate("qpghAb")}
        its_ = (int(sc_.stats.iterations), int(sh_.stats.iterations))
        print(f"# {tag}: f64 card vs CPU over {N_F64_CPU} lanes: z {ez:.3e}, "
              f"nu {enu:.3e}, gradients "
              + ", ".join(f"{nm} {e:.3e}" for nm, e in eg.items())
              + f"; iterations {its_[0]} / {its_[1]}")
        check(ez <= 1e-8 and enu <= 1e-8 and max(eg.values()) <= 1e-7
              and its_[0] == its_[1], f"{tag}: f64 card vs CPU")
        return dict(z=ez, nu=enu, grads=eg, iterations=its_[0])

    cvc5 = {k: diag_card_vs_cpu(f"phase 9b (path 5c) {k}, eps=1e-9",
                                qt.SolverConfig(eps=1e-9,
                                                fused_diag_step=f_))
            for k, f_ in (("composed", False), ("fused", True))}
    sol_dense = qt.solve_qp_full(*tensors(sud_np, torch.float64, dev,
                                          N_F64_CPU),
                                 config=qt.SolverConfig(check_Q_spd=False))
    sol_diag = qt.solve_qp_diag_full(*tensors(dg_np, torch.float64, dev,
                                              N_F64_CPU), config=cfg5_64)
    e_dd = {k: rel(getattr(sol_diag, k), getattr(sol_dense, k))
            for k in ("z", "nu")}
    print(f"# phase 9b (path 5c): f64 diagonal vs dense tier on the card "
          f"over {N_F64_CPU} lanes: z {e_dd['z']:.3e}, nu {e_dd['nu']:.3e}; "
          f"iterations {int(sol_diag.stats.iterations)} / "
          f"{int(sol_dense.stats.iterations)}")
    check(e_dd["z"] <= 1e-7, "path 5c: diagonal vs dense tier")

    # (d) SpQPFunction on the sudoku layer's COO patterns. The values give
    # A per lane, so it runs the tier with a batched A: gated bit for bit
    # against the solve of (a)'s data with A expanded per lane, and by its
    # float32 error against float64 as (a) is. Its distance to (a)'s
    # shared-A solve (other products, other rounding) is printed.
    ii = np.stack([np.arange(nx)] * 2)
    sp = qt.SpQPFunction(ii, (nx, nx), ii, (nx, nx),
                         np.stack(np.nonzero(np.ones((neq5, nx)))),
                         (neq5, nx))
    check(sp.structure == "diag", f"path 5d: structure {sp.structure}")
    q_, p_, g_, h_, A_, b_ = dg_np
    sp_vals = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        np.tile(q_, (B, 1)), p_, np.tile(g_, (B, 1)), np.tile(h_, (B, 1)),
        np.tile(A_.ravel(), (B, 1)), np.tile(b_, (B, 1)))]
    kernels.reset_launches()
    sol5d = sp.solve_full(*sp_vals)
    torch.cuda.synchronize()
    l5d = {k: v for k, v in kernels.LAUNCHES.items() if v}
    z_call = sp(*sp_vals)
    ex5d = excess(sol5d.z, sol5a.z)
    med5d = f32_error("phase 9b (path 5d)", sol5d.z, dg_np, cfg5_64,
                      solve=qt.solve_qp_diag_full)
    print(f"# phase 9b (path 5d): SpQPFunction structure {sp.structure}: "
          f"iterations {int(sol5d.stats.iterations)}, launches {l5d}; z vs "
          f"the tier with A per lane: max abs diff "
          f"{float((sol5d.z - sol_lane.z).abs().max()):.3e}; vs (a): max "
          f"abs diff {float((sol5d.z - sol5a.z).abs().max()):.3e}, lanes "
          f"beyond atol 2e-4 rtol 1e-3 (not gated): {int((ex5d > 0).sum())}")
    check(bool(torch.equal(sol5d.z, sol_lane.z))
          and bool(torch.equal(z_call, sol5d.z))
          and l5d == l5a, "path 5d: SpQPFunction did not run the diagonal "
          "tier")
    del sp_vals, sol_lane, z_call

    # (e) nn.OptNetSudoku at its defaults, one forward and backward. Its
    # b = 1 is infeasible for a random A: the solver returns its least-bad
    # iterate, whose score is printed, and the float32 backward leaves NaN
    # on the lanes where the duals ran away (counted, A given per lane, and
    # printed). Gated: it runs through kernels A and 5, its output is
    # finite, and in float64 the card matches the CPU, gradient included.
    layer = qt.nn.OptNetSudoku(generator=torch.Generator(
        device=dev).manual_seed(0))
    puzzles = (-d32[1]).reshape(B, 4, 4, 4)
    kernels.reset_launches()
    out5 = layer(puzzles)
    ((out5 - puzzles) ** 2).mean().backward()
    torch.cuda.synchronize()
    l5e = {k: v for k, v in kernels.LAUNCHES.items() if v}
    layer_qp = (d32[0], -puzzles.reshape(B, -1), d32[2], d32[3],
                layer.A.detach(), torch.ones(neq5, device=dev))
    score = qt.solve_qp_diag_full(*layer_qp,
                                  config=layer.qp_config).stats.best_resids
    nan_layer = len(nan_lanes(qt.solve_qp_diag, layer_qp, layer.qp_config))
    layer_match = []
    for device in (dev, "cpu"):
        m64 = qt.nn.OptNetSudoku(device=device, dtype=torch.float64)
        with torch.no_grad():
            m64.A.copy_(layer.A.detach().double().to(device))
        pz = puzzles[:N_F64_CPU].double().to(device)
        o_ = m64(pz)
        ((o_ - pz) ** 2).mean().backward()
        layer_match.append((o_.detach().cpu(), m64.A.grad.cpu()))
    e_layer = (rel(layer_match[0][0], layer_match[1][0]),
               rel(layer_match[0][1], layer_match[1][1]))
    print(f"# phase 9b (path 5e): nn.OptNetSudoku() f32 B={B}: launches "
          f"{l5e}, output finite {bool(torch.isfinite(out5).all())}, A.grad "
          f"finite {bool(torch.isfinite(layer.A.grad).all())} (not gated: "
          f"{nan_layer} of {B} lanes give NaN with A per lane)"
          f"; best score (not gated) min {float(score.min()):.3e} median "
          f"{float(score.median()):.3e} max {float(score.max()):.3e}; f64 "
          f"card vs CPU over {N_F64_CPU} lanes: output {e_layer[0]:.3e}, "
          f"A.grad {e_layer[1]:.3e}")
    check(l5e.get("factor_inv", 0) > 0 and l5e.get("inv_solve", 0) > 0
          and bool(torch.isfinite(out5).all()),
          "path 5e: the layer did not run through kernels A and inv_solve "
          "to a finite output")
    check(e_layer[0] <= 1e-8 and e_layer[1] <= 1e-7,
          "path 5e: the layer's f64 card run against its CPU run")
    path_launches["path5_diag"] = dict(
        a_forward=l5a, a_forward_backward=l5a_fb, b_forward=l5b,
        b_forward_backward=l5b_fb, spqp_forward=l5d, layer=l5e)
    path_facts["path5_diag"] = dict(
        iterations=dict(a=its5a, b=its5b),
        f32_median_rel_err=dict(a=med5, spqp=med5d),
        nan_grad_A_lanes=dict(diag=nan5, dense_1e8=nan_dense),
        grad_A_f32_vs_f64=dict(grad_clamp=GRAD_CLAMP5,
                               per_lane_median=med_gA5,
                               shared_cosine=cos_gA5),
        fused_vs_composed_lanes_beyond=off, composed_vs_itself_lanes=wit,
        fused_vs_composed_f64_all_lanes=e64,
        step_replay=dict(kernel_q=q_k, plain_q=q_p, kernel_worse=worse),
        card_vs_cpu=cvc5, diag_vs_dense=e_dd,
        layer=dict(score_median=float(score.median()),
                   nan_grad_A_lanes=nan_layer,
                   grad_A_finite=bool(torch.isfinite(layer.A.grad).all()),
                   card_vs_cpu_f64=e_layer))
    del sol5_64, sol5_64f, layer, out5, score

    # ---- phase 9c (path 6): the Cholesky-factor backend, "blocked" ----
    # T's factor by kernel C with its first solve, every further solve on
    # it by kernel D; in substitution mode also the factors of Q and S11 by
    # kernel C and their solves by kernel D. No fused step.
    cfg6 = qt.SolverConfig(check_Q_spd=False, use_pallas="blocked")
    cfg6s = dataclasses.replace(cfg6, solve_method="subst")
    cfg6_e9 = dataclasses.replace(cfg6, eps=1e-9, refine_steps=0)
    kernel_a = ("factor_inv", "factor_inv_solve", "factor_inv_solve_rz")
    fused = ("ipm_step", "ipm_step_eq", "ipm_step_xfree", "inv_solve")

    def blocked_counts(tag, launches, its_, n_factor_inv, n_chol, solves,
                       init_solves=0, t_solves=None):
        """Kernel C with rhs once per scored iteration (the init's, then
        one per stepped iteration), kernel D ``init_solves`` times in the
        init and ``solves`` times per stepped iteration, ``n_chol`` plain
        factors (Q, S11), ``n_factor_inv`` kernel A launches, no fused
        step. With ``t_solves`` (T's solves per stepped iteration, on
        per-lane factors) every other kernel D launch ran on a shared
        factor; without it none did."""
        stepped = launches["chol_solve"] - 1
        n_shared = (launches["cho_solve"] - t_solves * stepped
                    if t_solves is not None else 0)
        check(stepped in (its_ - 1, its_) and stepped > 0
              and launches["cho_solve"] == init_solves + solves * stepped
              and launches["cho_solve_shared"] == n_shared
              and (t_solves is None or n_shared > 0)
              and launches["chol"] == n_chol
              and sum(launches[k] for k in kernel_a) == n_factor_inv
              and not any(launches[k] for k in fused),
              f"{tag}: launches {launches} are not the blocked path's "
              f"({its_} iterations)")
        return stepped

    # (a) float32 inverse mode on the bench workload: kernel A once for
    # Q^-1, then kernel C with rhs and kernel D per iteration.
    sol6, l6, its6 = drive(f"phase 9c (path 6a): blocked f32 B={B}", f32,
                           cfg6)
    blocked_counts("path 6a", l6, its6, 1, 0, 1 + cfg6.n_correctors)
    med6 = f32_error("phase 9c (path 6a)", sol6.z, (Q, p, G, h), cfg64)
    kernels.reset_launches()
    _, g6 = grads_of(f32, cfg6, dev)
    torch.cuda.synchronize()
    l6_fb = dict(kernels.LAUNCHES)
    print(f"# phase 9c (path 6a): forward+backward launches "
          f"{ {k: v for k, v in l6_fb.items() if v} }")
    check(all(bool(torch.isfinite(g_).all()) for g_ in g6)
          and l6_fb["chol_solve"] == l6["chol_solve"] + 1
          and l6_fb["cho_solve"] == l6["cho_solve"],
          "path 6a: the backward did not run one kernel C with rhs to "
          "finite gradients")
    sol6o, l6o, its6o = drive(f"phase 9c (path 6a): blocked OptNet pattern "
                              f"f32 B={B}", sh32, cfg6)
    blocked_counts("path 6a OptNet", l6o, its6o, 1, 0,
                   1 + cfg6.n_correctors)
    med6o = f32_error("phase 9c (path 6a OptNet)", sol6o.z, shared, cfg64)
    del g6, sol6o

    # (b) float32 substitution mode on path 1's data: every T, Q and S11
    # solve in kernel D, the factors of Q and S11 in kernel C; kernel A
    # never runs.
    sol6b, l6b, its6b = drive(f"phase 9c (path 6b): blocked subst f32 "
                              f"B={B} neq={NEQ}", eq32, cfg6s)
    # Per stepped iteration: Q and S11 before T's solve, Q after it, then
    # T and Q for the corrector (and each Gondzio correction); the init's
    # solve has the first three.
    blocked_counts("path 6b", l6b, its6b, 0, 2,
                   3 + 2 * (1 + cfg6s.n_correctors), 3)
    med6b = f32_error("phase 9c (path 6b, not gated)", sol6b.z, eq_np,
                      cfg64, limit=None)
    kernels.reset_launches()
    _, g6b = grads_of(eq32, cfg6s, dev)
    torch.cuda.synchronize()
    l6b_fb = dict(kernels.LAUNCHES)
    print(f"# phase 9c (path 6b): forward+backward launches "
          f"{ {k: v for k, v in l6b_fb.items() if v} }")
    check(not any(l6b_fb[k] for k in kernel_a)
          and all(bool(torch.isfinite(g_).all()) for g_ in g6b),
          "path 6b: kernel A ran, or the gradients are not finite")
    del g6b, sol6b

    # (c) float64 (substitution mode by default) on the bench data and on
    # path 1's: card against CPU, and against the port's own float64
    # default on the card (kernel A and kernel 5) at eps = 1e-9.
    cvc6, def6, l6c = {}, {}, {}
    for key, arrs_np in (("bench", (Q, p, G, h)), ("eq", eq_np)):
        d64 = tensors(arrs_np, torch.float64, dev)
        tag = f"phase 9c (path 6c, {key}) f64 B={B}"
        sol_b, l_, its_b = drive(tag + " blocked, eps=1e-9", d64, cfg6_e9)
        n_fac = 2 if key == "eq" else 1          # Q (and S11)
        blocked_counts(f"path 6c {key}", l_, its_b, 0, n_fac,
                       n_fac + 1 + 2 * (1 + cfg6_e9.n_correctors), n_fac + 1)
        sol_d, _, its_d = drive(tag + " default (kernel A + kernel 5), "
                                "eps=1e-9", d64, cfg_d64_e9)
        e_d = rel(sol_b.z, sol_d.z)
        print(f"# {tag}: blocked against the default on the card: z "
              f"{e_d:.3e}, iterations {its_b} / {its_d}")
        check(e_d <= 1e-9 and its_b == its_d,
              f"path 6c {key}: blocked and default f64 part")
        kernels.reset_launches()
        _, g_ = grads_of(d64, cfg6, dev)
        torch.cuda.synchronize()
        l6c[key] = dict(forward=l_, forward_backward=dict(kernels.LAUNCHES))
        check(all(bool(torch.isfinite(x_).all()) for x_ in g_),
              f"path 6c {key}: gradients not finite")
        cvc6[key] = card_vs_cpu(tag + " eps=1e-9", arrs_np, cfg6_e9,
                                "QpGhAb"[:len(arrs_np)])
        def6[key] = dict(z=e_d, iterations=(its_b, its_d))
        del d64, sol_b, sol_d, g_

    # (d) the OptNet pattern (phase 5's data: shared Q and G, batched p and
    # h) in substitution mode: T's solves on per-lane factors, every Q
    # solve on the one shared L_Q (kernel D's shared-factor kernel). Float32
    # with solve_method="subst", forward and forward+backward, and float64
    # at its default (substitution mode).
    nc6 = cfg6s.n_correctors
    sol6d, l6d, its6d = drive(f"phase 9c (path 6d): blocked subst OptNet "
                              f"pattern f32 B={B}", sh32, cfg6s)
    # Per stepped iteration: Q before and after the predictor's fused
    # factor and solve, then T and Q for the corrector (and each Gondzio
    # correction); the init's solve has Q twice.
    blocked_counts("path 6d", l6d, its6d, 0, 1, 2 + 2 * (1 + nc6), 2,
                   t_solves=1 + nc6)
    med6d = f32_error("phase 9c (path 6d)", sol6d.z, shared, cfg64)
    kernels.reset_launches()
    _, g6d = grads_of(sh32, cfg6s, dev)
    torch.cuda.synchronize()
    l6d_fb = dict(kernels.LAUNCHES)
    print(f"# phase 9c (path 6d): forward+backward launches "
          f"{ {k: v for k, v in l6d_fb.items() if v} }")
    check(not any(l6d_fb[k] for k in kernel_a)
          and l6d_fb["cho_solve_shared"] > l6d["cho_solve_shared"]
          and all(bool(torch.isfinite(g_).all()) for g_ in g6d),
          "path 6d: kernel A ran, the backward solved on no shared factor, "
          "or the gradients are not finite")
    sh64d = tensors(shared, torch.float64, dev)
    tag6d = f"phase 9c (path 6d) f64 B={B}"
    sol6d64, l6d64, its6d64 = drive(tag6d + " blocked default", sh64d, cfg6)
    blocked_counts("path 6d f64", l6d64, its6d64, 0, 1,
                   2 + 2 * (1 + cfg6.n_correctors), 2,
                   t_solves=1 + cfg6.n_correctors)
    kernels.reset_launches()
    _, g_ = grads_of(sh64d, cfg6, dev)
    torch.cuda.synchronize()
    l6d64_fb = dict(kernels.LAUNCHES)
    check(all(bool(torch.isfinite(x_).all()) for x_ in g_),
          "path 6d f64: gradients not finite")
    # Card against CPU at eps = 1e-9, as (c): at the default eps = 1e-12 the
    # exits sit at the score's rounding floor (ROADMAP §3).
    cvc6d = card_vs_cpu(tag6d + " eps=1e-9", shared, cfg6_e9, "QpGh")
    del g6d, g_, sol6d64, sh64d

    path_launches["path6_blocked"] = dict(
        a_forward=l6, a_forward_backward=l6_fb, a_optnet_forward=l6o,
        b_forward=l6b, b_forward_backward=l6b_fb, c=l6c,
        d_forward=l6d, d_forward_backward=l6d_fb,
        d_f64_forward=l6d64, d_f64_forward_backward=l6d64_fb)
    path_facts["path6_blocked"] = dict(
        iterations=dict(a=its6, a_optnet=its6o, b=its6b, d=its6d,
                        d_f64=its6d64),
        f32_median_rel_err=dict(a=med6, a_optnet=med6o, b_not_gated=med6b,
                                d=med6d),
        card_vs_cpu=dict(cvc6, optnet=cvc6d), against_f64_default=def6)

    # ---- phase 9d (path 7): refinement, escalation, the CPU oracle ----
    # Refinement steps: the port's _refine returns the number it took, and
    # the solve discards it; a wrapper records it.
    from qpth_tpu_torch.core import pdipm as port_pdipm

    refine_steps = []
    refine_orig = port_pdipm._refine

    def refine_counted(*args, **kw):
        out = refine_orig(*args, **kw)
        refine_steps.append(out[3])
        return out

    port_pdipm._refine = refine_counted

    def lane_rel(a, b):
        """Per-lane relative error ||a - b|| / ||b|| over rows (flattened
        beyond the batch dim)."""
        a, b = a.double().flatten(1), b.double().flatten(1)
        return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-300)

    def quantiles(e):
        return dict(median=float(e.median()), p90=float(e.quantile(0.9)),
                    max=float(e.max()))

    cfg7 = qt.SolverConfig(check_Q_spd=False, eps=1e-8)
    cfg7c = dataclasses.replace(cfg7, use_pallas="blocked")
    # The yardstick: the card's float64 solve of the float32-rounded data,
    # from the IPM loop alone (refine_steps=0: eps = 1e-9 would engage the
    # dial, the code under test).
    cfg7_64 = qt.SolverConfig(check_Q_spd=False, eps=1e-9, refine_steps=0)

    def refined_case(tag, arrs32, config, base_sol, base_config):
        """Path 7 (a)-(c): one refined forward and one forward+backward
        through the entry points, counts and refinement steps read; gates:
        float64 outputs; under the dial (12 steps, early exit) the median
        per-lane z error <= 1e-8 against the yardstick and >= 100x below
        the unrefined solve's, and the p90 >= 10x below the unrefined
        p90; with the same budget and no early exit (refine_steps=12) the
        median and the p90 <= 1e-8; float32 gradients, finite on every
        lane the refined forward converged (score <= 1e-6) and on all but
        B/200 lanes, within the f32 gradient gate (median per-lane error
        against float64 <= 5e-2), printed beside the unrefined forward's.
        The dial's p90 is not held to 1e-8 and its max is printed: its
        early exit stops once a step does not halve the batch's max score,
        so the slowest lanes (at the float32 plateau the loop can keep an
        iterate 1e-4 off) stop the steps for all. The JAX package on the
        kernel path that the port mirrors does the same at this width: 2
        steps, p90 9.6e-6, 42x below its unrefined p90, on the CPU
        (benchmarks/refine_witness.py; ROADMAP.md §3)."""
        refine_steps.clear()
        sol_r, l_r, its_r = drive(f"{tag} forward, eps=1e-8", arrs32, config)
        steps_r = refine_steps[-1]
        check(all(getattr(sol_r, k).dtype == torch.float64
                  for k in ("z", "nu", "lam", "s"))
              and sol_r.stats.best_resids.dtype == torch.float64,
              f"{tag}: the refined outputs are not float64")
        y64 = qt.solve_qp_full(*[a.double() for a in arrs32],
                               config=cfg7_64)
        print(f"# {tag}: yardstick (float64, refine_steps=0) iterations "
              f"{int(y64.stats.iterations)}, score max "
              f"{float(y64.stats.best_resids.max()):.3e} median "
              f"{float(y64.stats.best_resids.median()):.3e}")
        e_r = quantiles(lane_rel(sol_r.z, y64.z))
        e_b = quantiles(lane_rel(base_sol.z, y64.z))
        refine_steps.clear()
        sol_f = qt.solve_qp_full(*arrs32, config=dataclasses.replace(
            config, refine_steps=12))
        e_f = quantiles(lane_rel(sol_f.z, y64.z))
        del sol_f
        sc = {k: dict(max=float(s_.stats.best_resids.max()),
                      median=float(s_.stats.best_resids.median()))
              for k, s_ in (("unrefined", base_sol), ("refined", sol_r))}
        print(f"# {tag}: refinement steps {steps_r}; score max / median "
              f"unrefined {sc['unrefined']['max']:.3e} / "
              f"{sc['unrefined']['median']:.3e}, refined "
              f"{sc['refined']['max']:.3e} / {sc['refined']['median']:.3e}; "
              f"per-lane z error against the f64 solve of the f32-rounded "
              f"data over {B} lanes: refined median {e_r['median']:.3e} p90 "
              f"{e_r['p90']:.3e} max {e_r['max']:.3e} (max not gated), "
              f"refine_steps=12 (no early exit) median {e_f['median']:.3e} "
              f"p90 {e_f['p90']:.3e} max {e_f['max']:.3e} (max not gated), "
              f"unrefined median {e_b['median']:.3e} p90 {e_b['p90']:.3e}")
        check(e_r["median"] <= 1e-8,
              f"{tag}: refined z error median {e_r['median']:.3e} > 1e-8")
        check(e_f["median"] <= 1e-8 and e_f["p90"] <= 1e-8,
              f"{tag}: refine_steps=12 z error median {e_f['median']:.3e} / "
              f"p90 {e_f['p90']:.3e} > 1e-8")
        check(e_b["median"] >= 100.0 * e_r["median"],
              f"{tag}: refinement gained less than 100x")
        check(e_b["p90"] >= 10.0 * e_r["p90"],
              f"{tag}: the dial's p90 gained less than 10x")
        kernels.reset_launches()
        _, g_r = grads_of(arrs32, config, dev)
        torch.cuda.synchronize()
        l_fb = dict(kernels.LAUNCHES)
        print(f"# {tag}: forward+backward launches "
              f"{ {k: v for k, v in l_fb.items() if v} }")
        # Every parameter is batched here: a lane's gradient is its own. A
        # lane the forward left unconverged (path 1's float32 limit: a few
        # lanes' loop ends at a score of 0.1-0.5, and the early exit leaves
        # others mid-way with a negative slack) may give a non-finite one.
        lane_bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for g_ in g_r:
            lane_bad |= ~torch.isfinite(g_).flatten(1).all(dim=1)
        conv = sol_r.stats.best_resids <= 1e-6
        n_bad = int(lane_bad.sum())
        # Refinement takes full steps (no fraction-to-boundary rule, as in
        # the JAX package): a lane whose float32 start has the wrong active
        # set can end with negative slacks that its score, |sum(s lam)|,
        # does not see (benchmarks/refine_witness.py).
        min_s = sol_r.s.min(dim=1).values
        neg = min_s < -1e-6
        print(f"# {tag}: lanes with a non-finite gradient {n_bad} "
              f"{torch.nonzero(lane_bad).flatten()[:8].tolist()} (refined "
              f"scores {sol_r.stats.best_resids[lane_bad][:8].tolist()}, "
              f"smallest slacks {min_s[lane_bad][:8].tolist()}); lanes "
              f"converged (score <= 1e-6) {int(conv.sum())} of {B}; lanes "
              f"with a slack below -1e-6 {int(neg.sum())}")
        check(all(g_.dtype == torch.float32 for g_ in g_r)
              and not bool((lane_bad & conv).any())
              and n_bad <= DUAL_LANES_OFF,
              f"{tag}: gradients not float32, or not finite on a converged "
              f"lane, or on more than {DUAL_LANES_OFF} lanes")
        _, g_b = grads_of(arrs32, base_config, dev)
        n = N_F64_CARD
        _, g_64 = grads_of([a[:n].double() for a in arrs32], cfg64, dev)
        ge = {}
        for k, g_ in (("refined", g_r), ("unrefined", g_b)):
            ge[k] = {nm: float(lane_rel(g_[i][:n], g_64[i]).nanmedian())
                     for i, nm in enumerate("QpGhAb"[:len(g_)])}
        print(f"# {tag}: gradients, per-lane median rel err against f64 "
              f"over {n} lanes: refined forward "
              + ", ".join(f"{k} {v:.3e}" for k, v in ge["refined"].items())
              + "; unrefined forward "
              + ", ".join(f"{k} {v:.3e}" for k, v in ge["unrefined"].items()))
        check(all(v <= 5e-2 for v in ge["refined"].values()),
              f"{tag}: f32 gradients after the refined forward")
        return dict(iterations=its_r, refine_steps=steps_r, scores=sc,
                    z_err=e_r, z_err_fixed12=e_f, z_err_unrefined=e_b,
                    grad_err=ge, grad_nonfinite_lanes=n_bad), \
            dict(forward=l_r, forward_backward=l_fb)

    facts7, launches7 = {}, {}
    # (a) the bench workload, "auto": kernel A with rhs once per step.
    facts7["a"], launches7["a"] = refined_case(
        "phase 9d (path 7a): bench workload f32", f32, cfg7, sol, cfg)
    check(launches7["a"]["forward"]["factor_inv_solve"]
          == facts7["a"]["refine_steps"] > 0,
          "path 7a: kernel A with rhs did not run once per refinement step")
    # (b) path 1's equality data.
    facts7["b"], launches7["b"] = refined_case(
        "phase 9d (path 7b): path 1's data f32", eq32, cfg7, sol1, cfg)
    check(launches7["b"]["forward"]["factor_inv_solve"]
          == facts7["b"]["refine_steps"] > 0,
          "path 7b: kernel A with rhs did not run once per refinement step")
    # (c) "blocked": kernel C with rhs once per step beside the loop's.
    facts7["c"], launches7["c"] = refined_case(
        "phase 9d (path 7c): blocked f32", f32, cfg7c, sol6, cfg6)
    # The loop's kernel C with rhs: the init's and one per stepped
    # iteration (kernel D once per stepped iteration and correction).
    l7c = launches7["c"]["forward"]
    check(l7c["chol_solve"] == 1 + l7c["cho_solve"] // (1 + cfg7c.n_correctors)
          + facts7["c"]["refine_steps"] and facts7["c"]["refine_steps"] > 0,
          "path 7c: kernel C with rhs did not run once per refinement step")

    # (d) float64 at eps = 1e-9 with auto refinement: card against CPU.
    cfg7d = qt.SolverConfig(check_Q_spd=False, eps=1e-9)
    steps7d = {}
    for device in (dev, "cpu"):
        refine_steps.clear()
        qt.solve_qp_full(*tensors((Q, p, G, h), torch.float64, device,
                                  N_F64_CPU), config=cfg7d, device=device)
        steps7d[str(device)] = refine_steps[-1]
    facts7["d"] = dict(card_vs_cpu=card_vs_cpu(
        "phase 9d (path 7d) f64 eps=1e-9 refined", (Q, p, G, h), cfg7d,
        "QpGh"), refine_steps=steps7d)
    print(f"# phase 9d (path 7d): refinement steps card / CPU "
          f"{steps7d[str(dev)]} / {steps7d['cpu']}")
    check(steps7d[str(dev)] == steps7d["cpu"] > 0,
          "path 7d: refinement steps differ between card and CPU")

    # (e) escalation: 32 lanes of the bench workload get the rotated-
    # spectrum cond ~1e8 Q of tests/test_pdipm.py at n = 100. Refinement
    # runs its budget of 12 steps without the early exit: the early exit
    # stops once a step does not halve the batch's max score, which the
    # planted lanes never let happen, so under the dial (eps = 1e-8 alone)
    # the healthy lanes stop after one step and many stay above
    # escalate_tol (counted below, not escalated: each escalated lane costs
    # a host solve).
    npr = np.random.RandomState(7)
    U, _ = np.linalg.qr(npr.randn(NZ, NZ))
    Qc = (U * np.logspace(0, -8, NZ)) @ U.T
    Qc = 0.5 * (Qc + Qc.T) + 1e-9 * np.eye(NZ)
    planted = np.arange(32) * (B // 32)
    Qe = Q.copy()
    Qe[planted] = Qc
    e32 = tensors((Qe, p, G, h), torch.float32, dev)
    del Qe
    cfg7e = qt.SolverConfig(check_Q_spd=False, eps=1e-8, verbose=-1,
                            refine_steps=12)
    cfg7e_esc = dataclasses.replace(cfg7e, escalate="oracle")
    refine_steps.clear()
    dial_e, _, _ = drive("phase 9d (path 7e): 32 cond ~1e8 lanes, eps=1e-8 "
                         "(the dial, early exit), no escalation", e32,
                         dataclasses.replace(cfg7e, refine_steps="auto"))
    dial_above = int((dial_e.stats.best_resids > cfg7e.escalate_tol).sum())
    print(f"# phase 9d (path 7e): under the dial refinement took "
          f"{refine_steps[-1]} step(s) and left {dial_above} of {B} lanes "
          f"above escalate_tol {cfg7e.escalate_tol:g}")
    del dial_e
    t0 = time.perf_counter()
    base_e, _, _ = drive("phase 9d (path 7e): 32 cond ~1e8 lanes, eps=1e-8, "
                         "no escalation", e32, cfg7e)
    t_base = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol_e, l7e, _ = drive("phase 9d (path 7e): the same with escalate="
                          "'oracle'", e32, cfg7e_esc)
    t_esc = time.perf_counter() - t0
    esc = sol_e.stats.escalated
    n_esc = int(esc.sum())
    keep = ~esc
    check(bool(torch.equal(esc, base_e.stats.best_resids
                           > cfg7e.escalate_tol)),
          "path 7e: the escalated lanes are not those above escalate_tol")
    n_pl = int(esc[torch.as_tensor(planted, device=dev)].sum())
    check(all(bool(torch.equal(getattr(sol_e, k)[keep],
                               getattr(base_e, k)[keep]))
              for k in ("z", "nu", "lam", "s"))
          and bool(torch.equal(sol_e.stats.best_resids[keep],
                               base_e.stats.best_resids[keep])),
          "path 7e: a lane that was not escalated changed")
    # The planted lanes' score recomputed in float64 from hi + lo against
    # the float32-rounded data.
    pl = torch.as_tensor(planted, device=dev)
    zq, lq, sq = (getattr(sol_e, k)[pl].double()
                  + getattr(sol_e.lo, k)[pl].double()
                  for k in ("z", "lam", "s"))
    Qp, pp, Gp, hp = (a[pl].double() for a in e32)
    rx = (torch.einsum("bij,bj->bi", Qp, zq) + pp
          + torch.einsum("bji,bj->bi", Gp, lq))
    rz = torch.einsum("bij,bj->bi", Gp, zq) + sq - hp
    score_pl = rx.norm(dim=1) + rz.norm(dim=1) + (sq * lq).sum(1).abs()
    med_pl = float(score_pl.median())
    base_pl = base_e.stats.best_resids[pl]
    print(f"# phase 9d (path 7e): {n_esc} of {B} lanes escalated, {n_pl} of "
          f"the 32 planted; planted lanes' score before "
          f"{float(base_pl.median()):.3e} (median) / "
          f"{float(base_pl.max()):.3e} (max), after, recomputed in f64 from "
          f"hi + lo: {med_pl:.3e} / {float(score_pl.max()):.3e}; host "
          f"seconds per escalated lane {(t_esc - t_base) / max(n_esc, 1):.4f}"
          f" (solve {t_esc:.3f} s against {t_base:.3f} s)")
    check(med_pl <= 1e-4, f"path 7e: planted lanes' median score "
          f"{med_pl:.3e} > 1e-4")
    facts7["e"] = dict(escalated=n_esc, planted=len(planted),
                       planted_escalated=n_pl, dial_lanes_above=dial_above,
                       planted_score_before=dict(
                           median=float(base_pl.median()),
                           max=float(base_pl.max())),
                       planted_score_after=dict(
                           median=med_pl, max=float(score_pl.max())),
                       host_s_per_lane=(t_esc - t_base) / max(n_esc, 1))
    launches7["e"] = l7e
    del base_e, sol_e, zq, lq, sq, Qp, pp, Gp, hp, rx, rz

    # (f) QPSolvers.CPU_ORACLE at B = 64: the whole batch on the host; the
    # backward builds the factors and runs kernel A.
    o64 = tensors((Q, p, G, h), torch.float64, dev, 64)
    cfg7f = qt.SolverConfig(check_Q_spd=False,
                            solver=qt.QPSolvers.CPU_ORACLE)
    t0 = time.perf_counter()
    sol_o, l7f, _ = drive("phase 9d (path 7f): CPU_ORACLE f64 B=64", o64,
                          cfg7f)
    t_o = time.perf_counter() - t0
    ref_o = qt.solve_qp_full(*o64, config=cfg_d64_e9)
    e_o = rel(sol_o.z, ref_o.z)
    kernels.reset_launches()
    _, g_o = grads_of(o64, cfg7f, dev)
    torch.cuda.synchronize()
    l7f_fb = dict(kernels.LAUNCHES)
    print(f"# phase 9d (path 7f): CPU_ORACLE z against the card's f64 solve "
          f"{e_o:.3e} ({t_o:.2f} s for 64 lanes on the host); backward "
          f"launches { {k: v for k, v in l7f_fb.items() if v} }")
    check(sol_o.z.device.type == "cuda" and e_o <= 1e-7
          and not any(l7f.values()),
          f"path 7f: CPU_ORACLE z {e_o:.3e} > 1e-7, or it launched a kernel")
    check(l7f_fb["factor_inv_solve"] == 1
          and all(bool(torch.isfinite(g_).all()) for g_ in g_o),
          "path 7f: the backward did not run kernel A to finite gradients")
    facts7["f"] = dict(z_err=e_o, host_s=t_o)
    launches7["f"] = dict(forward=l7f, forward_backward=l7f_fb)
    del o64, sol_o, ref_o, g_o

    # (g) KKTSolver.FULL and IR (LU of the saddle system, library calls) on
    # path 1's data in float64, card against CPU; then one verbose=1 solve.
    facts7["g"] = {}
    for ks in (qt.KKTSolver.FULL, qt.KKTSolver.IR):
        cfg_k = qt.SolverConfig(check_Q_spd=False, kkt_solver=ks, eps=1e-9,
                                refine_steps=0)
        facts7["g"][ks.name] = card_vs_cpu(
            f"phase 9d (path 7g) {ks.name} f64 path 1's data", eq_np, cfg_k,
            "QpGhAb", same_iterations=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sol_v = qt.solve_qp_full(*tensors((Q, p, G, h), torch.float32, dev,
                                          8),
                                 config=qt.SolverConfig(check_Q_spd=False,
                                                        verbose=1))
        torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"#   {ln}")
    print(f"# phase 9d (path 7g): verbose=1 at B=8 printed {len(lines)} "
          f"lines over {int(sol_v.stats.iterations)} iterations")
    check(len(lines) == int(sol_v.stats.iterations) > 0
          and all(ln.startswith("iter: ") for ln in lines),
          "path 7g: verbose=1 did not print one line per iteration")
    port_pdipm._refine = refine_orig
    path_launches["path7_refine"] = launches7
    path_facts["path7_refine"] = facts7

    # ---- D1 (ROADMAP §3): kernel A's and step B's float32 error ----
    d1 = d1_measure(torch, kernels, dev)

    # ---- phase 9e (path 8): the hybrid blocked path past the fit ----
    launches8, facts8, data8 = phase_9e(torch, qt, kernels, dev,
                                        (f32, sol, med))
    path_launches["path8_hybrid"] = launches8
    path_facts["path8_hybrid"] = facts8

    # ---- phase 9f: solve_single and the torch example scripts ----
    single_examples = phase_9f(torch, qt, kernels, dev)

    # ---- phase 9g (path 9): the banded and general structured tiers ----
    launches9, facts9, data9 = phase_9g(torch, qt, kernels, dev)
    facts9["examples"] = path9_examples(torch, kernels)
    path_launches["path9_banded"] = launches9
    path_facts["path9_banded"] = facts9

    # ---- phase 10: timings (CUDA events, median of REPS after warm-up) ----
    def cuda_ms(fn, reps=REPS, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, reps=10):
        """Device time of one call of ``fn``: the profiler's sum of the
        device-side events of ``reps`` calls, over ``reps`` (None where the
        profiler sees no device time)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        return total / 1e3 / reps if total else None

    R = spd(B, NINEQ, torch.float32, 5)
    dinv, rhs, z, q = vecs(B, NINEQ, torch.float32, 6)
    m, elt = NINEQ, 4
    mat, vec = B * m * m * elt, B * m * elt
    # R is symmetric and Linv lower triangular: as an input either needs
    # only its triangle read. Linv as an output is a dense tensor whose
    # zeros are written too.
    tri = B * (m * (m + 1) // 2)
    rtri = tri * elt

    def bound(nbytes, flops, peak=f32_peak):
        t_b, t_o = nbytes / mem_bw * 1e3, flops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    fac_flops = B * (2.0 / 3.0) * m ** 3
    eye = torch.eye(m, device=dev).expand(B, m, m)
    T = R + torch.diag_embed(dinv)

    def library_linv():
        L, _ = torch.linalg.cholesky_ex(T)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    lib_ms = cuda_ms(library_linv)
    print(f"# phase 10: library yardstick for factor_inv: "
          f"torch.linalg.cholesky_ex + torch.linalg.solve_triangular "
          f"(two calls) {lib_ms:.3f} ms")
    specs = [
        ("factor_inv", (R, dinv), rtri + vec + mat, fac_flops, 531),
        ("factor_inv_solve", (R, dinv, rhs), rtri + 3 * vec + mat,
         fac_flops + B * 2 * m * m, 540),
        ("factor_inv_solve_rz", (R, dinv, rhs, z), rtri + 4 * vec + mat,
         fac_flops + B * 4 * m * m, 550),
    ]
    rows = []
    for name_, args, nbytes, flops, line in specs:
        k_ms = cuda_ms(lambda: kernels.factor_inv(*args))
        p_ms = cuda_ms(lambda: kernels.factor_inv_plain(*args), reps=REPS)
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(
            name=name_, route="cuda",
            source="qpth_tpu_torch/csrc/factor_inv.cu",
            replaces=f"qpth_tpu/ops/pallas/lanes.py:{line}",
            launches=main_launches[name_], max_abs_err=errs[name_],
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            bound_bytes=nbytes, library_ms=lib_ms,
            library_call="torch.linalg.cholesky_ex + "
                         "torch.linalg.solve_triangular (two calls)"))
    rows[0]["f64_against_plain"] = f64_linv
    # Kernel A's factor_solve in float64, as path 4 launches it once per
    # iteration.
    R64 = spd(B, m, torch.float64, 5)
    dinv64, rhs64 = vecs(B, m, torch.float64, 6, k=2)
    rows[1]["f64_ms"] = cuda_ms(lambda: kernels.factor_inv(R64, dinv64,
                                                           rhs64))
    rows[1]["f64_bound_ms"] = bound(2 * (rtri + 3 * vec + mat),
                                    fac_flops + B * 2 * m * m, f64_peak)[0]
    T64 = R64 + torch.diag_embed(dinv64)
    eye64 = torch.eye(m, device=dev, dtype=torch.float64).expand(B, m, m)

    def library_linv64():
        L, _ = torch.linalg.cholesky_ex(T64)
        return torch.linalg.solve_triangular(L, eye64, upper=False)

    rows[1]["f64_library_ms"] = cuda_ms(library_linv64)
    print(f"# phase 10: factor_inv_solve f64: {rows[1]['f64_ms']:.3f} ms "
          f"(bound {rows[1]['f64_bound_ms']:.4f} ms; library "
          f"{rows[1]['f64_library_ms']:.3f} ms: torch.linalg.cholesky_ex + "
          f"torch.linalg.solve_triangular, two calls) at B={B} m={m}")
    del T64, eye64
    nc = cfg.n_correctors
    k_ms = cuda_ms(lambda: kernels.ipm_step_xfree(R, dinv, z, q - 1.0, nc))
    p_ms = cuda_ms(lambda: kernels.ipm_step_xfree_plain(R, dinv, z, q - 1.0,
                                                        nc))
    xfree_bytes = rtri + 6 * vec + B * elt
    b_ms, b_by = bound(xfree_bytes,
                       fac_flops + B * (2 + 2 * (2 + nc)) * m * m)
    rows.append(dict(
        name="ipm_step_xfree", route="cuda",
        source="qpth_tpu_torch/csrc/ipm_step_xfree.cu",
        replaces="qpth_tpu/ops/pallas/lanes.py:1103",
        launches=main_launches["ipm_step_xfree"],
        max_abs_err=errs["ipm_step_xfree"], ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, bound_bytes=xfree_bytes,
        library_ms=None))
    # The three kernels of this slice at the main shapes (batched operands).
    nz, neq = NZ, NEQ
    mats, v = step_operands(B, m, nz, neq, (), torch.float32, 80)
    Linv = kernels.factor_inv(R, dinv)
    apply_flops = B * (2 + 2 * (2 + nc)) * m * m   # R z and the solves

    # inv_solve reads the lower triangle of Linv (the rest is zero and is
    # never touched) and rhs, writes x, and does two triangular products.
    # Its row is float64, what path 4 launches; float32 beside it.
    Linv64 = kernels.factor_inv(R64, dinv64)

    def inv_solve_facts(Linv_, rhs_, elt_, peak):
        def library():
            w_ = torch.matmul(Linv_, rhs_.unsqueeze(-1))
            return torch.matmul(Linv_.transpose(-1, -2), w_)

        nbytes = (tri + 2 * B * m) * elt_
        b_ms_, b_by_ = bound(nbytes, 4.0 * tri, peak)

        def k_fn():
            return kernels.inv_solve(Linv_, rhs_)

        return dict(ms=cuda_ms(k_fn),
                    plain_ms=cuda_ms(
                        lambda: kernels.inv_solve_plain(Linv_, rhs_)),
                    bound_ms=b_ms_, bound_by=b_by_, bound_bytes=nbytes,
                    library_ms=cuda_ms(library), device_ms=device_ms(k_fn),
                    library_device_ms=device_ms(library))

    inv64 = inv_solve_facts(Linv64, rhs64 - 1.0, 8, f64_peak)
    inv32 = dict(inv_solve_facts(Linv, rhs - 1.0, elt, f32_peak),
                 max_abs_err=inv_solve_f32_err)
    step_args = no_eq(mats, v) + (nc,)
    eq_args = mats + v + (nc,)
    eq_mat_bytes = rtri + B * elt * (nz * m + 2 * m * neq + 2 * neq * neq
                                     + nz * neq)
    new_specs = [
        ("ipm_step", "ipm_step.cu", 918,
         lambda: kernels.ipm_step(*step_args),
         lambda: kernels.ipm_step_plain(*step_args),
         rtri + B * nz * m * elt + 5 * vec + 3 * B * nz * elt + B * elt,
         fac_flops + apply_flops + B * 2 * nz * m),
        ("ipm_step_eq", "ipm_step_eq.cu", 1158,
         lambda: kernels.ipm_step_eq(*eq_args),
         lambda: kernels.ipm_step_eq_plain(*eq_args),
         eq_mat_bytes + 5 * vec + 3 * B * (nz + neq) * elt + B * elt,
         fac_flops + apply_flops
         + B * 2 * (nz * m + nz * neq + (5 + nc) * m * neq + 2 * neq * neq)),
    ]
    # launches: inv_solve from path 4 with equality rows, ipm_step from
    # path 3 (resid_every=1), ipm_step_eq from path 1, each one
    # forward+backward (path 3: forward) through the entry points.
    new_launches = {
        "inv_solve": path_launches["path4_f64_default_eq"][
            "forward_backward"]["inv_solve"],
        "ipm_step": path_launches["path3_direct_x"]["resid_every_1"][
            "ipm_step"],
        "ipm_step_eq": path_launches["path1_eq_batched"][
            "forward_backward"]["ipm_step_eq"],
    }
    check(new_launches["inv_solve"] > 0, "its path launched no inv_solve")
    rows.append(dict(
        name="inv_solve", route="cuda",
        source="qpth_tpu_torch/csrc/inv_solve.cu",
        replaces="qpth_tpu/ops/pallas/lanes.py:567",
        launches=new_launches["inv_solve"], max_abs_err=errs["inv_solve"],
        dtype="float64", **inv64, float32=inv32,
        library_call="torch.matmul twice (Linv rhs, then Linv^T of it)"))
    for name_, src, line, k_fn, p_fn, nbytes, flops in new_specs:
        check(new_launches[name_] > 0, f"its path launched no {name_}")
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(
            name=name_, route="cuda", source=f"qpth_tpu_torch/csrc/{src}",
            replaces=f"qpth_tpu/ops/pallas/lanes.py:{line}",
            launches=new_launches[name_], max_abs_err=errs[name_],
            ms=cuda_ms(k_fn), plain_ms=cuda_ms(p_fn), bound_ms=b_ms,
            bound_by=b_by, bound_bytes=nbytes, library_ms=None))
    for r in rows:
        lib = (f", library {r['library_ms']:.3f} ms"
               if r["library_ms"] is not None else "")
        print(f"# phase 10: {r['name']}: {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}{lib}) at B={B} m={m} "
              f"{r.get('dtype', 'float32')}")
    print(f"# phase 10: inv_solve float32: {inv32['ms']:.3f} ms (plain "
          f"{inv32['plain_ms']:.3f} ms, bound {inv32['bound_ms']:.4f} ms by "
          f"{inv32['bound_by']}, library {inv32['library_ms']:.3f} ms)")

    # Path 5's kernels at its shape (B = 4096, n = 64, neq = 40, float32):
    # kernel 11, and kernels A and 5 on M as path 5a launches them.
    args11 = diag_operands(B, nx, neq5, False, torch.float32, 92)
    M5 = args11[0]
    tri5 = B * (neq5 * (neq5 + 1) // 2) * elt
    vec_n, vec_q = B * nx * elt, B * neq5 * elt
    # M's triangle; A and g once (shared); H, rx, rz, x, s, z and ry, y
    # in; x, s, z, y out.
    b11 = tri5 + (neq5 * nx + nx) * elt + 9 * vec_n + 3 * vec_q
    f11 = B * ((2.0 / 3.0) * neq5 ** 3
               + (2 + nc) * (4 * neq5 * nx + 2 * neq5 * neq5))
    b_ms, b_by = bound(b11, f11)
    rows.append(dict(
        name="diag_step", route="cuda",
        source="qpth_tpu_torch/csrc/diag_step.cu",
        replaces="qpth_tpu/ops/pallas/diagstep.py:165",
        launches=path_launches["path5_diag"]["b_forward_backward"][
            "diag_step"],
        max_abs_err=errs["diag_step"],
        ms=cuda_ms(lambda: kernels.diag_step(*args11, nc)),
        plain_ms=cuda_ms(lambda: kernels.diag_step_plain(*args11, nc)),
        bound_ms=b_ms, bound_by=b_by, bound_bytes=b11, library_ms=None,
        shape=dict(B=B, n=nx, neq=neq5)))
    zero5 = torch.zeros(B, neq5, device=dev)
    rhs5 = vecs(B, neq5, torch.float32, 93, k=1)[0] - 1.0
    Linv5 = kernels.factor_inv(M5, zero5)
    eye5 = torch.eye(neq5, device=dev).expand(B, neq5, neq5)

    def library_linv5():
        L5, _ = torch.linalg.cholesky_ex(M5)
        return torch.linalg.solve_triangular(L5, eye5, upper=False)

    def library_solve5():
        w_ = torch.matmul(Linv5, rhs5.unsqueeze(-1))
        return torch.matmul(Linv5.transpose(-1, -2), w_)

    fb5 = path_launches["path5_diag"]["a_forward_backward"]
    for name_, k_fn, p_fn, l_fn, nbytes, flops in (
            ("factor_inv", lambda: kernels.factor_inv(M5, zero5),
             lambda: kernels.factor_inv_plain(M5, zero5), library_linv5,
             tri5 + vec_q + B * neq5 * neq5 * elt,
             B * (2.0 / 3.0) * neq5 ** 3),
            ("inv_solve", lambda: kernels.inv_solve(Linv5, rhs5),
             lambda: kernels.inv_solve_plain(Linv5, rhs5), library_solve5,
             tri5 + 2 * vec_q, 4.0 * B * neq5 * (neq5 + 1) / 2)):
        b_ms, b_by = bound(nbytes, flops)
        row = next(r for r in rows if r["name"] == name_)
        row["path5_m40"] = dict(
            launches=fb5[name_], ms=cuda_ms(k_fn), plain_ms=cuda_ms(p_fn),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            library_ms=cuda_ms(l_fn), dtype="float32",
            device_ms=device_ms(k_fn), library_device_ms=device_ms(l_fn))
    for r in [rows[-1]] + [r for r in rows if "path5_m40" in r]:
        f_ = r if r["name"] == "diag_step" else r["path5_m40"]
        lib = (f", library {f_['library_ms']:.3f} ms"
               if f_["library_ms"] is not None else "")
        print(f"# phase 10: {r['name']} at path 5's shape: {f_['ms']:.3f} ms "
              f"(plain {f_['plain_ms']:.3f} ms, bound {f_['bound_ms']:.4f} "
              f"ms by {f_['bound_by']}, {f_['bound_bytes'] / 1e6:.1f} MB"
              f"{lib}) at B={B} n={nx} neq={neq5} float32; launches on "
              f"path 5 forward+backward {f_['launches']}")
    # Kernel 5 at its three shapes: CUDA events around one launch include
    # the wrapper's host time; the profiler's device time is the kernel's.
    inv_row = next(r for r in rows if r["name"] == "inv_solve")
    for tag, f_ in (("m=40 float32", inv_row["path5_m40"]),
                    ("m=100 float32", inv32), ("m=100 float64", inv_row)):
        dev_, lib_ = f_["device_ms"], f_["library_device_ms"]
        print(f"# phase 10: inv_solve {tag}: device "
              + (f"{dev_:.4f} ms, host share of one launch "
                 f"{f_['ms'] - dev_:.4f} ms" if dev_ is not None
                 else "not measured")
              + f" (events {f_['ms']:.4f} ms, bound {f_['bound_ms']:.4f} "
              "ms); library (torch.matmul twice) device "
              + (f"{lib_:.4f} ms" if lib_ is not None else "not measured")
              + f", events {f_['library_ms']:.4f} ms")
    del args11, M5, Linv5, eye5
    # Kernel A at path 8's diagonal blocks: B batched blocks of the default
    # width with T's shift, launched as path 8 (a) launches it.
    m8 = hybrid.BLOCK
    R8 = spd(B, m8, torch.float32, 94)
    dinv8 = vecs(B, m8, torch.float32, 95, k=1)[0]
    T8 = R8 + torch.diag_embed(dinv8)
    eye8 = torch.eye(m8, device=dev).expand(B, m8, m8)

    def library_linv8():
        L8, _ = torch.linalg.cholesky_ex(T8)
        return torch.linalg.solve_triangular(L8, eye8, upper=False)

    def kernel8():
        return kernels.factor_inv(R8, dinv8)

    # R's triangle and dinv in, Linv out.
    nbytes8 = B * (m8 * (m8 + 1) // 2 + m8 + m8 * m8) * elt
    b_ms, b_by = bound(nbytes8, B * (2.0 / 3.0) * m8 ** 3)
    row8 = dict(
        launches=path_launches["path8_hybrid"]["a"]["forward_backward"][
            "factor_inv"],
        ms=cuda_ms(kernel8),
        plain_ms=cuda_ms(lambda: kernels.factor_inv_plain(R8, dinv8),
                         reps=REPS),
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes8,
        library_ms=cuda_ms(library_linv8), dtype="float32",
        device_ms=device_ms(kernel8),
        library_device_ms=device_ms(library_linv8))
    rows[0]["path8_block"] = row8
    dev8, ldev8 = row8["device_ms"], row8["library_device_ms"]
    print(f"# phase 10: factor_inv at path 8's blocks (B={B} m={m8} float32"
          f", with the shift): {row8['ms']:.3f} ms, device "
          + (f"{dev8:.4f}" if dev8 is not None else "not measured")
          + f" (plain {row8['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}, {nbytes8 / 1e6:.1f} MB, library {row8['library_ms']:.3f}"
          " ms, device "
          + (f"{ldev8:.4f}" if ldev8 is not None else "not measured")
          + f"); launches on path 8 (a) forward+backward {row8['launches']}")
    del R8, dinv8, T8, eye8
    del mats, v, Linv, Linv64, R64, step_args, eq_args

    # Kernels C, D and E at the main shape (B = 4096, m = 100), float32 and
    # float64. Bounds count R and the factors by their triangles; the
    # Cholesky factor and the triangular inverse take m^3 / 3 flops each,
    # the two substitutions 2 m^2.
    def chol_facts(dtype):
        elt_ = torch.empty((), dtype=dtype).element_size()
        peak = f32_peak if dtype == torch.float32 else f64_peak
        R_ = spd(B, m, dtype, 120)
        dinv_, rhs_ = vecs(B, m, dtype, 121, k=2)
        rhs_ = rhs_ - 1.0
        T_ = R_ + torch.diag_embed(dinv_)
        Lt_ = kernels.chol(R_, dinv_)
        L_ = Lt_.transpose(1, 2).contiguous()
        LQ_ = L_[:1].contiguous()            # a shared lower factor (L_Q)
        eye_ = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)
        tri_b, vec_b = tri * elt_, B * m * elt_

        def lib_chol_solve():
            Lc, _ = torch.linalg.cholesky_ex(T_)
            return torch.cholesky_solve(rhs_.unsqueeze(-1), Lc)

        specs = {
            "chol_shift": (
                lambda: kernels.chol(R_, dinv_),
                lambda: kernels.chol_plain(R_, dinv_),
                lambda: torch.linalg.cholesky_ex(T_),
                "torch.linalg.cholesky_ex of R + diag(dinv)",
                2 * tri_b + vec_b, B * m ** 3 / 3),
            "chol": (
                lambda: kernels.chol(R_), lambda: kernels.chol_plain(R_),
                lambda: torch.linalg.cholesky_ex(R_),
                "torch.linalg.cholesky_ex", 2 * tri_b, B * m ** 3 / 3),
            "chol_solve": (
                lambda: kernels.chol(R_, dinv_, rhs_),
                lambda: kernels.chol_plain(R_, dinv_, rhs_), lib_chol_solve,
                "torch.linalg.cholesky_ex + torch.cholesky_solve (two calls)",
                2 * tri_b + 3 * vec_b, B * (m ** 3 / 3 + 2 * m * m)),
            "cho_solve": (
                lambda: kernels.cho_solve(Lt_, rhs_),
                lambda: kernels.cho_solve_plain(Lt_, rhs_),
                lambda: torch.cholesky_solve(rhs_.unsqueeze(-1), L_),
                "torch.cholesky_solve", tri_b + 2 * vec_b, B * 2 * m * m),
            "cho_solve_lower": (
                lambda: kernels.cho_solve(L_, rhs_, lower=True),
                lambda: kernels.cho_solve_plain(L_, rhs_, lower=True),
                lambda: torch.cholesky_solve(rhs_.unsqueeze(-1), L_),
                "torch.cholesky_solve", tri_b + 2 * vec_b, B * 2 * m * m),
            "cho_solve_shared_lower": (
                lambda: kernels.cho_solve(LQ_, rhs_, lower=True),
                lambda: kernels.cho_solve_plain(LQ_, rhs_, lower=True),
                lambda: torch.cholesky_solve(rhs_.T, LQ_[0]),
                "torch.cholesky_solve on the shared factor, B right-hand "
                "sides in one call", m * (m + 1) // 2 * elt_ + 2 * vec_b,
                B * 2 * m * m),
            "trinv": (
                lambda: kernels.trinv(Lt_), lambda: kernels.trinv_plain(Lt_),
                lambda: torch.linalg.solve_triangular(L_, eye_, upper=False),
                "torch.linalg.solve_triangular(L, I)", 2 * tri_b,
                B * m ** 3 / 3),
        }
        out = {}
        for key, (k_fn, p_fn, l_fn, l_name, nbytes, flops) in specs.items():
            b_ms, b_by = bound(nbytes, flops, peak)
            out[key] = dict(ms=cuda_ms(k_fn), plain_ms=cuda_ms(p_fn),
                            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                            library_ms=cuda_ms(l_fn), library_call=l_name)
            # ``ms`` includes the host time of one launch: the profiler's
            # device time alone beside it, the kernel's and the library's.
            out[key].update(device_ms=device_ms(k_fn),
                            library_device_ms=device_ms(l_fn))
            extra = ", " + ", ".join(
                f"{w} {v:.4f} ms" if v is not None else f"{w} not measured"
                for w, v in (("device", out[key]["device_ms"]),
                             ("library device",
                              out[key]["library_device_ms"])))
            print(f"# phase 10: {key} {dtype}: {out[key]['ms']:.3f} ms "
                  f"(plain {out[key]['plain_ms']:.3f} ms, bound {b_ms:.4f} "
                  f"ms by {b_by}, {nbytes / 1e6:.1f} MB, library "
                  f"{out[key]['library_ms']:.3f} ms: {l_name}{extra}) at "
                  f"B={B} m={m}")
        return out

    cf32, cf64 = chol_facts(torch.float32), chol_facts(torch.float64)
    # Block barriers one QP passes in kernels C and E (constants of the
    # sources: csrc/chol.cu::chol_barriers, csrc/trinv.cu::trinv_barriers).
    chol_bar = build.load("chol").qpth_chol_barriers
    trinv_bar = build.load("trinv").qpth_trinv_barriers
    print(f"# phase 10: block barriers per QP at m={m}: kernel C "
          f"{chol_bar(m, 0)} (with rhs {chol_bar(m, 1)}), kernel E "
          f"{trinv_bar(m)}")
    la6 = path_launches["path6_blocked"]["a_forward_backward"]
    lb6 = path_launches["path6_blocked"]["b_forward_backward"]
    fused_note = ("path 6a forward+backward; every launch of kernel C with "
                  "the shift on that path carries its first solve (the "
                  "chol_solve variant)")
    for line, src, fn_name, key, launches, note in (
            ("lanes.py:225", "chol.cu", "factor_kkt_lanes", "chol_shift",
             la6["chol_solve"], fused_note + "; time shared with "
             "factor_kkt_t_pallas"),
            ("lanes.py:258", "chol.cu", "factor_solve_kkt_lanes",
             "chol_solve", la6["chol_solve"], "path 6a forward+backward"),
            ("lanes.py:1240", "cho_solve.cu", "cho_solve_lanes", "cho_solve",
             la6["cho_solve"], "path 6a forward+backward; time shared with "
             "cho_solve_vec_t_pallas"),
            ("cholesky.py:134", "chol.cu", "cholesky_t_pallas", "chol",
             lb6["chol"], "path 6b forward+backward: the factors of Q and "
             "S11 (substitution mode)"),
            ("cholesky.py:171", "chol.cu", "factor_kkt_t_pallas",
             "chol_shift", la6["chol_solve"], fused_note),
            ("cholesky.py:255", "trinv.cu", "trinv_pallas", "trinv", 0,
             "on no solver path, as in the JAX package (tests, spd_inverse)"),
            ("cholesky.py:316", "cho_solve.cu", "cho_solve_vec_t_pallas",
             "cho_solve", la6["cho_solve"], "path 6a forward+backward; "
             "float32 and float64 on a shared lower factor (L_Q) beside")):
        f_ = cf32[key]
        row = dict(name=f"{key} ({fn_name})", route="cuda",
                   source=f"qpth_tpu_torch/csrc/{src}",
                   replaces=f"qpth_tpu/ops/pallas/{line}", launches=launches,
                   launches_note=note, max_abs_err=errs[key], **f_,
                   float64=cf64[key])
        if key == "cho_solve":
            row["lower"] = dict(float32=cf32["cho_solve_lower"],
                                float64=cf64["cho_solve_lower"])
            row["shared_lower"] = dict(float32=cf32["cho_solve_shared_lower"],
                                       float64=cf64["cho_solve_shared_lower"])
            row["max_abs_err_shared"] = errs["cho_solve_shared"]
            p6l = path_launches["path6_blocked"]
            row["launches_by_path"] = {
                k: {n_: p6l[k][n_] for n_ in ("cho_solve", "cho_solve_shared")}
                for k in ("a_forward", "a_forward_backward", "b_forward",
                          "b_forward_backward", "d_forward",
                          "d_forward_backward", "d_f64_forward",
                          "d_f64_forward_backward")}
            row["launches_by_path"].update({
                f"c_{k}_{w}": {n_: p6l["c"][k][w][n_]
                               for n_ in ("cho_solve", "cho_solve_shared")}
                for k in p6l["c"] for w in ("forward", "forward_backward")})
        rows.append(row)
    check(len(rows) == 15, f"the kernels line has {len(rows)} rows, not 15")
    # Path 7's launches of the kernels that refinement runs: kernel A with
    # rhs (row 3) once per step under "auto", kernel C with rhs (row 9)
    # under "blocked", and kernel D (row 15) beside it.
    p7l = path_launches["path7_refine"]
    for r in rows:
        key = {"qpth_tpu/ops/pallas/lanes.py:540": "factor_inv_solve",
               "qpth_tpu/ops/pallas/lanes.py:258": "chol_solve",
               "qpth_tpu/ops/pallas/cholesky.py:316": "cho_solve"}.get(
                   r["replaces"])
        if key:
            r["path7_launches"] = {
                c: {w: p7l[c][w][key] for w in ("forward",
                                                "forward_backward")}
                for c in ("a", "b", "c")}
    # Path 8's launches of kernel A (row 1: every diagonal block) and of
    # the kernels that run over the hybrid prefactor where nineq fits (8c).
    p8l = path_launches["path8_hybrid"]
    for r in rows:
        key = {f"qpth_tpu/ops/pallas/lanes.py:{ln}": k for ln, k in (
            (531, "factor_inv"), (550, "factor_inv_solve_rz"),
            (540, "factor_inv_solve"), (1103, "ipm_step_xfree"),
            (567, "inv_solve"), (1158, "ipm_step_eq"))}.get(r["replaces"])
        if key:
            r["path8_launches"] = {c: {w: n_.get(key, 0)
                                       for w, n_ in p8l[c].items()}
                                   for c in p8l}
        if key == "factor_inv":
            r["path8_kernel_a_dims"] = {
                c: facts8[c]["kernel_a_dims"]
                for c in ("a", "b", "c", "c_eq", "d_f32")}

    spread = {}

    def host_ms(fn, reps=5):
        """Median wall time of ``fn`` ending in a synchronize, after one
        warm-up call; the (min, max) of the last call is in ``spread``."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        spread["last"] = (min(ts), max(ts))
        return statistics.median(ts)

    def report(tag, ms, its_=None):
        lo, hi = spread["last"]
        print(f"# phase 10: {tag}: {ms:.2f} ms/solve (min {lo:.2f}, max "
              f"{hi:.2f}; {B / ms * 1e3:.0f} QPs/s)"
              + (f", iterations {its_}" if its_ is not None else ""))
        return ms

    fwd_ms = host_ms(lambda: qt.solve_qp_full(*f32, config=cfg))
    fb_ms = host_ms(lambda: fwd_bwd(f32, cfg, dev))
    print(f"# phase 10: forward {fwd_ms:.2f} ms/solve "
          f"({B / fwd_ms * 1e3:.0f} QPs/s), forward+backward "
          f"{fb_ms:.2f} ms/solve ({B / fb_ms * 1e3:.0f} QPs/s) at B={B} "
          f"nz=nineq={NZ} f32, iterations {its}")
    opt_fwd_ms = host_ms(lambda: qt.solve_qp_full(*sh32, config=cfg))
    opt_fb_ms = host_ms(lambda: fwd_bwd(sh32, cfg, dev))
    print(f"# phase 10: OptNet pattern: forward {opt_fwd_ms:.2f} ms/solve "
          f"({B / opt_fwd_ms * 1e3:.0f} QPs/s), forward+backward "
          f"{opt_fb_ms:.2f} ms/solve ({B / opt_fb_ms * 1e3:.0f} QPs/s) at "
          f"B={B} nz=nineq={NZ} f32, iterations "
          f"{int(sol_s.stats.iterations)}")

    # This slice's paths end to end (host clock around a solve ending in
    # synchronize, median of 5).
    paths_ms = {}
    for key, arrs, config, its_ in (
            ("path1_eq_batched", eq32, cfg, its1),
            ("path2_sudoku", sud32, cfg_sud, its2)):
        paths_ms[key] = dict(
            forward_ms=report(f"{key} forward", host_ms(
                lambda: qt.solve_qp_full(*arrs, config=config)), its_),
            forward_backward_ms=report(f"{key} forward+backward", host_ms(
                lambda: grads_of(arrs, config, dev))))
    paths_ms["path3_direct_x"] = dict(
        resid_every_1_forward_ms=report("path3 resid_every=1 forward",
                                        host_ms(lambda: qt.solve_qp_full(
                                            *f32, config=cfg_r1)), its3),
        coeff_x_false_forward_ms=report("path3 coeff_x=False forward",
                                        host_ms(lambda: qt.solve_qp_full(
                                            *f32, config=cfg_cx)), its3c),
        warm_forward_ms=report("path3 warm-started re-solve", host_ms(
            lambda: qt.solve_qp_full(*warm32, config=cfg_cx, init=init)),
            its3w),
        cold_forward_ms=report("path3 the same re-solve, cold", host_ms(
            lambda: qt.solve_qp_full(*warm32, config=cfg_cx)), its3k))
    for key, arrs_np in (("path4_f64_default", (Q, p, G, h)),
                         ("path4_f64_default_eq", eq_np)):
        d64 = tensors(arrs_np, torch.float64, dev)
        paths_ms[key] = dict(
            forward_ms=report(f"{key} forward", host_ms(
                lambda: qt.solve_qp_full(*d64, config=cfg_d64)),
                path_facts[key]["iterations"]),
            forward_backward_ms=report(f"{key} forward+backward", host_ms(
                lambda: grads_of(d64, cfg_d64, dev))))
        del d64
    paths_ms["path5_diag"] = dict(
        a_forward_ms=report("path5 (a) diagonal tier forward", host_ms(
            lambda: qt.solve_qp_diag_full(*d32, config=cfg5)), its5a),
        a_forward_backward_ms=report("path5 (a) forward+backward", host_ms(
            lambda: diag_grads(d32, cfg5, dev))),
        b_forward_ms=report("path5 (b) fused diag_step forward", host_ms(
            lambda: qt.solve_qp_diag_full(*d32, config=cfg5f)), its5b),
        b_forward_backward_ms=report("path5 (b) forward+backward", host_ms(
            lambda: diag_grads(d32, cfg5f, dev))))
    p6 = dict(
        a_forward_ms=report("path6 (a) blocked forward", host_ms(
            lambda: qt.solve_qp_full(*f32, config=cfg6)), its6),
        a_forward_backward_ms=report("path6 (a) forward+backward", host_ms(
            lambda: grads_of(f32, cfg6, dev))),
        a_optnet_forward_ms=report("path6 (a) OptNet pattern forward",
                                   host_ms(lambda: qt.solve_qp_full(
                                       *sh32, config=cfg6)), its6o),
        b_forward_ms=report("path6 (b) blocked subst forward", host_ms(
            lambda: qt.solve_qp_full(*eq32, config=cfg6s)), its6b),
        b_forward_backward_ms=report("path6 (b) forward+backward", host_ms(
            lambda: grads_of(eq32, cfg6s, dev))),
        d_forward_ms=report("path6 (d) blocked subst OptNet forward",
                            host_ms(lambda: qt.solve_qp_full(
                                *sh32, config=cfg6s)), its6d),
        d_forward_backward_ms=report("path6 (d) forward+backward", host_ms(
            lambda: grads_of(sh32, cfg6s, dev))))
    sh64d = tensors(shared, torch.float64, dev)
    p6["d_f64_forward_ms"] = report(
        "path6 (d) f64 blocked OptNet forward", host_ms(
            lambda: qt.solve_qp_full(*sh64d, config=cfg6)), its6d64)
    p6["d_f64_forward_backward_ms"] = report(
        "path6 (d) f64 blocked OptNet forward+backward", host_ms(
            lambda: grads_of(sh64d, cfg6, dev)))
    del sh64d
    for key, arrs_np in (("bench", (Q, p, G, h)), ("eq", eq_np)):
        d64 = tensors(arrs_np, torch.float64, dev)
        p6[f"c_{key}_iterations"] = int(qt.solve_qp_full(
            *d64, config=cfg6).stats.iterations)
        p6[f"c_{key}_forward_ms"] = report(
            f"path6 (c) f64 blocked {key} forward", host_ms(
                lambda: qt.solve_qp_full(*d64, config=cfg6)),
            p6[f"c_{key}_iterations"])
        p6[f"c_{key}_forward_backward_ms"] = report(
            f"path6 (c) f64 blocked {key} forward+backward", host_ms(
                lambda: grads_of(d64, cfg6, dev)))
        del d64
    paths_ms["path6_blocked"] = p6

    # Path 7: refined (eps = 1e-8) forward and forward+backward beside the
    # unrefined ones of this run, and (e) with and without escalation.
    def timed(tag, fn, its_=None):
        ms = report(tag, host_ms(fn), its_)
        lo, hi = spread["last"]
        return dict(median=ms, min=lo, max=hi)

    paths_ms["path7_refine"] = dict(
        a_forward_ms=timed("path7 (a) refined forward", lambda: (
            qt.solve_qp_full(*f32, config=cfg7)), facts7["a"]["iterations"]),
        a_forward_backward_ms=timed("path7 (a) refined forward+backward",
                                    lambda: grads_of(f32, cfg7, dev)),
        a_fixed12_forward_ms=timed(
            "path7 (a) refine_steps=12 forward", lambda: qt.solve_qp_full(
                *f32, config=dataclasses.replace(cfg7, refine_steps=12))),
        a_unrefined_forward_ms=timed("path7 (a) unrefined forward", lambda: (
            qt.solve_qp_full(*f32, config=cfg)), its),
        a_unrefined_forward_backward_ms=timed(
            "path7 (a) unrefined forward+backward",
            lambda: grads_of(f32, cfg, dev)),
        c_forward_ms=timed("path7 (c) blocked refined forward", lambda: (
            qt.solve_qp_full(*f32, config=cfg7c)), facts7["c"]["iterations"]),
        c_forward_backward_ms=timed(
            "path7 (c) blocked refined forward+backward",
            lambda: grads_of(f32, cfg7c, dev)),
        c_unrefined_forward_ms=timed("path7 (c) blocked unrefined forward",
                                     lambda: qt.solve_qp_full(
                                         *f32, config=cfg6), its6),
        c_unrefined_forward_backward_ms=timed(
            "path7 (c) blocked unrefined forward+backward",
            lambda: grads_of(f32, cfg6, dev)),
        e_forward_ms=timed("path7 (e) forward, no escalation", lambda: (
            qt.solve_qp_full(*e32, config=cfg7e))),
        e_escalated_forward_ms=timed("path7 (e) forward with escalation",
                                     lambda: qt.solve_qp_full(
                                         *e32, config=cfg7e_esc)))

    # Path 8: (a) and (b) end to end, the block-size sweep, the device
    # split of one (a) forward+backward.
    paths_ms["path8_hybrid"] = dict(timings=path8_timings(
        torch, qt, kernels, dev, data8, host_ms, report, spread))
    del data8
    torch.cuda.empty_cache()

    # Path 9: (a) and (c) end to end, kernel A at the stage width, the
    # device split of one (a) forward+backward; rows 1 and 5 of the kernels
    # line take path 9's launches and the stage-width reading.
    t9 = path9_timings(torch, qt, kernels, dev, data9, host_ms, report,
                       spread, cuda_ms, device_ms, bound, elt)
    paths_ms["path9_banded"] = dict(timings=t9)
    del data9
    torch.cuda.empty_cache()
    p9l = path_launches["path9_banded"]
    for r in rows:
        key = {"qpth_tpu/ops/pallas/lanes.py:531": "factor_inv",
               "qpth_tpu/ops/pallas/lanes.py:567": "inv_solve"}.get(
                   r["replaces"])
        if key:
            r["path9_launches"] = {c: {w: n_.get(key, 0)
                                       for w, n_ in p9l[c].items()}
                                   for c in p9l}
    rows[0]["path9_stage"] = dict(
        t9["kernel_a_stage"],
        launches=p9l[f"a_neq{NEQ9}"]["forward_backward"]["factor_inv"])

    # Device time of one forward+backward by kernel (torch.profiler), and
    # the share of the wall time the device was idle: the neq = 0 main
    # path, path 1, and path 5 composed and fused.
    def trace_of(tag, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only: a CPU-side record (an aten op, the
        # autograd Function) also carries the device time of the kernels
        # it launched.
        by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(t for t, _, _ in by_kernel)
        out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
               "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
               else None,
               "top": [dict(ms=t, count=c, name=k[:80])
                       for t, c, k in by_kernel[:8]]}
        if busy_ms:
            print(f"# phase 10: trace of one forward+backward ({tag}): "
                  f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
                  f"idle share {out['device_idle_share']:.3f}")
            for t, c, k in by_kernel[:8]:
                print(f"#   {t:9.3f} ms  x{c:<4d} {k[:90]}")
        else:
            print(f"# phase 10: trace ({tag}): the profiler saw no device "
                  "time (not measured)")
        return out

    trace = trace_of("neq = 0 main path", lambda: fwd_bwd(f32, cfg, dev))
    trace1 = trace_of("path 1", lambda: grads_of(eq32, cfg, dev))
    trace5 = {k: trace_of(f"path 5 ({k})", lambda: diag_grads(d32, c_, dev))
              for k, c_ in (("a", cfg5), ("b", cfg5f))}
    trace6 = trace_of("path 6 (a)", lambda: grads_of(f32, cfg6, dev))

    # ---- path 10: multi-process solves, native oracle, profiling ----
    p10 = phase_10x(torch, qt, kernels, dev, smi, fwd_ms, fb_ms, rows)

    # ---- phase 11: result lines ----
    for key in paths_ms:
        paths_ms[key].update(launches=path_launches[key],
                             **path_facts[key])
    paths_ms["path10_parallel"] = p10
    paths_ms["path1_eq_batched"]["trace"] = trace1
    paths_ms["path5_diag"]["trace"] = trace5
    paths_ms["path6_blocked"]["trace"] = trace6
    paths_ms["d1"] = d1
    paths_ms["single_and_examples"] = single_examples
    print(f"# total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows, "end_to_end": {
        "forward_ms": fwd_ms, "forward_backward_ms": fb_ms,
        "forward_qps": B / fwd_ms * 1e3,
        "forward_backward_qps": B / fb_ms * 1e3, "iterations": its,
        "batch": B, "nz": NZ, "nineq": NINEQ, "dtype": "float32",
        "card": smi, "trace": trace,
        "optnet": {"forward_ms": opt_fwd_ms,
                   "forward_backward_ms": opt_fb_ms,
                   "iterations": int(sol_s.stats.iterations)},
        "paths": paths_ms}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--path10-rank":
        path10_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5])
    else:
        main()
