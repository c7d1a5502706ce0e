#!/usr/bin/env python3
"""On-card smoke test and timing of the PyTorch/CUDA port (qpth_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels from qpth_tpu_torch/csrc/, holds every
kernel against its plain PyTorch version, drives the port's main path
(bench.py's workload: B = 4096 random dense QPs, nz = nineq = 100, float32,
forward and forward+backward) and the OptNet pattern (shared Q/G) through
the kernels, checks the results against float64 solves on the card and on
the CPU, and times kernels and solves with CUDA events. Any failed check
exits nonzero. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

preceded by a {"kernels": [...]} line. Without CUDA it exits nonzero and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, NZ, NINEQ = 4096, 100, 100     # bench.py's workload
N_F64_CARD, N_F64_CPU = 256, 64   # lanes re-solved in float64
TOL_F32 = 1e-3                    # kernel vs plain, float32, main shape
TOL_F64 = 1e-10                   # kernel vs plain, float64, odd shape
REPS = 20

#: Published peaks (memory bytes/s, float32 non-tensor FLOP/s) by card;
#: the H100 SXM figures are NVIDIA's data sheet at 700 W.
PEAKS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


def make_problem(nbatch, nz, nineq, seed=0):
    """bench.py's generator: random feasible dense QPs, fully batched."""
    npr = np.random.RandomState(seed)
    L = npr.rand(nbatch, nz, nz)
    Q = np.matmul(L, L.transpose(0, 2, 1)) + 1e-3 * np.eye(nz)
    G = npr.randn(nbatch, nineq, nz)
    z0 = npr.randn(nbatch, nz)
    s0 = npr.rand(nbatch, nineq)
    p = npr.randn(nbatch, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + s0
    return Q, p, G, h


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


def main():
    import torch

    # ---- phase 0: facts ----
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
    mem_bw, f32_peak = next(((bw, fl) for key, bw, fl in PEAKS
                             if key in name), PEAKS[-1][1:])

    sys.path.insert(0, ROOT)
    import qpth_tpu_torch as qt
    from qpth_tpu_torch.ops.cuda import build, kernels

    dev = torch.device("cuda")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"# phase 1: built {[os.path.basename(str(p)) for p in libs]} "
          f"in {time.perf_counter() - t0:.2f} s")

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

    errs = {k: 0.0 for k in kernels.LAUNCHES}

    def compare(tag, got, want, tol, key=None):
        """Every output within tol * max(1, max |plain|) of the plain
        version; records the max absolute difference."""
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
    missing = [k for k, v in main_launches.items() if v == 0]
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

    # ---- phase 6: timings (CUDA events, median of REPS after warm-up) ----
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

    R = spd(B, NINEQ, torch.float32, 5)
    dinv, rhs, z, q = vecs(B, NINEQ, torch.float32, 6)
    m, elt = NINEQ, 4
    mat, vec = B * m * m * elt, B * m * elt

    def bound(nbytes, flops):
        t_b, t_o = nbytes / mem_bw * 1e3, flops / f32_peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    fac_flops = B * (2.0 / 3.0) * m ** 3
    eye = torch.eye(m, device=dev).expand(B, m, m)
    T = R + torch.diag_embed(dinv)

    def library_linv():
        L, _ = torch.linalg.cholesky_ex(T)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    lib_ms = cuda_ms(library_linv)
    print(f"# phase 6: library yardstick for factor_inv: "
          f"torch.linalg.cholesky_ex + torch.linalg.solve_triangular "
          f"(two calls) {lib_ms:.3f} ms")
    specs = [
        ("factor_inv", (R, dinv), mat + vec + mat, fac_flops, 531),
        ("factor_inv_solve", (R, dinv, rhs), mat + 3 * vec + mat,
         fac_flops + B * 2 * m * m, 540),
        ("factor_inv_solve_rz", (R, dinv, rhs, z), mat + 4 * vec + mat,
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
            library_ms=lib_ms,
            library_call="torch.linalg.cholesky_ex + "
                         "torch.linalg.solve_triangular (two calls)"))
    nc = cfg.n_correctors
    k_ms = cuda_ms(lambda: kernels.ipm_step_xfree(R, dinv, z, q - 1.0, nc))
    p_ms = cuda_ms(lambda: kernels.ipm_step_xfree_plain(R, dinv, z, q - 1.0,
                                                        nc))
    b_ms, b_by = bound(mat + 6 * vec + B * elt,
                       fac_flops + B * (2 + 2 * (2 + nc)) * m * m)
    rows.append(dict(
        name="ipm_step_xfree", route="cuda",
        source="qpth_tpu_torch/csrc/ipm_step_xfree.cu",
        replaces="qpth_tpu/ops/pallas/lanes.py:1103",
        launches=main_launches["ipm_step_xfree"],
        max_abs_err=errs["ipm_step_xfree"], ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        print(f"# phase 6: {r['name']}: {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}) at B={B} m={m} f32")

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    fwd_ms = host_ms(lambda: qt.solve_qp_full(*f32, config=cfg))
    fb_ms = host_ms(lambda: fwd_bwd(f32, cfg, dev))
    print(f"# phase 6: forward {fwd_ms:.2f} ms/solve "
          f"({B / fwd_ms * 1e3:.0f} QPs/s), forward+backward "
          f"{fb_ms:.2f} ms/solve ({B / fb_ms * 1e3:.0f} QPs/s) at B={B} "
          f"nz=nineq={NZ} f32, iterations {its}")
    opt_fwd_ms = host_ms(lambda: qt.solve_qp_full(*sh32, config=cfg))
    opt_fb_ms = host_ms(lambda: fwd_bwd(sh32, cfg, dev))
    print(f"# phase 6: OptNet pattern: forward {opt_fwd_ms:.2f} ms/solve "
          f"({B / opt_fwd_ms * 1e3:.0f} QPs/s), forward+backward "
          f"{opt_fb_ms:.2f} ms/solve ({B / opt_fb_ms * 1e3:.0f} QPs/s) at "
          f"B={B} nz=nineq={NZ} f32, iterations "
          f"{int(sol_s.stats.iterations)}")

    # Device time of one forward+backward by kernel (torch.profiler), and
    # the share of the wall time the device was idle.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd(f32, cfg, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: a CPU-side record (an aten op, the autograd
    # Function) also carries the device time of the kernels it launched.
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _, _ in by_kernel)
    trace = {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
             "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
             else None,
             "top": [dict(ms=t, count=c, name=k[:80])
                     for t, c, k in by_kernel[:8]]}
    if busy_ms:
        print(f"# phase 6: trace of one forward+backward: wall "
              f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
              f"{trace['device_idle_share']:.3f}")
        for t, c, k in by_kernel[:8]:
            print(f"#   {t:9.3f} ms  x{c:<4d} {k[:90]}")
    else:
        print("# phase 6: trace: the profiler saw no device time "
              "(not measured)")

    # ---- phase 7: result lines ----
    print(json.dumps({"kernels": rows, "end_to_end": {
        "forward_ms": fwd_ms, "forward_backward_ms": fb_ms,
        "forward_qps": B / fwd_ms * 1e3,
        "forward_backward_qps": B / fb_ms * 1e3, "iterations": its,
        "batch": B, "nz": NZ, "nineq": NINEQ, "dtype": "float32",
        "card": smi, "trace": trace,
        "optnet": {"forward_ms": opt_fwd_ms,
                   "forward_backward_ms": opt_fb_ms,
                   "iterations": int(sol_s.stats.iterations)}}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
