#!/usr/bin/env python3
"""Kernel 5 (qpth_tpu_torch/csrc/inv_solve.cu) against the designs it was
chosen over, on one NVIDIA GPU (sm_90a). From the repository root:

    python3 benchmarks/inv_solve_designs.py [--parent PATH]

Each design is the committed source with one choice undone, built with the
port's nvcc flags into build/inv_solve_designs/ (git-ignored):

* ``kernel``: the committed kernel;
* ``no_half_warp``: one warp per QP at every m;
* ``prefetch``: the next R rows' loads issued before the current rows'
  sums (2 R rows in flight);
* ``rows_x2``: twice the rows per step (kRowWords 32);
* ``transposed_butterfly``: the R row sums reduced together, halved across
  the lanes at each of the first log2 R levels, then broadcast;
* ``pairs_both``, ``sequential_both``: the R rows' terms of an x entry
  summed in pairs (the float32 order), or added one after another (the
  float64 order), in both types;
* ``parent`` (with ``--parent``): another version of the source, such as
  the parent commit's, built the same way.

Every design is checked against ``inv_solve_plain`` (NaN above the
diagonal, a NaN lane, B = 4097), then timed at B = 4096 at the shapes the
port launches (m = 40 f32: path 5a; m = 100 f32; m = 100 f64: path 4):
the profiler's device time per launch, and CUDA events around 50 launches
back to back, in the order of the list and again reversed. Then each
design is loaded in the kernel's place for path 5a (``chip_smoke.py``'s
sudoku QP on the diagonal tier, float32, composed and fused): z and nu
against the float64 solve, per lane, and the lanes on which the fused and
the composed step part (phase 9b (b)'s tolerance); path 5c's float64
card-against-CPU check (64 lanes, eps = 1e-9, composed and fused: z, nu
and the six gradients, relative to their largest entry); and its solve on
an ill-conditioned M = A diag(d) A^T (d from 1e-6 to 1e2) against the
same solve in float64 on the same Linv (float32), and in float64 against
the exact result on 16 lanes (fractions; the CPU's plain version beside
it). It prints the card's name and power limit and one JSON line of the
numbers; it exits nonzero if a design does not build or disagrees.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "inv_solve_designs")
SHAPES = ((40, torch.float32), (100, torch.float32), (100, torch.float64))

# design -> (text in the source, its replacement); each must occur once.
EDITS = {
    "kernel": (),
    "no_half_warp": (("    if (m <= 16 * V) {", "    if (false) {"),),
    "prefetch": (("""  for (int i0 = 0; i0 < m; i0 += R) {
    T rows[R][K][V];
    load_rows(rows, L, i0, m, sub, G, live);
    apply_rows<T, V, K, R, G>(rows, r, xa);
  }""", """  T cur[R][K][V];
  load_rows(cur, L, 0, m, sub, G, live);
  for (int i0 = 0; i0 < m; i0 += R) {
    T nxt[R][K][V];
    load_rows(nxt, L, i0 + R, m, sub, G, live);
    apply_rows<T, V, K, R, G>(cur, r, xa);
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int t = 0; t < K; ++t)
#pragma unroll
        for (int j = 0; j < V; ++j) cur[q][t][j] = nxt[q][t][j];
  }"""),),
    "rows_x2": (("constexpr int kRowWords = 16;",
                 "constexpr int kRowWords = 32;"),),
    "transposed_butterfly": (
        ("  for (int q = 0; q < R; ++q) w[q] = group_sum<G>(w[q]);",
         "  for (int h = R / 2, off = G / 2; h >= 1; h /= 2, off /= 2)\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < h; ++j) {\n"
         "      const bool up = threadIdx.x & off;\n"
         "      const T keep = up ? w[j + h] : w[j], send = up ? w[j] : w[j + h];\n"
         "      w[j] = keep + __shfl_xor_sync(kFullMask, send, off);\n"
         "    }\n"
         "  for (int off = G / (2 * R); off >= 1; off /= 2)\n"
         "    w[0] += __shfl_xor_sync(kFullMask, w[0], off);\n"
         "  const T s0 = w[0];\n"
         "  const int first = threadIdx.x & 31 & ~(G - 1);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < R; ++j)\n"
         "    w[j] = __shfl_sync(kFullMask, s0, first + j * (G / R));"),),
    "pairs_both": (("  constexpr bool kPairs = sizeof(T) == 4;",
                    "  constexpr bool kPairs = true;"),),
    "sequential_both": (("  constexpr bool kPairs = sizeof(T) == 4;",
                         "  constexpr bool kPairs = false;"),),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another inv_solve.cu to build beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qpth_tpu_torch.ops.cuda import build, kernels

    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(build.CSRC, "inv_solve.cu")).read()
    sources = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"{name}: '{old}' does not occur once in the source")
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        sources["parent"] = open(args.parent).read()
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.build_all()  # kernel A, which makes the factors
    fns, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name} does not build:\n{log}")
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        fns[name] = {}
        for suf, dt in (("f32", torch.float32), ("f64", torch.float64)):
            fn = getattr(lib, f"qpth_inv_solve_{suf}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name][dt] = fn
    dev = torch.device("cuda")

    def call(name, Linv, rhs, x):
        err = fns[name][Linv.dtype](Linv.data_ptr(), rhs.data_ptr(),
                                    x.data_ptr(), rhs.shape[0], rhs.shape[1],
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"{name}: launch failed (cudaError_t {err})")
        return x

    def factors(B, m, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        C = torch.rand(B, m, m, generator=g, device=dev, dtype=torch.float64)
        R = (C @ C.transpose(1, 2) / m + torch.eye(
            m, device=dev, dtype=torch.float64)).to(dtype)
        dinv = torch.rand(B, m, generator=g, device=dev,
                          dtype=torch.float64).to(dtype) + 0.5
        rhs = torch.rand(B, m, generator=g, device=dev,
                         dtype=torch.float64).to(dtype) - 0.5
        return kernels.factor_inv(R, dinv), rhs

    errors = {}
    for m, dtype in SHAPES + ((13, torch.float64), (37, torch.float32)):
        B = 4097
        Linv, rhs = factors(B, m, dtype, m)
        Linv[2, m // 2, m // 2] = float("nan")
        want = kernels.inv_solve_plain(Linv, rhs)
        dirty = Linv.masked_fill(torch.ones(m, m, dtype=torch.bool,
                                            device=dev).triu(1), float("nan"))
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        for name in fns:
            got = call(name, dirty if name != "parent" else Linv, rhs,
                       torch.empty_like(rhs))
            bad = torch.isnan(got).any(dim=1)
            e = float((got[~bad] - want[~bad]).abs().max()
                      / want[~bad].abs().max())
            errors[f"{name} m={m} {dtype}"] = e
            if bad.tolist() != [k == 2 for k in range(B)] or not e <= tol:
                sys.exit(f"{name} m={m} {dtype}: disagrees with the plain "
                         f"version ({e:.3e}) or the NaN lane spread")

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        return total / 1e3 / reps if total else None

    def events_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    times = {}
    for m, dtype in SHAPES:
        key = f"m={m} {str(dtype).split('.')[-1]}"
        Linv, rhs = factors(4096, m, dtype, 5)
        x = torch.empty_like(rhs)
        order = list(fns) + list(fns)[::-1]
        for name in order:
            def fn():
                return call(name, Linv, rhs, x)

            times.setdefault(key, {}).setdefault(name, []).append(
                dict(device_ms=device_ms(fn), events_ms=events_ms(fn)))
        for name, runs in times[key].items():
            print(f"# {key} {name:18s} device " + " / ".join(
                f"{r['device_ms']:.4f}" for r in runs) + " ms, events " +
                " / ".join(f"{r['events_ms']:.4f}" for r in runs) + " ms")
    # Path 5a with each design in the kernel's place.
    import chip_smoke
    import qpth_tpu_torch as qt

    dg = chip_smoke.sudoku_diag(chip_smoke.B)
    d32 = [torch.tensor(v, dtype=torch.float32, device=dev) for v in dg]
    d64 = [torch.tensor(v, dtype=torch.float64, device=dev) for v in dg]
    ref = qt.solve_qp_diag_full(*d64, config=qt.SolverConfig())
    g = torch.Generator(device=dev).manual_seed(0)
    A = d64[4]
    B = d64[1].shape[0]
    d = 10.0 ** (torch.rand(B, A.shape[1], generator=g, device=dev,
                            dtype=torch.float64) * 8 - 6)
    M = torch.einsum("in,bn,jn->bij", A, d, A).float()
    r_ill = torch.randn(B, A.shape[0], generator=g, device=dev,
                        dtype=torch.float64)

    def lane_rel(a_, b_):
        return ((a_.double() - b_.double()).abs().amax(-1)
                / b_.double().abs().amax(-1).clamp_min(1e-300))

    def parted(a_, b_):
        return torch.nonzero(((a_.double() - b_.double()).abs() - (
            2e-4 + 1e-3 * b_.double().abs())).amax(-1) > 0).flatten().tolist()

    def grads(arrs, config, device):
        args = [a_.clone().requires_grad_(True) for a_ in arrs]
        z_ = qt.solve_qp_diag(*args, config=config, device=device)
        (z_ * z_).sum().backward()
        return [a_.grad for a_ in args]

    def rel(a_, b_):
        return float((a_.cpu() - b_).abs().max() / b_.abs().max())

    n5c = 64
    cfg5c = {k: qt.SolverConfig(eps=1e-9, fused_diag_step=f_)
             for k, f_ in (("composed", False), ("fused", True))}
    d5c = [torch.tensor(v[:n5c] if v.shape[0] == B else v,
                        dtype=torch.float64) for v in dg]
    cpu5c = {k: (qt.solve_qp_diag_full(*d5c, config=c_, device="cpu"),
                 grads(d5c, c_, "cpu")) for k, c_ in cfg5c.items()}
    # exact x = Linv^T (Linv r) on 16 lanes of the ill-conditioned M
    from fractions import Fraction
    M64 = M.double()
    L64 = kernels.factor_inv(M64, torch.zeros(B, A.shape[0], device=dev,
                                              dtype=torch.float64))
    lanes = torch.nonzero(torch.isfinite(L64).all(dim=(1, 2))).flatten()[:16]
    Lx, rx = L64[lanes].cpu(), r_ill[lanes].cpu()
    x_exact = []
    for k in range(len(lanes)):
        Lf = [[Fraction(float(v)) for v in row] for row in Lx[k].tolist()]
        rf = [Fraction(float(v)) for v in rx[k].tolist()]
        w = [sum(a * b for a, b in zip(row, rf)) for row in Lf]
        x_exact.append([float(sum(Lf[i][c] * w[i] for i in range(len(w))))
                        for c in range(len(w))])
    x_exact = torch.tensor(x_exact, dtype=torch.float64)

    def exact_err(x_):
        return float(((x_.cpu() - x_exact).abs().amax(-1)
                      / x_exact.abs().amax(-1)).max())

    plain_exact = exact_err(kernels.inv_solve_plain(Lx, rx))
    print(f"# f64 solve on 16 ill-conditioned lanes against the exact "
          f"result: the CPU's plain version {plain_exact:.3e}")

    path5 = {}
    for name in fns:
        build._libs["inv_solve"] = ctypes.CDLL(os.path.join(
            OUT, f"lib{name}.so"))
        kernels._fns.pop("qpth_inv_solve_f32", None)
        kernels._fns.pop("qpth_inv_solve_f64", None)
        sol = qt.solve_qp_diag_full(*d32, config=qt.SolverConfig())
        solf = qt.solve_qp_diag_full(*d32, config=qt.SolverConfig(
            fused_diag_step=True))
        Linv = kernels.factor_inv(M, torch.zeros(B, A.shape[0], device=dev))
        ok = torch.isfinite(Linv).all(dim=(1, 2))
        e_ill = lane_rel(kernels.inv_solve(Linv, r_ill.float()),
                         kernels.inv_solve_plain(Linv.double(), r_ill))[ok]
        f = {k: dict(median=float(lane_rel(getattr(sol, k),
                                           getattr(ref, k)).median()),
                     max=float(lane_rel(getattr(sol, k),
                                        getattr(ref, k)).max()))
             for k in ("z", "nu")}
        f["fused_vs_composed_lanes"] = {
            k: parted(getattr(solf, k), getattr(sol, k))
            for k in ("z", "lam", "nu")}
        f["ill_conditioned_solve_rel_err"] = {
            q: float(torch.quantile(e_ill, q)) for q in (0.5, 0.9, 0.99)}
        f["f64_ill_conditioned_vs_exact"] = exact_err(kernels.inv_solve(
            L64[lanes].contiguous(), r_ill[lanes].contiguous()))
        d5g = [v.to(dev) for v in d5c]
        for k, c_ in cfg5c.items():
            sol_c = qt.solve_qp_diag_full(*d5g, config=c_)
            g_c = grads(d5g, c_, dev)
            sol_h, g_h = cpu5c[k]
            f[f"path5c_{k}"] = dict(
                z=rel(sol_c.z, sol_h.z), nu=rel(sol_c.nu, sol_h.nu),
                grads={nm: rel(g_c[i], g_h[i])
                       for i, nm in enumerate("qpghAb")},
                iterations=(int(sol_c.stats.iterations),
                            int(sol_h.stats.iterations)))
        path5[name] = f

        def worst(k):
            g_ = f[f"path5c_{k}"]["grads"]
            return f"{max(g_.values()):.3e} ({max(g_, key=g_.get)})"

        print(f"# path 5c {name:18s} " + "; ".join(
            f"{k}: z {f[f'path5c_{k}']['z']:.3e}, gradients max {worst(k)}, "
            f"iterations {f[f'path5c_{k}']['iterations']}" for k in cfg5c)
            + f"; f64 ill-conditioned vs exact "
            f"{f['f64_ill_conditioned_vs_exact']:.3e}")
        print(f"# path 5a {name:18s} z median {f['z']['median']:.3e} max "
              f"{f['z']['max']:.3e}, nu median {f['nu']['median']:.3e} max "
              f"{f['nu']['max']:.3e}; fused/composed part on "
              f"{f['fused_vs_composed_lanes']}; ill-conditioned solve "
              "q50/q90/q99 " + "/".join(
                  f"{v:.3e}" for v in
                  f["ill_conditioned_solve_rel_err"].values()))
    print(json.dumps({"card": card, "registers": regs, "max_rel_err": errors,
                      "times": times, "path5": path5}))


if __name__ == "__main__":
    main()
