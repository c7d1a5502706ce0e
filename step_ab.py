"""The fused IPM step of this tree against another tree's, on one card.

    python3 step_ab.py --parent PATH [--B 4096] [--m 100] [--reps 20]
                       [--out build/step_ab.json]

PATH is a checkout of the other tree, e.g. ``git archive <commit> | tar -x
-C build/parent`` (``build/`` is ignored by git). Each tree's kernels are
built by its own ``qpth_tpu_torch/ops/cuda/build.py`` into its own
``build/qpth_tpu_torch/`` and called through their plain C interface, so the
two trees' libraries live side by side in one process. The script

1. holds this tree's outputs to the other tree's bit for bit: the three
   fused steps (x-free, direct x, equality rows) in float32 and float64 at
   B lanes and width m (nz = m, neq = m / 2), with every operand per lane,
   with R (and every matrix) shared, and with 0 and 2 Gondzio correctors;
   then at a few more widths on fewer lanes, either side of the float32
   6-warp blocks' limit (m = 100, kernels.ipm_step_shape) and of the
   32-row panels; and
   kernels A (three variants), C (with the shift, and with its solve) and E
   at width m. A differing lane is counted and its largest difference
   printed;
2. times each of those kernels at width m on both sides, in the order
   other, this, this, other, repeated: CUDA events around each launch
   (median) and the profiler's device time a launch (mean);
3. reads one block's clock64() stamps in the x-free step on both sides:
   a copy of each tree's sources is built with every block barrier of the
   step's headers timed, the one-warp chains (chol_diag_block, fwd_chain,
   back_chain), the register-tile updates (update_tile) and the panels'
   column solves (panel_solve_column) wrapped, the staging (kernel entry
   to the factor) stamped, and the middle block's threads 0 (warp 0, which
   runs the chains) and 32 (warp 1, which updates) adding up the cycles of
   each phase. The SM's other blocks run meanwhile, so read the stamps as
   shares of a block's life.

It prints one line per comparison and timing, and writes all of it to
--out as JSON. Exit code 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
F32, F64 = torch.float32, torch.float64
SUFFIX = {F32: "f32", F64: "f64"}
#: (library stem, symbol prefix, pointers, ints) of each kernel.
STEPS = {"xfree": ("ipm_step_xfree", "qpth_ipm_step_xfree", 8, 4),
         "x": ("ipm_step", "qpth_ipm_step", 11, 5),
         "eq": ("ipm_step_eq", "qpth_ipm_step_eq", 19, 6)}
OTHERS = {"factor_inv": ("factor_inv", "qpth_factor_inv", 6, 3),
          "chol": ("chol", "qpth_chol", 5, 3),
          "trinv": ("trinv", "qpth_trinv", 2, 2)}


class Tree:
    """One tree's kernel libraries, built by its own build module."""

    def __init__(self, root: Path, tag: str):
        self.root, self.tag = root, tag
        path = root / "qpth_tpu_torch" / "ops" / "cuda" / "build.py"
        spec = importlib.util.spec_from_file_location(f"_build_{tag}", path)
        self.build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.build)
        self.fns: dict[str, object] = {}

    def fn(self, kind, dtype, table):
        stem, prefix, n_ptr, n_int = table[kind]
        name = f"{prefix}_{SUFFIX[dtype]}"
        if name not in self.fns:
            f = getattr(self.build.load(stem), name)
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
            self.fns[name] = f
        return self.fns[name]


def launch(f, *args):
    err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError_t {err}")


def step_operands(B, m, nz, neq, shared, dtype, dev, seed):
    """The fused steps' operands: R = C C^T / m + I (SPD), the other
    matrices uniform in [-0.25, 0.25], s, z in [0.5, 1.5]; every matrix
    with batch 1 when ``shared``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape, lo=-0.25, hi=0.25):
        return torch.rand(*shape, generator=g, device=dev,
                          dtype=F64).mul_(hi - lo).add_(lo).to(dtype)

    b = 1 if shared else B
    C = torch.rand(b, m, m, generator=g, device=dev, dtype=F64)
    R = (C @ C.transpose(1, 2) / m
         + torch.eye(m, device=dev, dtype=F64)).to(dtype)
    return dict(R=R, iGT=u(b, nz, m), S21=u(b, m, neq), W=u(b, neq, m),
                iS11=u(b, neq, neq), S11=u(b, neq, neq), iAT=u(b, nz, neq),
                x=u(B, nz, lo=-1, hi=1), s=u(B, m, lo=0.5, hi=1.5),
                z=u(B, m, lo=0.5, hi=1.5), y=u(B, neq, lo=-1, hi=1),
                q=u(B, m, lo=-1, hi=1), ip=u(B, nz, lo=-1, hi=1),
                rb=u(B, neq, lo=-1, hi=1))


def batched_bits(B, *mats):
    return sum(1 << k for k, M in enumerate(mats) if B > 1 and M.shape[0] == B)


def run_step(tree, mode, t, nc):
    """One launch of ``mode``'s step; returns its outputs."""
    R, s = t["R"], t["s"]
    B, m = s.shape
    f = tree.fn(mode, R.dtype, STEPS)
    e = torch.empty_like
    if mode == "xfree":
        outs = [e(s), e(s), e(s), torch.empty(B, dtype=R.dtype, device=R.device)]
        launch(f, R.data_ptr(), s.data_ptr(), t["z"].data_ptr(),
               t["q"].data_ptr(), *(o.data_ptr() for o in outs), B, m,
               int(R.shape[0] > 1), nc)
        return outs
    nz = t["x"].shape[-1]
    if mode == "x":
        outs = [e(t["x"]), e(s), e(s), torch.empty(B, dtype=R.dtype,
                                                   device=R.device)]
        launch(f, R.data_ptr(), t["iGT"].data_ptr(), t["x"].data_ptr(),
               s.data_ptr(), t["z"].data_ptr(), t["q"].data_ptr(),
               t["ip"].data_ptr(), *(o.data_ptr() for o in outs), B, m, nz,
               batched_bits(B, R, t["iGT"]), nc)
        return outs
    neq = t["y"].shape[-1]
    mats = [t[k] for k in ("R", "iGT", "S21", "W", "iS11", "S11", "iAT")]
    outs = [e(t["x"]), e(s), e(s), e(t["y"]),
            torch.empty(B, dtype=R.dtype, device=R.device)]
    vecs = [t[k] for k in ("x", "s", "z", "y", "q", "ip", "rb")]
    launch(f, *(v.data_ptr() for v in mats + vecs + outs), B, m, nz, neq,
           batched_bits(B, *mats), nc)
    return outs


def other_operands(B, m, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = torch.rand(B, m, m, generator=g, device=dev, dtype=F64)
    R = (C @ C.transpose(1, 2) / m).to(dtype)
    v = [torch.rand(B, m, generator=g, device=dev, dtype=F64).add_(0.5)
         .to(dtype) for _ in range(3)]
    return R, v


def run_other(tree, kind, R, vecs):
    """Kernel A (variant by how many of dinv, rhs, z), C (dinv, rhs) or E
    (Lt = R's upper triangle, made well-conditioned by the caller)."""
    B, m = R.shape[0], R.shape[-1]
    f = tree.fn(kind.split(":")[0], R.dtype, OTHERS)
    M = torch.empty_like(R)
    ptr = lambda v: v.data_ptr() if v is not None else None  # noqa: E731
    if kind == "trinv":
        launch(f, R.data_ptr(), M.data_ptr(), B, m)
        return [M]
    x = torch.empty_like(vecs[0]) if len(vecs) > 1 else None
    full = list(vecs) + [None] * (3 - len(vecs))
    if kind.startswith("factor_inv"):
        launch(f, R.data_ptr(), *(ptr(v) for v in full), M.data_ptr(),
               ptr(x), B, m, 1)
    else:
        launch(f, R.data_ptr(), ptr(full[0]), ptr(full[1]), M.data_ptr(),
               ptr(x), B, m, 1)
    return [M] if x is None else [M, x]


def bits(a):
    return a.view(torch.int64 if a.dtype == F64 else torch.int32)


def compare(tag, got, want, log):
    """Counts the lanes where any output differs in any bit."""
    B = got[0].shape[0]
    lanes = torch.zeros(B, dtype=torch.bool, device=got[0].device)
    worst = 0.0
    for a, b in zip(got, want):
        d = bits(a) != bits(b)
        lanes |= d.reshape(B, -1).any(dim=1)
        if d.any():
            worst = max(worst, float((a.double() - b.double()).abs()
                                     .nan_to_num(float("inf")).max()))
    n = int(lanes.sum())
    print(f"# bits {tag}: {'identical' if n == 0 else f'{n} lanes differ'}"
          + (f", largest difference {worst:.3e}" if n else ""))
    log.append(dict(tag=tag, lanes_differ=n, largest=worst))
    return n


def timed(call, reps):
    """CUDA events around each of ``reps`` launches (ms, median) and the
    profiler's device time a launch (ms, mean)."""
    call()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in ev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.self_device_time_total > 0) / 1e3 / reps
    return ms, dev


def ab_times(tag, calls, reps, log):
    """calls: {side: callable}; order other, this, this, other."""
    out = {k: [] for k in calls}
    for side in ("other", "this", "this", "other"):
        out[side].append(timed(calls[side], reps))
    row = {k: dict(event_ms=statistics.median(v[0] for v in vals),
                   device_ms=statistics.median(v[1] for v in vals))
           for k, vals in out.items()}
    o, t = row["other"], row["this"]
    print(f"# time {tag}: other {o['event_ms']:.4f} ms (device "
          f"{o['device_ms']:.4f}), this {t['event_ms']:.4f} ms (device "
          f"{t['device_ms']:.4f}), device ratio "
          f"{t['device_ms'] / o['device_ms']:.3f}")
    log.append(dict(tag=tag, **{f"{k}_{m}": v[m] for k, v in row.items()
                                for m in ("event_ms", "device_ms")}))


# ---------------------------------------------------------------------------
# clock64() phase stamps
# ---------------------------------------------------------------------------

PHASES = ("chains", "tile_updates", "barriers", "whole", "barrier_count",
          "staging", "column_solves")
NP = len(PHASES)

STAMP_DEFS = r"""
// Phase stamps of one block (an instrumented copy made by step_ab.py).
__device__ long long qpth_stamps[2][7];
__device__ int qpth_stamp_block;
__device__ __forceinline__ void qpth_stamp_add(int phase, long long t0) {
  if (blockIdx.x != qpth_stamp_block) return;
  const int s = threadIdx.x == 0 ? 0 : threadIdx.x == 32 ? 1 : -1;
  if (s < 0) return;
  qpth_stamps[s][phase] += clock64() - t0;
  if (phase == 2) qpth_stamps[s][4] += 1;
}
__device__ __forceinline__ void qpth_sync() {
  const long long t0 = clock64();
  __syncthreads();
  qpth_stamp_add(2, t0);
}
"""

STAMP_WRAPPERS = r"""
template <typename T, bool SHIFT, typename... A>
__device__ __forceinline__ void chol_diag_block(A... a) {
  const long long t0 = clock64();
  chol_diag_block_impl<T, SHIFT>(a...);
  qpth_stamp_add(0, t0);
}
template <typename T, typename... A>
__device__ __forceinline__ void fwd_chain(const T* Tm, A... a) {
  const long long t0 = clock64();
  fwd_chain_impl(Tm, a...);
  qpth_stamp_add(0, t0);
}
template <typename T, typename... A>
__device__ __forceinline__ void back_chain(const T* Tm, A... a) {
  const long long t0 = clock64();
  back_chain_impl(Tm, a...);
  qpth_stamp_add(0, t0);
}
template <typename T, int MI, typename... A>
__device__ __forceinline__ void update_tile(A... a) {
  const long long t0 = clock64();
  update_tile_impl<T, MI>(a...);
  qpth_stamp_add(1, t0);
}
template <typename T, typename... A>
__device__ __forceinline__ void panel_solve_column(const T* Tm, A... a) {
  const long long t0 = clock64();
  panel_solve_column_impl(Tm, a...);
  qpth_stamp_add(6, t0);
}

"""

STAMP_EXPORTS = r"""
extern "C" int qpth_stamps_reset(int block) {
  long long zero[14] = {0};
  cudaError_t e = cudaMemcpyToSymbol(qpth::qpth_stamps, zero, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(qpth::qpth_stamp_block, &block, sizeof(int));
  return int(e);
}
extern "C" int qpth_stamps_read(long long* out) {
  return int(cudaMemcpyFromSymbol(out, qpth::qpth_stamps,
                                  14 * sizeof(long long)));
}
"""


def _sub(src, pattern, repl, name):
    out, n = re.subn(pattern, repl, src, count=1)
    if n != 1:
        raise RuntimeError(f"stamps: no anchor {pattern!r} in {name}")
    return out


def stamped_lib(tree):
    """The x-free step built from an instrumented copy of ``tree``'s
    sources (in its build directory)."""
    src = tree.root / "qpth_tpu_torch" / "csrc"
    out = tree.root / "build" / "step_ab_stamps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in src.glob("*.cuh"):
        s = f.read_text().replace("__syncthreads();", "qpth_sync();")
        if f.name == "common.cuh":
            s = _sub(s, r"namespace qpth \{\n",
                     lambda m_: m_.group(0) + STAMP_DEFS, f.name)
        if f.name == "panel.cuh":
            for fn in ("chol_diag_block", "fwd_chain", "back_chain",
                       "update_tile", "panel_solve_column"):
                s = _sub(s, rf"void {fn}\(", f"void {fn}_impl(", f.name)
            s = _sub(s, r"\n// Lt = chol\(T \+ diag\(dinv\)\)\^T in place",
                     lambda m_: "\n" + STAMP_WRAPPERS + m_.group(0)[1:],
                     f.name)
        if f.name == "ipm_step_body.cuh":
            s = _sub(s, r"ipm_step_kernel\(StepArgs<T> a\) \{\n",
                     lambda m_: m_.group(0)
                     + "  const long long qpth_t_begin = clock64();\n",
                     f.name)
            s = _sub(s, r"\n  factor_panels<T, true, true",
                     lambda m_: "\n  qpth_stamp_add(5, qpth_t_begin);"
                     + m_.group(0), f.name)
            s = _sub(s, r"if \(i == 0\) a\.a_out\[b\] = alpha2;\n",
                     lambda m_: m_.group(0)
                     + "  qpth_stamp_add(3, qpth_t_begin);\n", f.name)
        (out / f.name).write_text(s)
    cu = out / "ipm_step_xfree.cu"
    cu.write_text((src / "ipm_step_xfree.cu").read_text() + STAMP_EXPORTS)
    lib = out / "libipm_step_xfree_stamps.so"
    proc = subprocess.run([tree.build._nvcc(), *tree.build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"stamps build failed ({tree.tag}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def stamps(tree, lib, t, nc, log, tag):
    f = getattr(lib, f"qpth_ipm_step_xfree_{SUFFIX[t['R'].dtype]}")
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    lib.qpth_stamps_reset.argtypes = [ctypes.c_int]
    R, s = t["R"], t["s"]
    B, m = s.shape
    outs = [torch.empty_like(s) for _ in range(3)] + [
        torch.empty(B, dtype=R.dtype, device=R.device)]
    args = (R.data_ptr(), s.data_ptr(), t["z"].data_ptr(), t["q"].data_ptr(),
            *(o.data_ptr() for o in outs), B, m, int(R.shape[0] > 1), nc)
    launch(f, *args)  # warm
    torch.cuda.synchronize()
    if lib.qpth_stamps_reset(B // 2) != 0:
        raise RuntimeError("stamps reset failed")
    launch(f, *args)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * NP))()
    if lib.qpth_stamps_read(buf) != 0:
        raise RuntimeError("stamps read failed")
    rows = [dict(zip(PHASES, buf[NP * k:NP * (k + 1)])) for k in range(2)]
    for who, r in zip(("thread 0", "thread 32"), rows):
        whole = max(r["whole"], 1)
        print(f"# stamps {tag} {tree.tag} {who}: whole {r['whole']} cycles; "
              + ", ".join(f"{k} {100 * r[k] / whole:.1f}%" for k in PHASES
                          if k not in ("whole", "barrier_count"))
              + f" ({r['barrier_count']} barriers passed)")
    log.append(dict(tag=tag, tree=tree.tag, thread0=rows[0],
                    thread32=rows[1]))


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "step_ab.json")
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# card: {smi}; torch {torch.__version__}")
    sides = {"this": Tree(ROOT, "this"), "other": Tree(args.parent.resolve(),
                                                       "other")}
    with ThreadPoolExecutor(4) as pool:  # both trees' builds at once
        stamped = {k: pool.submit(stamped_lib, tr) for k, tr in sides.items()}
        for f in [pool.submit(tr.build.build_all) for tr in sides.values()]:
            f.result()
        stamped = {k: f.result() for k, f in stamped.items()}
    from qpth_tpu_torch.ops.cuda import kernels
    report = dict(card=smi, B=args.B, m=args.m, bits=[], times=[],
                  stamps=[], blocks_per_sm={})
    B, m = args.B, args.m
    n_bad = 0

    # 1. bits: the steps at (B, m), every mode, dtype, sharing, correctors;
    # then more widths on fewer lanes.
    widths = [(B, m)] + [(512, w) for w in (8, 31, 33, 101, 128, 129, 160)
                         if w != m]
    for Bw, mw in widths:
        for dtype in (F32, F64):
            for shared in (False, True):
                t = step_operands(Bw, mw, mw, max(1, mw // 2), shared, dtype,
                                  dev, seed=mw + 7 * shared)
                for mode in STEPS:
                    for nc in (0, 2):
                        got = run_step(sides["this"], mode, t, nc)
                        want = run_step(sides["other"], mode, t, nc)
                        torch.cuda.synchronize()
                        n_bad += compare(
                            f"{mode} {SUFFIX[dtype]} B={Bw} m={mw} "
                            f"shared={shared} nc={nc}", got, want,
                            report["bits"])
    for dtype in (F32, F64):
        R, (dinv, rhs, z) = other_operands(B, m, dtype, dev, seed=3)
        Lt = torch.triu(R) + m * torch.eye(m, device=dev, dtype=dtype)
        for kind, vecs, M in (("factor_inv", [dinv], R),
                              ("factor_inv:rhs", [dinv, rhs], R),
                              ("factor_inv:rz", [dinv, rhs, z], R),
                              ("chol", [dinv], R), ("chol:rhs", [dinv, rhs], R),
                              ("trinv", [], Lt.contiguous())):
            got = run_other(sides["this"], kind, M, vecs)
            want = run_other(sides["other"], kind, M, vecs)
            torch.cuda.synchronize()
            n_bad += compare(f"{kind} {SUFFIX[dtype]} B={B} m={m}", got, want,
                             report["bits"])

    # 2. times at (B, m).
    for dtype in (F32, F64):
        t = step_operands(B, m, m, m // 2, False, dtype, dev, seed=1)
        for mode, nc in (("xfree", 0), ("xfree", 2), ("x", 0), ("eq", 0)):
            ab_times(f"{mode} {SUFFIX[dtype]} nc={nc}",
                     {k: (lambda tr=tr, mo=mode, n=nc: run_step(tr, mo, t, n))
                      for k, tr in sides.items()}, args.reps, report["times"])
            warps, blocks = kernels.ipm_step_shape(
                m, dtype, mode, nz=m if mode != "xfree" else 0,
                neq=m // 2 if mode == "eq" else 0)
            report["blocks_per_sm"][f"{mode} {SUFFIX[dtype]}"] = blocks
            print(f"# this tree's {mode} {SUFFIX[dtype]} m={m}: "
                  f"{warps} warps, {blocks} blocks an SM")
        R, (dinv, rhs, z) = other_operands(B, m, dtype, dev, seed=3)
        Lt = (torch.triu(R) + m * torch.eye(m, device=dev,
                                            dtype=dtype)).contiguous()
        for kind, vecs, M in (("factor_inv", [dinv], R),
                              ("factor_inv:rhs", [dinv, rhs], R),
                              ("factor_inv:rz", [dinv, rhs, z], R),
                              ("chol", [dinv], R), ("trinv", [], Lt)):
            ab_times(f"{kind} {SUFFIX[dtype]}",
                     {k: (lambda tr=tr, kd=kind, v=vecs, M_=M:
                          run_other(tr, kd, M_, v))
                      for k, tr in sides.items()}, args.reps, report["times"])

    # 3. stamps of the middle block of the x-free step at (B, m).
    for dtype in (F32, F64):
        t = step_operands(B, m, m, 1, False, dtype, dev, seed=1)
        for k, tree in sides.items():
            stamps(tree, stamped[k], t, 0, report["stamps"],
                   f"xfree {SUFFIX[dtype]}")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"# {n_bad} comparisons differ; report in {args.out}")
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
