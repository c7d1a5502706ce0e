"""Worker of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_intra.py``). Run as

    python _torch_parallel_worker.py <mode> <init_file> <world> <rank> <out>

Each of ``world`` processes joins a gloo group through
``file://<init_file>``, runs every case of ``mode`` ("parallel": batch
sharding and start-up; "intra": tensor parallelism) on the CPU with one
thread, and writes its results to ``<out>`` (an ``.npz``), which the tests
read. The cases' inputs come from the functions below, which the tests call
too; this module imports neither JAX nor ``qpth_tpu``.
"""

import os
import sys
import traceback
from datetime import timedelta

import numpy as np

B1, NZ1, M1, NEQ1 = 16, 8, 6, 2          # tests/test_sharding.py's _args
M_TP, B_TP = 256, 2                      # factor_solve_hybrid_tp
N_QP_TP, NEQ_QP_TP = 256, 16             # solve_qp_tp
N_QP_TP64 = 128                          # solve_qp_tp, float64 (subst)


def make_feasible_qp(rng, nz=10, nineq=3, neq=0, nbatch=None):
    """tests/conftest.py's generator (a copy: conftest imports JAX)."""
    def maybe_batch(shape):
        return (nbatch,) + shape if nbatch else shape

    L = rng.randn(nz, nz)
    Q = L @ L.T + 1e-6 * np.eye(nz)
    G = rng.randn(*maybe_batch((nineq, nz)))
    z0 = rng.randn(nz)
    s0 = rng.rand(*maybe_batch((nineq,)))
    h = G @ z0 + s0
    p = rng.randn(*maybe_batch((nz,)))
    if neq > 0:
        A = rng.randn(*maybe_batch((neq, nz)))
        b = A @ z0
    else:
        A = b = None
    return Q, p, G, h, A, b


def sharding_args(batched_mats=False, seed=7):
    """(Q, p, G, h, A, b) of B1 lanes with NEQ1 equality rows: shared
    matrices and h, b (batched p) or everything batched."""
    rng = np.random.RandomState(seed)
    Q, p, G, h, A, b = make_feasible_qp(
        rng, nz=NZ1, nineq=M1, neq=NEQ1,
        nbatch=B1 if batched_mats else None)
    if batched_mats:
        Q = np.broadcast_to(Q, (B1, NZ1, NZ1)).copy()
    else:
        p = rng.randn(B1, NZ1)
    return [Q, p, G, h, A, b]


def termination_args(seed=7):
    """sharding_args(False) with p of the second half of the lanes scaled
    100x: in float32 under the default max_iter those lanes, alone, close
    their per-lane windows one iteration after the first half's, so two
    ranks' shards end apart unless their exit test is reduced."""
    args = sharding_args(False, seed)
    args[1] = args[1].copy()
    args[1][B1 // 2:] *= 100.0
    return args


def mixed_args(seed=7):
    """Shared Q, batched G, p, h: the Ruiz norms collapse over the batch."""
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(seed), nz=8,
                                        nineq=6, nbatch=B1)
    return [Q, p, G, h, None, None]


def diag_args(seed=7):
    """tests/test_sharding.py's diagonal-tier problem."""
    rng = np.random.RandomState(seed)
    n, neq = 8, 3
    q = 0.5 + rng.rand(B1, n)
    g = -(0.5 + rng.rand(B1, n))
    x0 = rng.randn(n)
    h = g * x0 + rng.rand(B1, n)
    p = rng.randn(B1, n)
    A = rng.randn(neq, n)
    b = np.broadcast_to(A @ x0, (B1, neq)).copy()
    return [q, p, g, h, A, b]


def banded_args(seed=7):
    """tests/test_sharding.py's block-tridiagonal problem."""
    rng = np.random.RandomState(seed)
    nb, bs = 4, 4
    n = nb * bs
    Ld = np.tril(rng.randn(B1, nb, bs, bs) * 0.3) + np.eye(bs) * 1.5
    Qd = np.einsum("bnij,bnkj->bnik", Ld, Ld)
    Qe = 0.2 * rng.randn(B1, nb - 1, bs, bs)
    Qd[:, 1:] += np.einsum("bnij,bnkj->bnik", Qe, Qe)
    g = np.where(np.abs(rng.randn(B1, n)) < 0.3, 0.7, rng.randn(B1, n))
    z0 = rng.randn(B1, n)
    h = g * z0 + rng.rand(B1, n) + 0.2
    p = rng.randn(B1, n)
    return [Qd, Qe, p, g, h]


def tp_matrix(dtype_name, m=M_TP, B=B_TP, seed=3):
    """T (B, m, m) SPD, v and dinv (B, m): test_intra_tp.py's draw."""
    rng = np.random.RandomState(seed)
    L = np.tril(rng.randn(B, m, m) * 0.1) + 3 * np.eye(m)
    T = L @ L.transpose(0, 2, 1)
    v = rng.randn(B, m)
    dinv = 0.5 + rng.rand(B, m)
    return [a.astype(dtype_name) for a in (T, v, dinv)]


def prefactor_args(neq, nz=32, nineq=16, seed=7):
    return make_feasible_qp(np.random.RandomState(seed), nz=nz,
                            nineq=nineq, neq=neq, nbatch=8)


def huge_qp(n, neq=0, dtype_name="float32", seed=11):
    """One QP (B = 1) as in test_intra_tp.py's end-to-end draws: a gram
    plus identity Q, G and A scaled by 1/sqrt(n), h strictly feasible."""
    rng = np.random.RandomState(seed)
    W = rng.randn(n, n) / np.sqrt(n)
    Q = W @ W.T + np.eye(n)
    G = rng.randn(n, n) / np.sqrt(n)
    z0 = rng.randn(n)
    h = G @ z0 + rng.rand(n) + 0.1
    p = rng.randn(n)
    out = [Q, p, G, h]
    if neq:
        A = rng.randn(neq, n) / np.sqrt(n)
        out += [A, A @ z0]
    else:
        out += [None, None]
    return [None if a is None else a.astype(dtype_name)[None] for a in out]


def local(arrs, ranks, rank, world, B):
    """This rank's shard of each array: those of rank ``ranks[i]`` with a
    leading dimension of B are cut to the rank's lanes, the rest are
    whole."""
    per = B // world
    out = []
    for a, r in zip(arrs, ranks):
        if a is not None and a.ndim == r and a.shape[0] == B:
            a = a[rank * per:(rank + 1) * per]
        out.append(a)
    return out


RANKS6 = (3, 2, 3, 2, 3, 2)


def _t(torch, arrs, dtype, grad=()):
    out = []
    for i, a in enumerate(arrs):
        if a is None:
            out.append(None)
            continue
        t = torch.tensor(np.ascontiguousarray(a), dtype=dtype)
        out.append(t.requires_grad_(True) if i in grad else t)
    return out


def run_parallel(torch, dist, rank, world, res):
    import qpth_tpu_torch as qt
    from qpth_tpu_torch.parallel import (batch_sharding, init_multihost,
                                         local_batch_slice, solve_qp_sharded)

    group = dist.group.WORLD
    f64, f32 = torch.float64, torch.float32
    cfg = qt.SolverConfig()
    # (i) f64, shared and batched matrices, 2 equality rows.
    for tag, bm in (("shared", False), ("batched", True)):
        args = _t(torch, local(sharding_args(bm), RANKS6, rank, world, B1),
                  f64)
        res[f"i_{tag}_z"] = solve_qp_sharded(
            *args, group=group, config=cfg, device="cpu").detach().numpy()
    # (ii) f32, the default max_iter: per-lane termination, the shards'
    # lanes closing at different iterations.
    args = _t(torch, local(termination_args(), RANKS6, rank, world, B1),
              f32)
    res["ii_z"] = solve_qp_sharded(*args, group=group, config=cfg,
                                   device="cpu").detach().numpy()
    sol = qt.solve_qp_full(*args, config=qt.SolverConfig(
        process_group=group), device="cpu")
    res["ii_full_z"] = sol.z.numpy()
    res["ii_its"] = int(sol.stats.iterations)
    # (ii') f32 substitution mode: the per-lane windows close on float32
    # noise before the score reaches eps, so the window decides the exit.
    args = _t(torch, local(sharding_args(False), RANKS6, rank, world, B1),
              f32)
    sol = qt.solve_qp_full(*args, config=qt.SolverConfig(
        solve_method="subst", process_group=group), device="cpu")
    res["iiw_z"] = sol.z.numpy()
    res["iiw_its"] = int(sol.stats.iterations)
    # (iii) gradients of p, h and of the shared Q and G.
    args = _t(torch, local(sharding_args(False), RANKS6, rank, world, B1),
              f64, grad=(0, 1, 2, 3))
    z = solve_qp_sharded(*args, group=group, config=cfg, device="cpu")
    (z * z).sum().backward()
    res["iii_z"] = z.detach().numpy()
    for name, i in (("Q", 0), ("p", 1), ("G", 2), ("h", 3)):
        res[f"iii_d{name}"] = args[i].grad.numpy()
    # (iv) the diagonal and banded tiers with the group.
    gcfg = qt.SolverConfig(process_group=group)
    args = _t(torch, local(diag_args(), (2, 2, 2, 2, 3, 2), rank, world,
                           B1), f64)
    res["iv_diag_z"] = qt.solve_qp_diag(*args, config=gcfg,
                                        device="cpu").numpy()
    args = _t(torch, local(banded_args(), (4, 4, 2, 2, 2), rank, world, B1),
              f64)
    res["iv_band_z"] = qt.solve_qp_banded(*args, config=gcfg,
                                          device="cpu").numpy()
    # (v) mixed batches: the collapsed Ruiz norms reduce over the group.
    args = _t(torch, local(mixed_args(), RANKS6, rank, world, B1), f32)
    res["v_z"] = solve_qp_sharded(
        *args, group=group, config=qt.SolverConfig(max_iter=8),
        device="cpu").detach().numpy()
    # (v') every collective of a sharded solve with shared matrices under
    # the default config: count the calls and their sizes.
    calls = []
    orig = dist.all_reduce, dist.broadcast

    def all_reduce(t, *a, **k):
        calls.append(("all_reduce", t.numel()))
        return orig[0](t, *a, **k)

    def broadcast(t, *a, **k):
        calls.append(("broadcast", t.numel()))
        return orig[1](t, *a, **k)

    dist.all_reduce, dist.broadcast = all_reduce, broadcast
    try:
        for dt, tag in ((f64, "f64"), (f32, "f32")):
            calls.clear()
            args = _t(torch, local(sharding_args(False), RANKS6, rank,
                                   world, B1), dt)
            solve_qp_sharded(*args, group=group, config=cfg, device="cpu")
            res[f"vp_{tag}_kinds"] = np.array([c[0] for c in calls])
            res[f"vp_{tag}_numels"] = np.array([c[1] for c in calls])
    finally:
        dist.all_reduce, dist.broadcast = orig
    # (vi) an uneven batch raises on every rank; the start-up helpers.
    args = _t(torch, sharding_args(False), f64)
    n_lanes = 8 if rank == 0 else 6
    args[1] = args[1][:n_lanes]
    try:
        solve_qp_sharded(*args, group=group, device="cpu")
        res["vi_uneven"] = "no error"
    except ValueError as e:
        res["vi_uneven"] = str(e)
    sl = local_batch_slice(10, group)
    res["vi_slice"] = np.array([sl.start, sl.stop])
    try:
        local_batch_slice(9, group)
        res["vi_slice9"] = "no error"
    except ValueError as e:
        res["vi_slice9"] = str(e)
    res["vi_shard"] = batch_sharding(group)(torch.arange(10)).numpy()
    init_multihost()          # a group exists: a no-op
    res["vi_world"] = dist.get_world_size()


def run_intra(torch, dist, rank, world, res):
    import qpth_tpu_torch as qt
    from qpth_tpu_torch.parallel import (factor_solve_hybrid_tp,
                                         prefactor_qp_tp, solve_qp_tp)
    from qpth_tpu_torch.parallel.intra import tp_band

    group = dist.group.WORLD
    for dt in ("float64", "float32"):
        T, v, dinv = (torch.tensor(a) for a in tp_matrix(dt))
        r0, r1 = tp_band(M_TP, group)
        fac, x = factor_solve_hybrid_tp(T[:, r0:r1], v, group=group,
                                        dinv=dinv)
        res[f"fs_{dt}_x"] = x.numpy()
        res[f"fs_{dt}_bytes"] = fac.nbytes()
    try:
        factor_solve_hybrid_tp(torch.eye(192)[None, :96], torch.ones(1, 192),
                               group=group)
        res["misaligned"] = "no error"
    except ValueError as e:
        res["misaligned"] = str(e)
    cfg = qt.SolverConfig()
    for neq in (0, 4):
        Q, _, G, _, A, _ = _t(torch, prefactor_args(neq), torch.float64)
        f = prefactor_qp_tp(Q, G, A, group=group, config=cfg, device="cpu")
        for name, val in f._asdict().items():
            if isinstance(val, torch.Tensor):
                res[f"pf{neq}_{name}"] = val.numpy()
        res[f"pf{neq}_none"] = np.array(
            [k for k, v in f._asdict().items() if v is None])
    args = _t(torch, prefactor_args(4, nz=24, nineq=12), torch.float64)
    f = prefactor_qp_tp(args[0], args[2], args[4], group=group, device="cpu")
    res["tpf_z"] = qt.solve_qp_full(*args, factors=f, device="cpu").z.numpy()
    p = args[1].clone().requires_grad_(True)
    z = qt.solve_qp(args[0], p, *args[2:], factors=f, device="cpu")
    (z * z).sum().backward()
    res["tpf_dp"] = p.grad.numpy()
    for tag, n, neq, dt, it in (("f32", N_QP_TP, 0, "float32", 8),
                                ("f32_eq", N_QP_TP, NEQ_QP_TP, "float32", 6),
                                ("f64", N_QP_TP64, 0, "float64", 8)):
        args = _t(torch, huge_qp(n, neq, dt), getattr(torch, dt))
        sol = solve_qp_tp(*args, group=group, device="cpu",
                          config=qt.SolverConfig(check_Q_spd=False,
                                                 verbose=-1, max_iter=it))
        res[f"tp_{tag}_z"] = sol.z.numpy()
        res[f"tp_{tag}_nu"] = sol.nu.numpy()
        res[f"tp_{tag}_its"] = int(sol.stats.iterations)


def launch(mode, tmp_dir, world=2, timeout=120.0):
    """Start ``world`` ranks of this script in ``mode`` with a rendezvous
    file under ``tmp_dir`` and wait for them, at most ``timeout`` seconds
    in all: a rank that fails or hangs fails the caller, and the others are
    killed. Returns each rank's results (dicts of arrays)."""
    import subprocess
    import time

    init = os.path.join(str(tmp_dir), f"rdv_{mode}")
    outs = [os.path.join(str(tmp_dir), f"{mode}_{r}.npz")
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, init, str(world),
         str(r), outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(world)]
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > t_end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {mode} exited "
                               f"{p.returncode}:\n{log}")
    return [dict(np.load(o)) for o in outs]


def main():
    mode, init_file, world, rank, out = sys.argv[1:6]
    world, rank = int(world), int(rank)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    res = {}
    try:
        {"parallel": run_parallel, "intra": run_intra}[mode](
            torch, dist, rank, world, res)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    np.savez(out, **res)
    dist.destroy_process_group()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main()
