"""Wrappers of the port's two CUDA kernels, their plain PyTorch versions,
and the launch counters.

Kernel A, ``factor_inv`` (``csrc/factor_inv.cu``), in three variants:
  * ``factor_inv(R, dinv)``            -> Linv = inv(chol(R + diag(dinv)))
  * ``factor_inv(R, dinv, rhs)``       -> (Linv, T^-1 rhs)
  * ``factor_inv(R, dinv, rhs, z)``    -> (Linv, T^-1 (rhs - R z))
Kernel B, ``ipm_step_xfree`` (``csrc/ipm_step_xfree.cu``): one whole x-free
Mehrotra iteration for neq = 0.

Layout is batch-major throughout: R (bR, m, m) with bR in {1, B} (a shared
R is read with batch stride 0), vectors (B, m), Linv (B, m, m) with row i
of inv(L) in row i (lower triangular).

Dispatch is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel, and a failed build or launch
raises. The plain versions compute the same recurrence as the kernels
(pivot by pivot, ``rsqrt`` pivots, NaN for a non-SPD lane) and are what the
CPU tests and ``chip_smoke.py`` hold the kernels against.

``LAUNCHES`` counts kernel launches per variant; a wrapper adds one only
where it launches its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: Shared memory one thread block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
#: m-vectors a kernel keeps in shared memory beside its two m x m tiles
#: (``kSmemVectors`` in csrc/common.cuh).
SMEM_VECTORS = 8
#: Threads per block (``kThreads`` in csrc/common.cuh): bounds m as well.
THREADS = 256

LAUNCHES = {"factor_inv": 0, "factor_inv_solve": 0,
            "factor_inv_solve_rz": 0, "ipm_step_xfree": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(m: int, dtype) -> bool:
    """Whether one QP's m x m working set fits a thread block: two m x m
    tiles plus SMEM_VECTORS m-vectors within 227 KB, and m <= THREADS.
    float32: m <= 168; float64: m <= 118."""
    elt = torch.empty((), dtype=dtype).element_size()
    return (m <= THREADS
            and (2 * m * m + SMEM_VECTORS * m) * elt <= SMEM_LIMIT)


def _fn(stem: str, name: str, n_ptr: int, n_int: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(stem), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, R, vecs, B, m):
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {R.device}")
    if R.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {R.dtype} not supported "
                        "(float32 or float64)")
    if R.dim() != 3 or R.shape[1:] != (m, m) or R.shape[0] not in (1, B):
        raise ValueError(f"{name}: R must be (1 or {B}, {m}, {m}), "
                         f"got {tuple(R.shape)}")
    for v in (R,) + vecs:
        if v.dtype != R.dtype or v.device != R.device:
            raise ValueError(f"{name}: all operands must share R's dtype "
                             "and device")
        if not v.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for v in vecs:
        if v.shape != (B, m):
            raise ValueError(f"{name}: vectors must be ({B}, {m}), "
                             f"got {tuple(v.shape)}")
    if R.device.type == "cuda" and not fits(m, R.dtype):
        raise ValueError(f"{name}: m = {m} exceeds the one-block shared "
                         f"memory fit for {R.dtype}")


def _launch_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError_t {err})")


# ---------------------------------------------------------------------------
# Kernel A: factor_inv
# ---------------------------------------------------------------------------

def factor_inv(R, dinv, rhs=None, z=None):
    """Linv = inv(chol(R + diag(dinv))), with ``rhs`` also x = T^-1 rhs,
    with ``rhs`` and ``z`` x = T^-1 (rhs - R z).

    Replaces the TPU kernel ``qpth_tpu/ops/pallas/lanes.py::_factor_inv_call``
    (``factor_inv_lanes`` / ``factor_inv_solve_lanes`` /
    ``factor_inv_solve_rz_lanes``). On the H100 it is bound by bytes: R in
    and Linv out once (>= 0.098 ms at B = 4096, m = 100, f32). One block per
    QP keeps R, Linv and the current column of L in shared memory, so no
    intermediate touches device memory; see csrc/factor_inv.cu.

    Returns Linv, or (Linv, x) when ``rhs`` is given."""
    if z is not None and rhs is None:
        raise ValueError("factor_inv: z requires rhs")
    B, m = dinv.shape
    vecs = tuple(v for v in (dinv, rhs, z) if v is not None)
    _check("factor_inv", R, vecs, B, m)
    if R.device.type == "cpu":
        return factor_inv_plain(R, dinv, rhs, z)
    variant = ("factor_inv" if rhs is None else
               "factor_inv_solve" if z is None else "factor_inv_solve_rz")
    fn = _fn("factor_inv", f"qpth_factor_inv_{_SUFFIX[R.dtype]}", 6, 3)
    Linv = torch.empty((B, m, m), dtype=R.dtype, device=R.device)
    x = torch.empty_like(rhs) if rhs is not None else None
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(R.data_ptr(), dinv.data_ptr(),
                 rhs.data_ptr() if rhs is not None else None,
                 z.data_ptr() if z is not None else None,
                 Linv.data_ptr(), x.data_ptr() if x is not None else None,
                 B, m, int(R.shape[0] > 1), stream)
    _launch_error(variant, err)
    LAUNCHES[variant] += 1
    return Linv if rhs is None else (Linv, x)


def _apply_inv(G, r):
    """x = G^T (G r) = T^-1 r from G = inv(L)."""
    w = torch.matmul(G, r.unsqueeze(-1))
    return torch.matmul(G.transpose(-1, -2), w).squeeze(-1)


def factor_inv_plain(R, dinv, rhs=None, z=None):
    """Plain PyTorch version of :func:`factor_inv`: the same pivot
    recurrence (``rsqrt`` pivots, L's column j from the lower triangle,
    inv(L) built alongside), vectorized over the batch."""
    B, m = dinv.shape
    T = R.expand(B, m, m).clone()
    if z is not None:
        rhs = rhs - torch.matmul(R, z.unsqueeze(-1)).squeeze(-1)
    G = torch.eye(m, dtype=R.dtype, device=R.device).expand(B, m, m).clone()
    for j in range(m):
        isq = torch.rsqrt(T[:, j, j] + dinv[:, j]).unsqueeze(-1)
        lk = T[:, j + 1:, j] * isq                     # L[k, j], k > j
        G[:, j, :j + 1] *= isq
        G[:, j + 1:, :j + 1] -= lk.unsqueeze(-1) * G[:, j:j + 1, :j + 1]
        T[:, j + 1:, j + 1:] -= lk.unsqueeze(-1) * lk.unsqueeze(-2)
    if rhs is None:
        return G
    return G, _apply_inv(G, rhs)


# ---------------------------------------------------------------------------
# Kernel B: ipm_step_xfree
# ---------------------------------------------------------------------------

def ipm_step_xfree(R, s, z, q, n_correctors: int = 0):
    """One x-free Mehrotra iteration (neq = 0) on T = R + diag(s/z) with
    predictor RHS q - R z. Returns (zeta, s', z', alpha): zeta = z + dz
    (dz masked to 0 on NaN-frozen lanes), the damped s' and z', and alpha
    (B,) the applied step (0 on frozen lanes).

    Replaces the TPU kernel
    ``qpth_tpu/ops/pallas/lanes.py::ipm_step_xfree_lanes``. On the H100 it
    is bound by bytes: R read once plus a few (B, m) vectors (>= 0.05 ms at
    B = 4096, m = 100, f32). One block per QP: R and inv(L) in shared
    memory, every m-vector in registers (thread i holds element i), the
    per-QP min/sum reductions as block reductions; see
    csrc/ipm_step_xfree.cu."""
    B, m = s.shape
    _check("ipm_step_xfree", R, (s, z, q), B, m)
    if R.device.type == "cpu":
        return ipm_step_xfree_plain(R, s, z, q, n_correctors)
    fn = _fn("ipm_step_xfree", f"qpth_ipm_step_xfree_{_SUFFIX[R.dtype]}",
             8, 4)
    zeta, s_out, z_out = (torch.empty_like(s) for _ in range(3))
    alpha = torch.empty((B,), dtype=s.dtype, device=s.device)
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(R.data_ptr(), s.data_ptr(), z.data_ptr(), q.data_ptr(),
                 zeta.data_ptr(), s_out.data_ptr(), z_out.data_ptr(),
                 alpha.data_ptr(), B, m, int(R.shape[0] > 1),
                 int(n_correctors), stream)
    _launch_error("ipm_step_xfree", err)
    LAUNCHES["ipm_step_xfree"] += 1
    return zeta, s_out, z_out, alpha


def _step(v, dv):
    """Per-lane max step with v + a dv >= 0 (NaN propagates)."""
    inf = torch.full_like(v, float("inf"))
    return torch.where(dv < 0, -v / dv, inf).amin(dim=-1, keepdim=True)


def ipm_step_xfree_plain(R, s, z, q, n_correctors: int = 0):
    """Plain PyTorch version of :func:`ipm_step_xfree` (the algebra of
    ``lanes.py:1030-1098``, batch-major)."""
    m = s.shape[-1]
    d = z / s
    G = factor_inv_plain(R, s / z)
    rhs_a = q - torch.matmul(R, z.unsqueeze(-1)).squeeze(-1)

    def step_min(dz_, ds_):
        return torch.minimum(_step(z, dz_), _step(s, ds_))

    one = torch.ones((), dtype=s.dtype, device=s.device)
    dz_a = _apply_inv(G, rhs_a)
    ds_a = (-z - dz_a) / d
    alpha = torch.minimum(step_min(dz_a, ds_a), one)
    t2 = (s * z).sum(dim=-1, keepdim=True)
    t1 = ((s + alpha * ds_a) * (z + alpha * dz_a)).sum(dim=-1, keepdim=True)
    ratio = t1 / t2
    sig = ratio * ratio * ratio
    mu = t2.abs() / m

    rs_c = (-(mu * sig) + ds_a * dz_a) / s
    dz_c = _apply_inv(G, -(rs_c / d))
    ds_c = (-rs_c - dz_c) / d
    dz = dz_a + dz_c
    ds = ds_a + ds_c

    for _ in range(n_correctors):
        a_g = torch.minimum(step_min(dz, ds), one)
        a_t = torch.minimum(1.08 * a_g + 0.08, one)
        v = (s + a_t * ds) * (z + a_t * dz)
        mu_t = sig * mu
        rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                  10.0 * mu_t)) / s
        ddz = _apply_inv(G, -(rs_g / d))
        dds = (-rs_g - ddz) / d
        dz_n, ds_n = dz + ddz, ds + dds
        a_n = torch.minimum(step_min(dz_n, ds_n), one)
        acc = a_n > a_g
        dz = torch.where(acc, dz_n, dz)
        ds = torch.where(acc, ds_n, ds)

    alpha2 = torch.minimum(0.999 * step_min(dz, ds), one)
    frozen = (torch.isnan(dz) | torch.isnan(ds)).any(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    alpha2 = torch.where(frozen, zero, alpha2)
    dz_m = torch.where(frozen, zero, dz)
    return (z + dz_m, s + alpha2 * torch.where(frozen, zero, ds),
            z + alpha2 * dz_m, alpha2.squeeze(-1))
