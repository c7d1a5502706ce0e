"""Wrappers of the port's CUDA kernels, their plain PyTorch versions, and
the launch counters.

Kernel A, ``factor_inv`` (``csrc/factor_inv.cu``), in three variants:
  * ``factor_inv(R, dinv)``            -> Linv = inv(chol(R + diag(dinv)))
  * ``factor_inv(R, dinv, rhs)``       -> (Linv, T^-1 rhs)
  * ``factor_inv(R, dinv, rhs, z)``    -> (Linv, T^-1 (rhs - R z))
  (at m up to ``factor_inv_tile_max(dtype)`` also counted as
  ``factor_inv_tile``).
Kernel B, ``ipm_step_xfree`` (``csrc/ipm_step_xfree.cu``): one whole x-free
Mehrotra iteration for neq = 0. It and the other fused steps launch
blocks of 6 warps in float32 up to m = 100, else of 8
(:func:`ipm_step_shape`).
``inv_solve`` (``csrc/inv_solve.cu``): x = Linv^T (Linv rhs), every further
solve on a factor that kernel A made.
``ipm_step`` (``csrc/ipm_step.cu``): one whole iteration for neq = 0 with
the direct x update.
``ipm_step_eq`` (``csrc/ipm_step_eq.cu``): one whole iteration with
equality constraints (the S11/S21/W algebra, the y and x updates).
``diag_step`` (``csrc/diag_step.cu``): one whole iteration of the
diagonal-Q/G tier, M's factor and inverse included.
Kernel C, ``chol`` (``csrc/chol.cu``), in four variants:
  * ``chol(A)``                  -> Lt = chol(A)^T
  * ``chol(R, dinv)``            -> Lt = chol(R + diag(dinv))^T
  * ``chol(R, dinv, rhs)``       -> (Lt, T^-1 rhs)   (and without dinv)
Kernel D, ``cho_solve`` (``csrc/cho_solve.cu``): x = (L L^T)^-1 v from Lt
(or from L itself with ``lower=True``); a factor of batch 1 takes its
shared-factor kernel (also counted as ``cho_solve_shared``).
Kernel E, ``trinv`` (``csrc/trinv.cu``): inv(L) from Lt.

Layout is batch-major throughout: matrices (b, rows, cols) with b in
{1, B} (a shared matrix is read with batch stride 0), vectors (B, n), Linv
(B, m, m) with row i of inv(L) in row i (lower triangular), Lt (B, m, m)
upper triangular with exact zeros below the diagonal.

Dispatch is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel, and a failed build or launch
raises. The plain versions compute the same recurrence as the kernels
(pivot by pivot, ``rsqrt`` pivots, NaN for a non-SPD lane; the fused steps'
kernels substitute with T's factor where their plain versions apply its
inverse) and are what the CPU tests and ``chip_smoke.py`` hold the kernels
against.

``LAUNCHES`` counts kernel launches per variant; a wrapper adds one only
where it launches its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: Shared memory one thread block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
#: m-vectors a kernel keeps in shared memory beside its m x m tile
#: (``kSmemVectors`` in csrc/common.cuh).
SMEM_VECTORS = 8
#: neq-vectors of the equality-constrained step (``kSmemEqVectors``).
SMEM_EQ_VECTORS = 4
#: Threads per block (``kThreads`` in csrc/common.cuh): bounds m as well.
THREADS = 256
#: Words of the block reductions' static scratch (``red[kWarps]`` in
#: csrc/ipm_step_body.cuh and csrc/diag_step.cu). Static shared memory
#: counts against the same 227 KB as the dynamic allocation.
RED_WORDS = THREADS // 32

#: n- and neq-vectors the diagonal-tier step keeps in shared memory beside
#: the neq x neq tile of M and its inverse factor (``kDiagNVectors``,
#: ``kDiagEqVectors`` in csrc/diag_step.cu).
DIAG_N_VECTORS = 10
DIAG_EQ_VECTORS = 5

#: m-vectors kernels C and E launch with beside their one m x m tile
#: (``kCholVectors`` in csrc/panel.cuh).
CHOL_VECTORS = 4

LAUNCHES = {"factor_inv": 0, "factor_inv_solve": 0,
            "factor_inv_solve_rz": 0, "factor_inv_tile": 0,
            "ipm_step_xfree": 0, "inv_solve": 0,
            "ipm_step": 0, "ipm_step_eq": 0, "diag_step": 0, "chol": 0,
            "chol_solve": 0, "cho_solve": 0, "cho_solve_shared": 0,
            "trinv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns: dict[str, object] = {}
_tile_max: dict[torch.dtype, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(m: int, dtype, nz: int = 0, neq: int = 0) -> bool:
    """Whether one QP's working set fits a thread block: one m x m tile
    (kernel A: T's factor above the diagonal, inv(L) on and below it; the
    fused steps: R, then T's factor; both on 32-row panels, csrc/panel.cuh),
    SMEM_VECTORS m-vectors and the fused steps' RED_WORDS of reduction
    scratch within 227 KB, and m <= THREADS (float32: m <= 237, leaving 39
    words; float64: m <= 166, leaving 164 words). The fused steps with the direct x update (``ipm_step``,
    ``ipm_step_eq``) also keep one nz-vector and, with equality
    constraints, SMEM_EQ_VECTORS neq-vectors; pass their ``nz`` and
    ``neq``. ``inv_solve`` keeps no tile: m <= THREADS alone."""
    elt = dtype.itemsize
    words = (m * m + SMEM_VECTORS * m + RED_WORDS + nz
             + SMEM_EQ_VECTORS * neq)
    return m <= THREADS and words * elt <= SMEM_LIMIT


def diag_step_fits(n: int, neq: int, dtype) -> bool:
    """Whether one QP of the diagonal-tier step fits a thread block: one
    neq x neq tile for M and its inverse factor, DIAG_EQ_VECTORS
    neq-vectors, DIAG_N_VECTORS n-vectors and RED_WORDS of reduction
    scratch within 227 KB, 1 <= neq <= THREADS (neq = 0 never builds M;
    its step is elementwise). At neq = 40: n <= 5630 in float32, n <= 2724
    in float64."""
    elt = dtype.itemsize
    words = (neq * neq + DIAG_EQ_VECTORS * neq + DIAG_N_VECTORS * n
             + RED_WORDS)
    return 1 <= neq <= THREADS and words * elt <= SMEM_LIMIT


def chol_fits(m: int, dtype) -> bool:
    """Whether kernel C's working set fits a thread block: one m x m tile
    plus CHOL_VECTORS m-vectors within 227 KB, and m <= THREADS (float32:
    m <= 239; float64: m <= 168). Kernels D and E read the factors kernel
    C makes, so the same predicate bounds them. E launches with C's
    working set (``chol_smem_bytes`` in csrc/panel.cuh); D's is smaller
    (per lane: a 32 x 33 tile per warp; shared factor: the packed
    triangle, a 32 x 32 diagonal block and n x 33 right-hand sides, 151 KB
    at m = 239 in float32, 167 KB at m = 168 in float64)."""
    elt = dtype.itemsize
    return m <= THREADS and (m * m + CHOL_VECTORS * m) * elt <= SMEM_LIMIT


def _fn(stem: str, name: str, n_ptr: int, n_int: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(stem), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, R, vecs, B, m, mats=(), more_vecs=(), nz=0, neq=0,
           tiles=True):
    """Device, dtype, shape and contiguity of a kernel's operands. ``R``
    (1 or B, m, m) and ``vecs`` (B, m); ``mats`` as (tensor, rows, cols)
    with batch 1 or B; ``more_vecs`` as (tensor, n) for (B, n) vectors;
    ``tiles``: the kernel keeps an m x m tile in shared memory."""
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {R.device}")
    if R.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {R.dtype} not supported "
                        "(float32 or float64)")
    for M, rows, cols in ((R, m, m),) + tuple(mats):
        if (M.dim() != 3 or M.shape[1:] != (rows, cols)
                or M.shape[0] not in (1, B)):
            raise ValueError(f"{name}: matrix must be (1 or {B}, {rows}, "
                             f"{cols}), got {tuple(M.shape)}")
    for v, n in tuple((v, m) for v in vecs) + tuple(more_vecs):
        if v.shape != (B, n):
            raise ValueError(f"{name}: vector must be ({B}, {n}), "
                             f"got {tuple(v.shape)}")
    for v in ((R,) + tuple(vecs) + tuple(M for M, _, _ in mats)
              + tuple(v for v, _ in more_vecs)):
        if v.dtype != R.dtype or v.device != R.device:
            raise ValueError(f"{name}: all operands must share R's dtype "
                             "and device")
        if not v.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if tiles and R.device.type == "cuda" and not fits(m, R.dtype, nz, neq):
        raise ValueError(f"{name}: m = {m}, nz = {nz}, neq = {neq} exceeds "
                         f"the one-block shared memory fit for {R.dtype}")


def _launch(variant, fn, device, *args):
    """``fn(*args, stream)`` on ``device``'s current stream; raises where
    the launch failed and counts it under ``LAUNCHES[variant]``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{variant}: CUDA kernel launch failed "
                           f"(cudaError_t {err})")
    LAUNCHES[variant] += 1


def ipm_step_shape(m: int, dtype, mode: str = "xfree", nz: int = 0,
                   neq: int = 0):
    """(warps, blocks): the fused step of ``mode`` ("xfree", "x" or "eq")
    at width m (and nz, neq) on the current device, as its library launches
    it: warps a block (6 in float32 up to m = 100, else 8;
    csrc/ipm_step_body.cuh::step_warps) and the blocks one SM holds at once
    (the CUDA occupancy calculator; ``qpth_ipm_step_warps``,
    ``qpth_ipm_step_blocks_per_sm``)."""
    stem = {"xfree": "ipm_step_xfree", "x": "ipm_step", "eq": "ipm_step_eq"}
    lib = build.load(stem[mode])
    f64 = int(dtype == torch.float64)
    warps, blocks = lib.qpth_ipm_step_warps, lib.qpth_ipm_step_blocks_per_sm
    warps.argtypes, warps.restype = [ctypes.c_int] * 2, ctypes.c_int
    blocks.argtypes, blocks.restype = [ctypes.c_int] * 4, ctypes.c_int
    n = blocks(m, f64, nz, neq)
    if n < 0:
        raise RuntimeError(f"ipm_step_shape: cudaError_t {-n}")
    return warps(m, f64), n


# ---------------------------------------------------------------------------
# Kernel A: factor_inv
# ---------------------------------------------------------------------------

def factor_inv(R, dinv, rhs=None, z=None):
    """Linv = inv(chol(R + diag(dinv))), with ``rhs`` also x = T^-1 rhs,
    with ``rhs`` and ``z`` x = T^-1 (rhs - R z). R's lower triangle is read
    (the whole R for R z).

    Replaces the TPU kernel ``qpth_tpu/ops/pallas/lanes.py::_factor_inv_call``
    (``factor_inv_lanes`` / ``factor_inv_solve_lanes`` /
    ``factor_inv_solve_rz_lanes``), which factors and inverts pivot by
    pivot. On the H100 it is bound by bytes: R's triangle in and Linv out
    once (>= 0.074 ms at B = 4096, m = 100, f32; 0.150 ms in f64). One block
    per QP keeps everything in one m x m shared-memory tile and walks it in
    panels of 32 rows, as kernels C and E do: the factor with the shift
    folded into each pivot and y = L^-1 rhs riding as one more column
    (kernel C's loop), the inverse in the same tile (kernel E's scheme), and
    x = L^-T y by back substitution in one warp beside the inverse in the
    others; a dependent chain is one warp's 32 steps, not the m pivot steps
    behind a barrier each of the TPU kernel's recurrence. Up to
    :func:`factor_inv_tile_max` (17 in float32, 50 in float64) that
    recurrence is faster and the kernel keeps it. See csrc/factor_inv.cu.

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
    _launch(variant, fn, R.device, R.data_ptr(), dinv.data_ptr(),
            rhs.data_ptr() if rhs is not None else None,
            z.data_ptr() if z is not None else None, Linv.data_ptr(),
            x.data_ptr() if x is not None else None, B, m,
            int(R.shape[0] > 1))
    if m <= factor_inv_tile_max(R.dtype):
        LAUNCHES["factor_inv_tile"] += 1
    return Linv if rhs is None else (Linv, x)


def factor_inv_tile_max(dtype):
    """The largest m at which kernel A launches its per-pivot
    factor-inverse (``TileMaxM`` in csrc/factor_inv.cu), as the library
    states it."""
    if dtype not in _tile_max:
        fn = build.load("factor_inv").qpth_factor_inv_tile_max
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        _tile_max[dtype] = fn(int(dtype == torch.float64))
    return _tile_max[dtype]


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
# Kernel 5: inv_solve
# ---------------------------------------------------------------------------

def inv_solve(Linv, rhs):
    """x = Linv^T (Linv rhs) = T^-1 rhs from the inverse factor that
    :func:`factor_inv` returned: every further solve on that factor (the
    corrector and the Gondzio corrections of the composed IPM step).

    Replaces the TPU kernel ``qpth_tpu/ops/pallas/lanes.py::inv_solve_lanes``.
    On the H100 it is bound by bytes: Linv's lower triangle read once
    (>= 0.026 ms at B = 4096, m = 100, f32; 0.051 ms at f64; 0.0044 ms at
    m = 40, f32). One warp per QP (half a warp where m is small), 8 or 16
    QPs per block, streams Linv's rows through registers several at a
    time, each row used for both products, with 16-byte loads where the
    operands' addresses and m allow; only the lower triangle is read. See
    csrc/inv_solve.cu."""
    B, m = rhs.shape
    if Linv.shape != (B, m, m):
        raise ValueError(f"inv_solve: Linv must be ({B}, {m}, {m}), "
                         f"got {tuple(Linv.shape)}")
    if Linv.device.type == "cuda" and m > THREADS:
        raise ValueError(f"inv_solve: m = {m} exceeds {THREADS}")
    _check("inv_solve", Linv, (rhs,), B, m, tiles=False)
    if Linv.device.type == "cpu":
        return inv_solve_plain(Linv, rhs)
    fn = _fn("inv_solve", f"qpth_inv_solve_{_SUFFIX[Linv.dtype]}", 3, 2)
    x = torch.empty_like(rhs)
    _launch("inv_solve", fn, Linv.device, Linv.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, m)
    return x


def inv_solve_plain(Linv, rhs):
    """Plain PyTorch version of :func:`inv_solve`: two batched products."""
    return _apply_inv(Linv, rhs)


# ---------------------------------------------------------------------------
# The fused iteration: kernel B (x-free), ipm_step, ipm_step_eq
# ---------------------------------------------------------------------------

def _mv(M, v):
    """M v for M (1 or B, r, c) and v (B, c)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _step(v, dv):
    """Per-lane max step with v + a dv >= 0 (NaN propagates)."""
    inf = torch.full_like(v, float("inf"))
    return torch.where(dv < 0, -v / dv, inf).amin(dim=-1, keepdim=True)


def _mehrotra_plain(R, s, z, rhs_a, n_correctors, W=None, u=None):
    """The predictor, corrector and Gondzio passes shared by the three
    fused-step kernels, on T = R + diag(s/z) with predictor RHS ``rhs_a``.
    With ``W`` and ``u`` (equality constraints) also dy = u - W dz, updated
    pass by pass as the kernels do. Returns (dz, ds, dy, alpha2) before the
    NaN freeze; alpha2 is (B, 1)."""
    m = s.shape[-1]
    d = z / s
    G = factor_inv_plain(R, s / z)

    def step_min(dz_, ds_):
        return torch.minimum(_step(z, dz_), _step(s, ds_))

    one = torch.ones((), dtype=s.dtype, device=s.device)
    dz_a = _apply_inv(G, rhs_a)
    ds_a = (-z - dz_a) / d
    dy = u - _mv(W, dz_a) if W is not None else None
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
    if W is not None:
        dy = dy - _mv(W, dz_c)

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
        if W is not None:
            dy = torch.where(acc, dy - _mv(W, ddz), dy)

    alpha2 = torch.minimum(0.999 * step_min(dz, ds), one)
    return dz, ds, dy, alpha2


def _freeze(alpha2, *dirs):
    """Mask alpha and every direction on lanes with a NaN in any
    direction (0 * NaN is NaN, so alpha alone would not do)."""
    frozen = torch.zeros_like(alpha2, dtype=torch.bool)
    for dv in dirs:
        frozen = frozen | torch.isnan(dv).any(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=alpha2.dtype, device=alpha2.device)
    return (torch.where(frozen, zero, alpha2),
            *(torch.where(frozen, zero, dv) for dv in dirs))


def _batched_bits(B, *mats):
    """Bit k set when the k-th matrix has batch B > 1 (``StepOperand`` in
    csrc/ipm_step_body.cuh)."""
    return sum(1 << k for k, M in enumerate(mats)
               if B > 1 and M.shape[0] == B)


def ipm_step_xfree(R, s, z, q, n_correctors: int = 0):
    """One x-free Mehrotra iteration (neq = 0) on T = R + diag(s/z) with
    predictor RHS q - R z. Returns (zeta, s', z', alpha): zeta = z + dz
    (dz masked to 0 on NaN-frozen lanes), the damped s' and z', and alpha
    (B,) the applied step (0 on frozen lanes).

    Replaces the TPU kernel
    ``qpth_tpu/ops/pallas/lanes.py::ipm_step_xfree_lanes``. On the H100 it
    is bound by bytes: R's triangle read once plus a few (B, m) vectors
    (>= 0.028 ms at B = 4096, m = 100, f32). One block per QP stages R's
    lower triangle in one shared-memory tile (mirrored), taking R z from R
    in the same pass, and factors T there on kernel C's 32-row panels
    (one warp's chain per diagonal block, the trailing updates on register
    tiles), the predictor's RHS riding in the factor as one more column;
    the corrector and each Gondzio pass are a forward and a back
    substitution by panels from that factor. No inverse is formed. Every
    m-vector sits in registers (thread i holds element i), the per-QP
    min/sum reductions are block reductions; see csrc/ipm_step_body.cuh,
    which the three fused steps share. A lane whose T is not SPD gets NaN
    from its factor's ``rsqrt`` and freezes alone."""
    B, m = s.shape
    _check("ipm_step_xfree", R, (s, z, q), B, m)
    if R.device.type == "cpu":
        return ipm_step_xfree_plain(R, s, z, q, n_correctors)
    fn = _fn("ipm_step_xfree", f"qpth_ipm_step_xfree_{_SUFFIX[R.dtype]}",
             8, 4)
    zeta, s_out, z_out = (torch.empty_like(s) for _ in range(3))
    alpha = torch.empty((B,), dtype=s.dtype, device=s.device)
    _launch("ipm_step_xfree", fn, R.device, R.data_ptr(), s.data_ptr(),
            z.data_ptr(), q.data_ptr(), zeta.data_ptr(), s_out.data_ptr(),
            z_out.data_ptr(), alpha.data_ptr(), B, m, int(R.shape[0] > 1),
            int(n_correctors))
    return zeta, s_out, z_out, alpha


def ipm_step_xfree_plain(R, s, z, q, n_correctors: int = 0):
    """Plain PyTorch version of :func:`ipm_step_xfree` (the algebra of
    ``lanes.py:1030-1098``, batch-major)."""
    dz, ds, _, alpha2 = _mehrotra_plain(R, s, z, q - _mv(R, z),
                                        n_correctors)
    alpha2, dz, ds = _freeze(alpha2, dz, ds)
    return z + dz, s + alpha2 * ds, z + alpha2 * dz, alpha2.squeeze(-1)


def ipm_step(R, iGT, x, s, z, q, ip, n_correctors: int = 0):
    """One Mehrotra iteration (neq = 0) with the direct x update: the
    x-free iteration plus dx = -(x + ip) - iGT (z + dz), with ``iGT`` =
    Q^-1 G^T (1 or B, nz, m) and ``ip`` = Q^-1 p (B, nz). A NaN in dx
    freezes the lane too. Returns (x', s', z', alpha).

    Replaces the TPU kernel ``qpth_tpu/ops/pallas/lanes.py::ipm_step_lanes``.
    On the H100 it is bound by bytes: R's triangle and iGT read once each
    (>= 0.078 ms at B = 4096, m = nz = 100, f32). Kernel B's block design; iGT is read
    from device memory once, one warp per row, after the corrector; see
    csrc/ipm_step.cu."""
    B, m = s.shape
    nz = x.shape[-1]
    _check("ipm_step", R, (s, z, q), B, m, mats=((iGT, nz, m),),
           more_vecs=((x, nz), (ip, nz)), nz=nz)
    if R.device.type == "cpu":
        return ipm_step_plain(R, iGT, x, s, z, q, ip, n_correctors)
    fn = _fn("ipm_step", f"qpth_ipm_step_{_SUFFIX[R.dtype]}", 11, 5)
    x_out, s_out, z_out = (torch.empty_like(v) for v in (x, s, z))
    alpha = torch.empty((B,), dtype=s.dtype, device=s.device)
    _launch("ipm_step", fn, R.device, R.data_ptr(), iGT.data_ptr(),
            x.data_ptr(), s.data_ptr(), z.data_ptr(), q.data_ptr(),
            ip.data_ptr(), x_out.data_ptr(), s_out.data_ptr(),
            z_out.data_ptr(), alpha.data_ptr(), B, m, nz,
            _batched_bits(B, R, iGT), int(n_correctors))
    return x_out, s_out, z_out, alpha


def ipm_step_plain(R, iGT, x, s, z, q, ip, n_correctors: int = 0):
    """Plain PyTorch version of :func:`ipm_step` (the algebra of
    ``lanes.py:638-725``, batch-major)."""
    dz, ds, _, alpha2 = _mehrotra_plain(R, s, z, q - _mv(R, z),
                                        n_correctors)
    dx = -_mv(iGT, z + dz) - (x + ip)
    alpha2, dz, ds, dx = _freeze(alpha2, dz, ds, dx)
    return (x + alpha2 * dx, s + alpha2 * ds, z + alpha2 * dz,
            alpha2.squeeze(-1))


def ipm_step_eq(R, iGT, S21, W, iS11, S11, iAT, x, s, z, y, q, ip, rb,
                n_correctors: int = 0):
    """One Mehrotra iteration with equality constraints. Matrices (each
    with its own batch, 1 or B): R (m, m), ``iGT`` = Q^-1 G^T (nz, m),
    S21 (m, neq), W (neq, m), ``iS11`` = S11^-1 and S11 (neq, neq),
    ``iAT`` = Q^-1 A^T (nz, neq). Vectors: x, ``ip`` = Q^-1 p (B, nz);
    s, z, ``q`` = -(h + G Q^-1 p) (B, m); y, ``rb`` = b + A Q^-1 p
    (B, neq). Returns (x', s', z', y', alpha).

    Replaces the TPU kernel
    ``qpth_tpu/ops/pallas/lanes.py::ipm_step_eq_lanes``. On the H100 it is
    bound by bytes: the seven matrices read once (>= 0.18 ms at B = 4096,
    m = nz = 100, neq = 50, f32). Kernel B's block design; the equality
    operands do not fit in shared memory beside the m x m tile, so they are
    read from device memory where they are used, one warp per row; see
    csrc/ipm_step_eq.cu."""
    B, m = s.shape
    nz, neq = x.shape[-1], y.shape[-1]
    mats = (iGT, S21, W, iS11, S11, iAT)
    _check("ipm_step_eq", R, (s, z, q), B, m,
           mats=tuple(zip(mats, (nz, m, neq, neq, neq, nz),
                          (m, neq, m, neq, neq, neq))),
           more_vecs=((x, nz), (ip, nz), (y, neq), (rb, neq)), nz=nz,
           neq=neq)
    if R.device.type == "cpu":
        return ipm_step_eq_plain(R, iGT, S21, W, iS11, S11, iAT, x, s, z, y,
                                 q, ip, rb, n_correctors)
    fn = _fn("ipm_step_eq", f"qpth_ipm_step_eq_{_SUFFIX[R.dtype]}", 19, 6)
    x_out, s_out, z_out, y_out = (torch.empty_like(v) for v in (x, s, z, y))
    alpha = torch.empty((B,), dtype=s.dtype, device=s.device)
    ptrs = [t.data_ptr() for t in (R,) + mats + (x, s, z, y, q, ip, rb, x_out,
                                                 s_out, z_out, y_out, alpha)]
    _launch("ipm_step_eq", fn, R.device, *ptrs, B, m, nz, neq,
            _batched_bits(B, R, *mats), int(n_correctors))
    return x_out, s_out, z_out, y_out, alpha


def ipm_step_eq_plain(R, iGT, S21, W, iS11, S11, iAT, x, s, z, y, q, ip, rb,
                      n_correctors: int = 0):
    """Plain PyTorch version of :func:`ipm_step_eq` (the algebra of
    ``lanes.py:796-902``, batch-major, in the same order)."""
    r1 = (rb + _mv(S21.transpose(-1, -2), z)) + _mv(S11, y)
    u = _mv(iS11, -r1)
    rhs_a = (q - _mv(S21, (_mv(W, z) + y) + u)) - _mv(R, z)
    dz, ds, dy, alpha2 = _mehrotra_plain(R, s, z, rhs_a, n_correctors, W, u)
    dx = (-(x + ip) - _mv(iGT, z + dz)) - _mv(iAT, y + dy)
    alpha2, dz, ds, dx, dy = _freeze(alpha2, dz, ds, dx, dy)
    return (x + alpha2 * dx, s + alpha2 * ds, z + alpha2 * dz,
            y + alpha2 * dy, alpha2.squeeze(-1))


# ---------------------------------------------------------------------------
# Kernel 11: diag_step, the diagonal-Q/G tier's whole iteration
# ---------------------------------------------------------------------------

def diag_step(M, A, g, H, rx, rz, ry, x, s, z, y, n_correctors: int = 0):
    """One Mehrotra iteration of the diagonal-Q/G tier on the assembled
    M = A diag(1/H) A^T: M's factor and inverse (no diagonal shift), the
    predictor, corrector and Gondzio solves through it, the step to the
    boundary and the NaN-frozen update. M (1 or B, neq, neq), A (1 or B,
    neq, n), g (1 or B, n), each with its own batch; H, rx, rz, x, s, z
    (B, n); ry, y (B, neq). Returns (x', s', z', y').

    Replaces the TPU kernel
    ``qpth_tpu/ops/pallas/diagstep.py::diag_step_lanes``. At the sudoku
    layer's width (B = 4096, n = 64, neq = 40, float32) it is bound by
    bytes: M's triangle, A once and the vectors, ~25 MB (>= 0.0074 ms).
    One block per QP keeps M and its inverse factor in one shared-memory
    tile with the n- and neq-vectors; A is read from device memory (L2
    when shared); see csrc/diag_step.cu."""
    B, n = x.shape
    neq = y.shape[-1]
    if g.dim() != 2 or g.shape[-1] != n or g.shape[0] not in (1, B):
        raise ValueError(f"diag_step: g must be (1 or {B}, {n}), "
                         f"got {tuple(g.shape)}")
    _check("diag_step", M, (ry, y), B, neq, mats=((A, neq, n),),
           more_vecs=tuple((v, n) for v in (H, rx, rz, x, s, z)),
           tiles=False)
    if g.dtype != M.dtype or g.device != M.device or not g.is_contiguous():
        raise ValueError("diag_step: g must share M's dtype and device and "
                         "be contiguous")
    if M.device.type == "cpu":
        return diag_step_plain(M, A, g, H, rx, rz, ry, x, s, z, y,
                               n_correctors)
    if not diag_step_fits(n, neq, M.dtype):
        raise ValueError(f"diag_step: n = {n}, neq = {neq} exceeds the "
                         f"one-block shared memory fit for {M.dtype}")
    fn = _fn("diag_step", f"qpth_diag_step_{_SUFFIX[M.dtype]}", 15, 5)
    outs = tuple(torch.empty_like(v) for v in (x, s, z, y))
    ptrs = [t.data_ptr() for t in (M, A, g, H, rx, rz, ry, x, s, z, y)
            + outs]
    batched = sum(1 << k for k, T in enumerate((M, A, g))
                  if B > 1 and T.shape[0] == B)
    _launch("diag_step", fn, M.device, *ptrs, B, n, neq, batched,
            int(n_correctors))
    return outs


def diag_step_plain(M, A, g, H, rx, rz, ry, x, s, z, y,
                    n_correctors: int = 0):
    """Plain PyTorch version of :func:`diag_step` (the algebra of
    ``diagstep.py:58-160``, batch-major, in the same order): kernel A's
    recurrence with dinv = 0 for M's inverse factor, then triangular
    applies."""
    B, n = x.shape
    G = factor_inv_plain(M, torch.zeros(y.shape, dtype=M.dtype,
                                        device=M.device))
    AT = A.transpose(-1, -2)
    d = z / s

    def newton(rt, ry_):
        rhs = _mv(A, rt / H)
        if ry_ is not None:
            rhs = rhs + ry_
        dy_ = _apply_inv(G, rhs)
        return (rt - _mv(AT, dy_)) / H, dy_

    def step_min(dz_, ds_):
        return torch.minimum(_step(z, dz_), _step(s, ds_))

    one = torch.ones((), dtype=s.dtype, device=s.device)
    # Predictor: rs = z.
    dx_a, dy_a = newton(-rx + g * z - g * d * rz, ry)
    ds_a = -rz - g * dx_a
    dz_a = -z - d * ds_a
    alpha = torch.minimum(step_min(dz_a, ds_a), one)
    t2 = (s * z).sum(dim=-1, keepdim=True)
    t1 = ((s + alpha * ds_a) * (z + alpha * dz_a)).sum(dim=-1, keepdim=True)
    ratio = t1 / t2
    sig = ratio * ratio * ratio
    mu = t2.abs() / n

    # Corrector: RHS zero except rs.
    rs_c = (-(mu * sig) + ds_a * dz_a) / s
    dx_c, dy_c = newton(g * rs_c, None)
    ds_c = -g * dx_c
    dz_c = -rs_c - d * ds_c
    dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c

    for _ in range(n_correctors):
        a_g = torch.minimum(step_min(dz, ds), one)
        a_t = torch.minimum(1.08 * a_g + 0.08, one)
        v = (s + a_t * ds) * (z + a_t * dz)
        mu_t = sig * mu
        rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                  10.0 * mu_t)) / s
        dx_g, dy_g = newton(g * rs_g, None)
        ds_g = -g * dx_g
        dz_g = -rs_g - d * ds_g
        dz_n, ds_n = dz + dz_g, ds + ds_g
        acc = torch.minimum(step_min(dz_n, ds_n), one) > a_g
        dz = torch.where(acc, dz_n, dz)
        ds = torch.where(acc, ds_n, ds)
        dx = torch.where(acc, dx + dx_g, dx)
        dy = torch.where(acc, dy + dy_g, dy)

    alpha2 = torch.minimum(0.999 * step_min(dz, ds), one)
    alpha2, dx, ds, dz, dy = _freeze(alpha2, dx, ds, dz, dy)
    return x + alpha2 * dx, s + alpha2 * ds, z + alpha2 * dz, y + alpha2 * dy


# ---------------------------------------------------------------------------
# Kernel C: chol, the Cholesky factor (with a diagonal shift, a first solve)
# ---------------------------------------------------------------------------

def chol(R, dinv=None, rhs=None):
    """Lt = chol(R + diag(dinv))^T, upper triangular with exact zeros below
    the diagonal; without ``dinv`` the factor of R itself; with ``rhs`` also
    x = (R + diag(dinv))^-1 rhs, solved on the factor while it is still on
    chip. R (1 or B, m, m) symmetric (its upper triangle is read), dinv and
    rhs (B, m). A lane whose matrix is not SPD comes back with NaN in its
    factor (and x) and leaves the other lanes alone.

    Replaces the TPU kernels ``qpth_tpu/ops/pallas/cholesky.py``'s
    ``cholesky_t_pallas`` and ``factor_kkt_t_pallas`` and
    ``qpth_tpu/ops/pallas/lanes.py``'s ``factor_kkt_lanes`` and
    ``factor_solve_kkt_lanes``. On the H100 it is bound by bytes: R's
    triangle in and Lt's out (>= 0.049 ms at B = 4096, m = 100, f32). One
    block per QP keeps T in one m x m shared-memory tile and factors it in
    panels of 32 rows: one warp's chain over each diagonal block, the
    panel's rows by a substitution per column, the trailing update on
    register tiles by all warps, 3 barriers per panel; the solve rides in
    the panel loop as one more column, then a back substitution by panels.
    See csrc/chol.cu and csrc/panel.cuh.

    Returns Lt, or (Lt, x) when ``rhs`` is given."""
    m = R.shape[-1]
    vecs = tuple(v for v in (dinv, rhs) if v is not None)
    B = vecs[0].shape[0] if vecs else R.shape[0]
    _check("chol", R, vecs, B, m, tiles=False)
    if R.device.type == "cpu":
        return chol_plain(R, dinv, rhs)
    if not chol_fits(m, R.dtype):
        raise ValueError(f"chol: m = {m} exceeds the one-block shared "
                         f"memory fit for {R.dtype}")
    fn = _fn("chol", f"qpth_chol_{_SUFFIX[R.dtype]}", 5, 3)
    Lt = torch.empty((B, m, m), dtype=R.dtype, device=R.device)
    x = torch.empty_like(rhs) if rhs is not None else None
    _launch("chol" if rhs is None else "chol_solve", fn, R.device,
            R.data_ptr(), dinv.data_ptr() if dinv is not None else None,
            rhs.data_ptr() if rhs is not None else None, Lt.data_ptr(),
            x.data_ptr() if x is not None else None, B, m,
            int(R.shape[0] > 1))
    return Lt if rhs is None else (Lt, x)


def chol_plain(R, dinv=None, rhs=None):
    """Plain PyTorch version of :func:`chol`: the same rank-1 recurrence
    pivot by pivot (``rsqrt`` pivots, the shift added to pivot j when it is
    reached, rows scaled by the pivot's rsqrt), then
    :func:`cho_solve_plain` for ``rhs``, vectorized over the batch."""
    m = R.shape[-1]
    vecs = tuple(v for v in (dinv, rhs) if v is not None)
    B = vecs[0].shape[0] if vecs else R.shape[0]
    T = R.expand(B, m, m).clone()
    Lt = torch.zeros_like(T)
    for j in range(m):
        piv = T[:, j, j] + dinv[:, j] if dinv is not None else T[:, j, j]
        isq = torch.rsqrt(piv)
        lrow = T[:, j, j + 1:] * isq.unsqueeze(-1)
        Lt[:, j, j] = piv * isq
        Lt[:, j, j + 1:] = lrow
        T[:, j + 1:, j + 1:] -= lrow.unsqueeze(-1) * lrow.unsqueeze(-2)
    if rhs is None:
        return Lt
    return Lt, cho_solve_plain(Lt, rhs)


# ---------------------------------------------------------------------------
# Kernel D: cho_solve, two triangular substitutions
# ---------------------------------------------------------------------------

def cho_solve(Lt, v, lower: bool = False):
    """x solving (L L^T) x = v. ``Lt`` = L^T (1 or B, n, n), upper, as
    :func:`chol` returns it; with ``lower=True`` the argument is L itself
    (lower, the layout of the cached factors of Q and S11). v (B, n). A
    factor of batch 1 serves every lane. Only the factor's triangle is read.

    Replaces the TPU kernels ``qpth_tpu/ops/pallas/cholesky.py``'s
    ``cho_solve_vec_t_pallas`` and ``qpth_tpu/ops/pallas/lanes.py``'s
    ``cho_solve_lanes``. The factor's batch picks one of two kernels in
    csrc/cho_solve.cu:

    * a factor for each lane: bound by bytes, the triangle read once
      (>= 0.026 ms at B = 4096, n = 100, f32). One warp per QP, 32 QPs per
      SM, the right-hand side in registers; the dependent steps run only
      over 32 x 32 diagonal blocks, and the factor streams from device
      memory block by block (cp.async) through a per-warp tile, transposed
      where a pass needs it. Each pass reads the triangle;
    * a shared factor (batch 1): B right-hand sides on one triangle. Each
      block stages the triangle once in shared memory beside 32 right-hand
      sides; warp 0 runs each panel's diagonal block, then eight warps
      apply the panel to the other rows. Counted also under
      ``LAUNCHES["cho_solve_shared"]``.

    Both substitutions run in column order with each pivot applied as its
    reciprocal: in float32 the result differs from :func:`cho_solve_plain`
    by a few units in the last place times the factor's condition."""
    B, n = v.shape
    _check("cho_solve", Lt, (v,), B, n, tiles=False)
    if Lt.device.type == "cpu":
        return cho_solve_plain(Lt, v, lower)
    if not chol_fits(n, Lt.dtype):
        raise ValueError(f"cho_solve: n = {n} exceeds the one-block shared "
                         f"memory fit for {Lt.dtype}")
    fn = _fn("cho_solve", f"qpth_cho_solve_{_SUFFIX[Lt.dtype]}", 3, 4)
    x = torch.empty_like(v)
    batched = Lt.shape[0] > 1
    _launch("cho_solve", fn, Lt.device, Lt.data_ptr(), v.data_ptr(),
            x.data_ptr(), B, n, int(batched), int(lower))
    if not batched:
        LAUNCHES["cho_solve_shared"] += 1
    return x


def cho_solve_plain(Lt, v, lower: bool = False):
    """Plain PyTorch version of :func:`cho_solve`: the forward substitution
    in SAXPY form over the rows of Lt, the back substitution as row dot
    products, column by column, vectorized over the batch."""
    U = Lt.transpose(-1, -2) if lower else Lt
    n = v.shape[-1]
    y = v.clone()
    for j in range(n):
        yj = y[:, j] / U[:, j, j]
        y[:, j + 1:] -= U[:, j, j + 1:] * yj.unsqueeze(-1)
        y[:, j] = yj
    x = torch.zeros_like(y)
    for i in range(n - 1, -1, -1):
        acc = (U[:, i, i + 1:] * x[:, i + 1:]).sum(dim=-1)
        x[:, i] = (y[:, i] - acc) / U[:, i, i]
    return x


# ---------------------------------------------------------------------------
# Kernel E: trinv, the triangular inverse
# ---------------------------------------------------------------------------

def trinv(Lt):
    """inv(L) from Lt = L^T (B, n, n): lower triangular, row i of inv(L) in
    row i, exact zeros above the diagonal.

    Replaces the TPU kernel ``qpth_tpu/ops/pallas/cholesky.py::trinv_pallas``.
    On the H100 it is bound by bytes: Lt's triangle in and invL's out
    (>= 0.049 ms at B = 4096, n = 100, f32). One block per QP keeps Lt's
    strict upper triangle and the inverse's lower one in one n x n
    shared-memory tile; one warp per 32 x 32 diagonal block inverts it,
    then the row blocks follow by block products on register tiles (2
    barriers each); see csrc/trinv.cu. It launches with kernel C's working
    set, and the wrapper checks ``chol_fits``: whatever kernel C factors,
    kernel E inverts (n <= 239 in float32, <= 168 in float64)."""
    B, n = Lt.shape[0], Lt.shape[-1]
    _check("trinv", Lt, (), B, n, tiles=False)
    if Lt.device.type == "cpu":
        return trinv_plain(Lt)
    if not chol_fits(n, Lt.dtype):
        raise ValueError(f"trinv: n = {n} exceeds the one-block shared "
                         f"memory fit for {Lt.dtype}")
    fn = _fn("trinv", f"qpth_trinv_{_SUFFIX[Lt.dtype]}", 2, 2)
    out = torch.empty_like(Lt)
    _launch("trinv", fn, Lt.device, Lt.data_ptr(), out.data_ptr(), B, n)
    return out


def trinv_plain(Lt):
    """Plain PyTorch version of :func:`trinv`: the forward substitution
    L X = I in SAXPY form over the rows of Lt, all columns at once."""
    B, n = Lt.shape[0], Lt.shape[-1]
    X = torch.eye(n, dtype=Lt.dtype, device=Lt.device).expand(B, n,
                                                             n).clone()
    for j in range(n):
        X[:, j, :] /= Lt[:, j, j].unsqueeze(-1)
        X[:, j + 1:, :] -= Lt[:, j, j + 1:].unsqueeze(-1) * X[:, j:j + 1, :]
    return X
