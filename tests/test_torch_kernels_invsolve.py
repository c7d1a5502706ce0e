"""A CPU model of kernel 5 (``qpth_tpu_torch/csrc/inv_solve.cu``),
x = Linv^T (Linv rhs), held to the plain version ``inv_solve_plain`` and to
the JAX package's ``inv_solve_lanes`` (Pallas, interpret mode).

The kernel runs only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it to the plain version. This model runs
the kernel's order of operations in plain PyTorch, vectorized over the
batch and over the 32 lanes of a warp, and reads Linv and rhs from their
flat storage with the kernel's own index arithmetic:

* G lanes per QP (``lanes_per_qp``: a whole warp, or half of one where 16
  lanes' vectors cover a row), ``WARPS`` warps a block, the batch rounded
  up to whole blocks; a QP past the batch reads and writes nothing;
* lane l of a QP owns columns V l + G V t + j (j < V, t < K =
  ceil(m / G V)), with V = 4 (float32) or 2 (float64) on the 16-byte path
  and V = 1 on the scalar path, chosen from the storage's addresses and m
  as the launcher chooses;
* the row loop takes R rows at a time (``rows_in_flight``); a lane loads a
  whole vector when its first column is on or before the row's diagonal
  and sets the entries past the diagonal to zero;
* each lane's partial dot products, then a butterfly per row
  (``group_sums``) that gives every lane of the QP the R row sums, then
  the R rows' rank-1 terms of each x entry summed in pairs and added to
  the lane's accumulator (float32), or added to it row by row (float64).

An indexing, masking or ordering mistake in the scheme shows here on the
CPU. The sums are taken in another order than the plain version's two
batched products, so the two agree to rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpth_tpu.ops.pallas.lanes import inv_solve_lanes, pad_spd_lanes
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

LANES = 32
WARPS = 8              # kWarps in csrc/common.cuh
ROW_WORDS = 16         # kRowWords in csrc/inv_solve.cu
MAX_ROWS = 8           # kMaxRows
MAX_M = 256            # kMaxM

#: float64: max |model - plain| / max |plain|.
TOL_F64 = 1e-12
#: float32: the tolerance of tests/test_torch_kernels_step.py's inv_solve
#: test, 1e-5 x max |plain|.
TOL_F32 = 1e-5

MS = [1, 7, 13, 16, 17, 31, 32, 33, 40, 64, 100, 166, 237]
DTYPES = [torch.float32, torch.float64]


def vector_width(Linv, rhs, x=None):
    """Elements per load: 16 bytes when every operand starts on a 16-byte
    boundary and a row is a whole number of 16-byte vectors, else 1. ``x``
    is allocated by the wrapper (``torch.empty_like``) and is aligned when
    not given."""
    elt = Linv.element_size()
    ptrs = [t.data_ptr() for t in (Linv, rhs, x) if t is not None]
    m = rhs.shape[-1]
    aligned = all(p % 16 == 0 for p in ptrs) and (m * elt) % 16 == 0
    return 16 // elt if aligned else 1


def rows_in_flight(E, elt):
    """The largest power of two R <= MAX_ROWS whose R x E values of ``elt``
    bytes fit ROW_WORDS 32-bit registers (at least 1)."""
    r = 1
    while 2 * r <= MAX_ROWS and 2 * r * E * (elt // 4) <= ROW_WORDS:
        r *= 2
    return r


def lanes_per_qp(m, V):
    """G: a half warp where one slot of 16 lanes' vectors covers a row."""
    return 16 if m <= 16 * V else LANES


def _flat_read(flat, idx, ok):
    """flat[idx] where ok, else 0 (the kernel's predicated loads); every
    load made is inside the storage."""
    assert bool(((idx >= 0) & (idx < flat.numel()))[ok].all())
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    return torch.where(ok, flat[safe], torch.zeros((), dtype=flat.dtype))


def group_sums(p, counts=None):
    """p (W, G lanes, R): each of the R values summed over the QP's G lanes
    by a butterfly (offsets G / 2 .. 1, every lane adding its partner's
    value), returned as (W, R). ``counts["shuffles"]`` counts the shuffle
    instructions."""
    W, n_lanes, R = p.shape
    lane = torch.arange(n_lanes)
    off = n_lanes // 2
    while off >= 1:
        p = p + p[:, lane ^ off]
        if counts is not None:
            counts["shuffles"] = counts.get("shuffles", 0) + R
        off //= 2
    assert bool((p == p[:, :1]).all() | torch.isnan(p).any())
    return p[:, 0]


def model(Linv, rhs, counts=None):
    """inv_solve_kernel on Linv (B, m, m) and rhs (B, m) as stored."""
    B, m = rhs.shape
    assert 1 <= m <= MAX_M
    elt = Linv.element_size()
    V = vector_width(Linv, rhs)
    G = lanes_per_qp(m, V)
    K = (m + G * V - 1) // (G * V)
    R = rows_in_flight(K * V, elt)
    if V > 1:
        assert m % V == 0
    if counts is not None:
        counts.update(V=V, K=K, R=R, G=G)
    per_block = WARPS * (LANES // G)
    W = ((B + per_block - 1) // per_block) * per_block
    b = torch.arange(W).view(W, 1, 1, 1)
    live = b < B                                   # QPs past B
    lane = torch.arange(G).view(1, 1, G, 1)
    t = torch.arange(K).view(1, K, 1, 1)
    c0 = V * lane + G * V * t                      # (1, K, G, 1)
    c = c0 + torch.arange(V).view(1, 1, 1, V)      # (1, K, G, V)
    Lf = Linv.reshape(-1)
    rf = rhs.reshape(-1)

    ok = (live & (c0 < m)).expand(W, K, G, V)
    r = _flat_read(rf, (b * m + c).expand(W, K, G, V), ok)
    xa = torch.zeros(W, K, G, V, dtype=rhs.dtype)
    for i0 in range(0, m, R):
        rows = []
        for q in range(R):
            i = i0 + q
            ok = (live & (i < m) & (c0 <= i)).expand(W, K, G, V)
            val = _flat_read(Lf, (b * m * m + i * m + c).expand(
                W, K, G, V), ok)
            rows.append(torch.where(c > i, torch.zeros((), dtype=val.dtype),
                                    val))                 # past the diagonal
        w = torch.zeros(W, G, R, dtype=rhs.dtype)
        for q in range(R):
            for tt in range(K):
                for j in range(V):
                    w[:, :, q] = w[:, :, q] + rows[q][:, tt, :, j] * r[
                        :, tt, :, j]
        w = group_sums(w, counts)                         # (W, R)
        s = [rows[q] * w[:, q].view(W, 1, 1, 1) for q in range(R)]
        if elt == 4:                                      # pairs first
            h = R // 2
            while h >= 1:
                s = [s[q] + s[q + h] for q in range(h)]
                h //= 2
            xa = xa + s[0]
        else:                                             # row by row
            for q in range(R):
                xa = xa + s[q]

    x = torch.full((B * m,), float("nan"), dtype=rhs.dtype)
    store = (live & (c0 < m)).expand(W, K, G, V)
    idx = (b * m + c).expand(W, K, G, V)
    x[idx[store]] = xa[store]
    assert not bool(torch.isnan(x).any()) or bool(torch.isnan(Linv).any()
                                                   or torch.isnan(rhs).any())
    return x.view(B, m)


def _linv(rng, B, m, dtype):
    """Linv = inv(chol(T)) for T = C C^T / m + I, exact zeros above the
    diagonal (kernel A's output)."""
    C = rng.rand(B, m, m)
    T = C @ C.transpose(0, 2, 1) / m + np.eye(m)
    return torch.tensor(np.tril(np.linalg.inv(np.linalg.cholesky(T)))).to(
        dtype)


def _dirty(Linv):
    """Linv with NaN above the diagonal, which the kernel must not read."""
    m = Linv.shape[-1]
    return Linv.masked_fill(torch.ones(m, m, dtype=torch.bool).triu(1),
                            float("nan"))


def _err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _tol(dtype):
    return TOL_F32 if dtype == torch.float32 else TOL_F64


def _misaligned(v):
    """A copy of v whose storage starts one element past a 16-byte
    boundary: the scalar path whatever m."""
    buf = torch.empty(v.numel() + 8, dtype=v.dtype)
    skip = next(k for k in range(8)
                if buf[k:].data_ptr() % 16 == v.element_size())
    out = buf[skip:skip + v.numel()].view(v.shape)
    out.copy_(v)
    return out


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", MS)
def test_model_matches_plain(m, dtype, B):
    """Every m from 1 to kernel A's largest fit, a batch of one QP, part of
    one block, one whole block and a ragged second block; the kernel's
    input holds NaN above the diagonal."""
    rng = np.random.RandomState(1000 * m + B)
    Linv = _linv(rng, B, m, dtype)
    rhs = torch.tensor(rng.randn(B, m)).to(dtype)
    got = model(_dirty(Linv), rhs)
    want = kernels.inv_solve_plain(Linv, rhs)
    assert got.shape == (B, m)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [16, 32, 40, 64, 100])
def test_scalar_path_matches_plain(m, dtype):
    """An rhs off a 16-byte boundary takes the scalar path at an m whose
    rows are whole vectors."""
    rng = np.random.RandomState(m)
    B = 11
    Linv = _linv(rng, B, m, dtype)
    rhs = torch.tensor(rng.randn(B, m)).to(dtype)
    counts = {}
    aligned = model(_dirty(Linv), rhs, counts)
    assert counts["V"] == 16 // Linv.element_size()
    rhs_off = _misaligned(rhs)
    counts = {}
    got = model(_dirty(Linv), rhs_off, counts)
    assert counts["V"] == 1 and counts["K"] == (m + 31) // 32
    want = kernels.inv_solve_plain(Linv, rhs)
    assert _err(got, want) <= _tol(dtype)
    assert _err(aligned, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [7, 13])
def test_model_matches_pallas(m, dtype):
    """Against the TPU kernel the kernel replaces, as
    tests/test_torch_kernels_step.py runs it (interpret mode)."""
    rng = np.random.RandomState(50 + m)
    B = 8
    Linv = _linv(rng, B, m, dtype)
    rhs = torch.tensor(rng.randn(B, m)).to(dtype)
    G_t = pad_spd_lanes(jnp.asarray(Linv.numpy().transpose(1, 2, 0)))
    want = torch.tensor(np.asarray(inv_solve_lanes(
        G_t, jnp.asarray(rhs.numpy().T), interpret=True)).T)
    assert want.dtype == dtype
    got = model(_dirty(Linv), rhs)
    assert _err(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [37, 40])
def test_nan_lane_stays_alone(m, dtype):
    """A lane whose Linv holds NaN (kernel A's non-SPD lane) gives NaN in
    that lane alone, beside finite lanes of its block and of the ragged
    next one; m = 37 runs the scalar path, 40 the 16-byte one."""
    rng = np.random.RandomState(m)
    B = 11
    Linv = _linv(rng, B, m, dtype)
    Linv[3, m // 2, m // 2] = float("nan")
    rhs = torch.tensor(rng.randn(B, m)).to(dtype)
    got = model(_dirty(Linv), rhs)
    want = kernels.inv_solve_plain(Linv, rhs)
    bad = torch.isnan(got).any(dim=1)
    assert bad.tolist() == [k == 3 for k in range(B)]
    assert torch.equal(bad, torch.isnan(want).any(dim=1))
    assert _err(got[~bad], want[~bad]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [33, 40, 100])
def test_only_the_lower_triangle_is_read(m, dtype):
    """What the upper triangle holds never reaches the result: NaN there
    gives the same bits as zeros, on both paths (m = 33 scalar)."""
    rng = np.random.RandomState(7 + m)
    B = 9
    Linv = _linv(rng, B, m, dtype)
    rhs = torch.tensor(rng.randn(B, m)).to(dtype)
    assert torch.equal(model(_dirty(Linv), rhs), model(Linv, rhs))
    noise = torch.tensor(rng.randn(B, m, m)).to(dtype).triu(1)
    assert torch.equal(model(Linv + noise, rhs), model(Linv, rhs))


def test_rows_in_flight_and_shuffles():
    """The source note's figures on the 16-byte path: f32 m = 40 runs a
    half warp per QP and 4 rows at a time, f32 m = 100 a warp and 4 rows,
    f64 m = 100 a warp and 2 rows; each row's sum takes log2 G shuffles."""
    rng = np.random.RandomState(0)
    for m, dtype, G_want, R_want in ((40, torch.float32, 16, 4),
                                     (100, torch.float32, 32, 4),
                                     (100, torch.float64, 32, 2)):
        Linv = _linv(rng, 2, m, dtype)
        rhs = torch.tensor(rng.randn(2, m)).to(dtype)
        counts = {}
        model(Linv, rhs, counts)
        R, G = counts["R"], counts["G"]
        assert (G, R) == (G_want, R_want)
        assert counts["V"] == 16 // Linv.element_size()
        assert counts["shuffles"] == -(-m // R) * R * int(np.log2(G))
    assert [rows_in_flight(E, 4) for E in (1, 2, 4, 8)] == [8, 8, 4, 2]
    assert [rows_in_flight(E, 8) for E in (1, 2, 4, 6, 8)] == [8, 4, 2, 1, 1]
    assert [lanes_per_qp(m, 4) for m in (40, 64, 65, 100)] == [16, 16, 32, 32]
    assert [lanes_per_qp(m, 1) for m in (16, 17)] == [16, 32]
