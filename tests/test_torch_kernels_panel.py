"""A CPU model of the panel kernels C (``qpth_tpu_torch/csrc/chol.cu``) and
E (``qpth_tpu_torch/csrc/trinv.cu``) over ``csrc/panel.cuh``, held to their
plain versions ``chol_plain`` / ``trinv_plain`` and, at small m, to the JAX
package's Pallas kernels (interpret mode).

The kernels run only on the card, where ``chip_smoke.py`` holds them to the
plain versions. This model runs their order of operations step by step in
plain PyTorch, vectorized over the batch and over a warp's lanes:

* kernel C: R's upper triangle staged in one m x m tile (the lower part
  holds NaN here, standing for whatever the tile held: the kernel never
  reads it); per panel of 32 rows (ragged last), (a) the diagonal block's
  rank-1 recurrence, lane c holding column c, the shift added to each pivot
  when it is reached; (b) the panel's rows beyond the block, a column per
  thread, by forward substitution in sub-blocks of 8 rows, their later rows
  four at a time; (c) the rank-w update of the trailing upper triangle, k
  ascending. With rhs, y rides as one more column of (b) and (c); the back
  substitution runs by panels from the last, each panel's chain in one warp,
  then the rows above it;
* kernel E: Lt's strict upper triangle and inv(L)'s lower one in one tile,
  the reciprocals of Lt's diagonal in a vector; every 32 x 32 diagonal block
  inverted at once (lane e solving column e), then per row block the
  products C = -L[I, :I] invL[:I, :I] and invL[I, :I] = X_II C.

A layout, masking or ordering mistake in the scheme shows here on the CPU.
The factor takes every rank-1 update in pivot order, as ``chol_plain``
does, so in float64 the model's Lt equals the plain version's to the last
bit; its solve and the triangular inverse add in other orders.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.cholesky import (cholesky_t_pallas,
                                          factor_kkt_t_pallas, trinv_pallas)
from qpth_tpu.ops.pallas.lanes import (factor_kkt_lanes,
                                       factor_solve_kkt_lanes, pad_spd_lanes)
from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

P = 32     # panel rows = lanes per warp (kPanelWidth)
SUB = 8    # rows per sub-block of the panel solve (kSub)
MS = [1, 31, 32, 33, 37, 64, 65, 100, 239]
#: float32 against the plain versions: chip_smoke.py phase 2's tolerance
#: (max difference scaled by max(1, max |plain|)).
TOL_F32 = 1e-3
#: float64: relative to max |plain|.
TOL_F64 = 1e-11


# ---------------------------------------------------------------------------
# Kernel C
# ---------------------------------------------------------------------------

def _diag_block(tile, p0, w, dinv, isqv):
    """chol_diag_block: the w x w block's rank-1 recurrence, upper triangle
    only; lane c holds column c, step j updates rows j < r <= c."""
    D = tile[:, p0:p0 + w, p0:p0 + w]
    for j in range(w):
        piv = D[:, j, j] + dinv[:, p0 + j] if dinv is not None else D[:, j, j]
        isq = torch.rsqrt(piv)
        isqv[:, p0 + j] = isq
        u = D[:, j, j:] * isq.unsqueeze(-1)
        u[:, 0] = piv * isq
        D[:, j, j:] = u
        uu = u[:, 1:]
        D[:, j + 1:, j + 1:] -= torch.triu(uu.unsqueeze(-1) * uu.unsqueeze(-2))


def _panel_solve(U, isq, X):
    """panel_solve_column on every column of X (B, w, cols) at once: the
    sub-blocks' chains, then each sub-block's later rows, j ascending."""
    w = X.shape[1]
    for s0 in range(0, w, SUB):
        ws = min(SUB, w - s0)
        for j in range(s0, s0 + ws):
            X[:, j] *= isq[:, j].unsqueeze(-1)
            X[:, j + 1:s0 + ws] -= (U[:, j, j + 1:s0 + ws].unsqueeze(-1)
                                    * X[:, j:j + 1])
        for j in range(s0, s0 + ws):
            X[:, s0 + ws:] -= U[:, j, s0 + ws:].unsqueeze(-1) * X[:, j:j + 1]


def chol_model(R, dinv=None, rhs=None, barriers=None, isqv=None):
    """Kernel C's order of operations: Lt, or (Lt, x) with ``rhs``. Each
    block barrier of the kernel (``__syncthreads()``) is appended to
    ``barriers`` at the point where the kernel passes it; ``isqv``, a (B, m)
    tensor, receives the pivots' rsqrt."""
    bar = [] if barriers is None else barriers
    m = R.shape[-1]
    vecs = [v for v in (dinv, rhs) if v is not None]
    B = vecs[0].shape[0] if vecs else R.shape[0]
    nan = torch.tensor(float("nan"), dtype=R.dtype)
    upper = torch.ones(m, m, dtype=torch.bool).triu()
    tile = torch.where(upper, R.expand(B, m, m), nan)     # staged: upper only
    if isqv is None:
        isqv = torch.zeros(B, m, dtype=R.dtype)
    ys = rhs.clone() if rhs is not None else None
    bar.append("staged")
    _diag_block(tile, 0, min(P, m), dinv, isqv)
    bar.append("first (a)")
    for p0 in range(0, m, P):
        w = min(P, m - p0)
        base = p0 + w
        U = tile[:, p0:base, p0:base]
        isq = isqv[:, p0:base]
        X = tile[:, p0:base, base:].clone()               # (b)
        if ys is not None:
            X = torch.cat([X, ys[:, p0:base].unsqueeze(-1)], dim=-1)
        _panel_solve(U, isq, X)
        tile[:, p0:base, base:] = X[:, :, :m - base]
        if ys is not None:
            ys[:, p0:base] = X[:, :, -1]
        bar.append("(b)")
        if base == m:
            break
        W = tile[:, p0:base, base:]                       # (c), k ascending
        for k in range(w):
            wk = W[:, k]
            tile[:, base:, base:] -= torch.triu(wk.unsqueeze(-1)
                                                * wk.unsqueeze(-2))
            if ys is not None:
                ys[:, base:] -= wk * ys[:, p0 + k].unsqueeze(-1)
        bar.append("(c) on the next diagonal block")
        _diag_block(tile, base, min(P, m - base), dinv, isqv)
        bar.append("(c) and the next (a)")
    Lt = torch.where(upper, tile, torch.zeros((), dtype=R.dtype))
    if rhs is None:
        return Lt
    xs = ys
    for p0 in range(((m - 1) // P) * P, -1, -P):          # back substitution
        w = min(P, m - p0)
        r = xs[:, p0:p0 + w]                              # warp 0's lanes
        for k in range(w - 1, -1, -1):
            r[:, k] = r[:, k] * isqv[:, p0 + k]
            r[:, :k] -= Lt[:, p0:p0 + k, p0 + k] * r[:, k:k + 1]
        for k in range(w):                                # rows above
            xs[:, :p0] -= Lt[:, :p0, p0 + k] * xs[:, p0 + k:p0 + k + 1]
        bar.append("back substitution panel")
    return Lt, xs


# ---------------------------------------------------------------------------
# Kernel E
# ---------------------------------------------------------------------------

def trinv_model(Lt, barriers=None, rd=None):
    """Kernel E's order of operations (panel.cuh::trinv_panels after E's
    staging): inv(L) from Lt = L^T; its block barriers are appended to
    ``barriers`` as in :func:`chol_model`. ``rd``, the reciprocals of Lt's
    diagonal, defaults to E's 1 / Lt[j][j] (kernel A passes the pivots'
    rsqrt); the diagonal itself is not read."""
    bar = [] if barriers is None else barriers
    B, n = Lt.shape[0], Lt.shape[-1]
    nan = torch.tensor(float("nan"), dtype=Lt.dtype)
    strict_upper = torch.ones(n, n, dtype=torch.bool).triu(1)
    tile = torch.where(strict_upper, Lt, nan)       # lower part: not yet set
    if rd is None:
        rd = 1.0 / torch.diagonal(Lt, dim1=1, dim2=2)
    bar.append("staged")
    for p0 in range(0, n, P):                       # the diagonal blocks
        w = min(P, n - p0)
        X = torch.eye(w, dtype=Lt.dtype).expand(B, w, w).clone()  # X[:, i, e]
        for j in range(w):
            X[:, j] *= rd[:, p0 + j].unsqueeze(-1)
            X[:, j + 1:] -= (Lt[:, p0 + j, p0 + j + 1:p0 + w].unsqueeze(-1)
                             * X[:, j:j + 1])
        lower = torch.ones(w, w, dtype=torch.bool).tril()
        blk = tile[:, p0:p0 + w, p0:p0 + w]
        tile[:, p0:p0 + w, p0:p0 + w] = torch.where(lower, X, blk)
    bar.append("diagonal blocks")
    for I0 in range(P, n, P):                       # the row blocks
        w = min(P, n - I0)
        C = torch.zeros(B, w, I0, dtype=Lt.dtype)
        low = torch.ones(I0, I0, dtype=torch.bool).tril()
        inv_top = torch.where(low, tile[:, :I0, :I0],
                              torch.zeros((), dtype=Lt.dtype))
        for k in range(I0):                         # k ascending, k >= c
            C -= (tile[:, k, I0:I0 + w].unsqueeze(-1)
                  * inv_top[:, k].unsqueeze(-2))
        bar.append("C")
        Xb = tile[:, I0:I0 + w, I0:I0 + w]
        out = torch.zeros_like(C)
        for s in range(w):                          # s ascending, s <= r
            out[:, s:] += Xb[:, s:, s].unsqueeze(-1) * C[:, s:s + 1]
        tile[:, I0:I0 + w, :I0] = out
        bar.append("X_II C")
    return torch.where(strict_upper, torch.zeros((), dtype=Lt.dtype), tile)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _gram(rng, bR, m, dtype):
    M = torch.tensor(rng.rand(bR, m, m))
    R = torch.matmul(M, M.transpose(-1, -2)) / m + torch.eye(m, dtype=M.dtype)
    return R.to(dtype)


def _args(rng, m, variant, shared, dtype, B=3):
    R = _gram(rng, 1 if shared else B, m, dtype)
    dinv = torch.tensor(rng.rand(B, m) + 0.5).to(dtype)
    rhs = torch.tensor(rng.rand(B, m) - 0.5).to(dtype)
    if variant == "factor" and shared:
        R = R.expand(B, m, m).contiguous()
    return {"factor": (R, None, None), "shift": (R, dinv, None),
            "shift_rhs": (R, dinv, rhs), "rhs": (R, None, rhs)}[variant]


def _scaled_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


VARIANTS = ["factor", "shift", "shift_rhs", "rhs"]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", MS)
def test_chol_model_matches_plain_f64(rng, m, variant, shared):
    """Every m of the panel scheme, ragged last panels included: the factor
    to the last bit, the solve to 1e-11."""
    args = _args(rng, m, variant, shared, torch.float64)
    got = chol_model(*args)
    want = kernels.chol_plain(*args)
    if args[2] is None:
        got, want = (got,), (want,)
    npt.assert_array_equal(got[0].numpy(), want[0].numpy())
    for a, b in zip(got[1:], want[1:]):
        assert _scaled_err(a, b) <= TOL_F64


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [33, 100])
def test_chol_model_matches_plain_f32(rng, m, variant):
    args = _args(rng, m, variant, False, torch.float32)
    got = chol_model(*args)
    want = kernels.chol_plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert _scaled_err(a, b) <= TOL_F32


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trinv_model_matches_plain(rng, m, dtype):
    Lt = kernels.chol_plain(_gram(rng, 3, m, torch.float64)).to(dtype)
    got = trinv_model(Lt)
    want = kernels.trinv_plain(Lt)
    assert bool(torch.isfinite(got).all())
    assert _scaled_err(got, want) <= (TOL_F64 if dtype == torch.float64
                                      else TOL_F32)
    assert not torch.triu(got, 1).any()


def test_noise_below_the_diagonal_is_never_read(rng):
    """R's strictly lower triangle may hold anything (R from a product is
    not bitwise symmetric): the factor and solve come from the upper one,
    and both outputs carry exact zeros across the diagonal."""
    m, B = 65, 4
    R, dinv, rhs = _args(rng, m, "shift_rhs", False, torch.float64, B)
    noisy = R + torch.tril(torch.tensor(rng.randn(B, m, m)), -1)
    Lt, x = chol_model(noisy, dinv, rhs)
    Lt0, x0 = chol_model(R, dinv, rhs)
    npt.assert_array_equal(Lt.numpy(), Lt0.numpy())
    npt.assert_array_equal(x.numpy(), x0.numpy())
    assert not torch.tril(Lt, -1).any()
    # E reads only Lt's upper triangle too.
    noisy_Lt = Lt + torch.tril(torch.tensor(rng.randn(B, m, m)), -1)
    npt.assert_array_equal(trinv_model(noisy_Lt).numpy(),
                           trinv_model(Lt).numpy())


@pytest.mark.parametrize("m", [37, 100])
def test_non_spd_lane_is_nan_alone(rng, m):
    """A lane whose T is not SPD comes back NaN in its factor and solve, the
    other lanes untouched, as in the plain version."""
    R, dinv, rhs = _args(rng, m, "shift_rhs", False, torch.float64, 5)
    R[2] = -R[2]
    Lt, x = chol_model(R, dinv, rhs)
    Lp, xp = kernels.chol_plain(R, dinv, rhs)
    bad = torch.isnan(Lt).any(dim=(1, 2))
    assert bad.tolist() == [k == 2 for k in range(5)]
    assert torch.equal(torch.isnan(Lt), torch.isnan(Lp))
    assert torch.isnan(x).any(dim=1).tolist() == bad.tolist()
    keep = ~bad
    npt.assert_array_equal(Lt[keep].numpy(), Lp[keep].numpy())


# ---------------------------------------------------------------------------
# Against the JAX package's kernels (interpret mode), small m
# ---------------------------------------------------------------------------

def _spd_np(rng, B, n, dtype=np.float32):
    L0 = rng.rand(B, n, n).astype(dtype)
    return L0 @ L0.transpose(0, 2, 1) + 5 * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("m", [1, 32, 33])
def test_chol_model_matches_pallas(rng, m):
    """cholesky_t_pallas and factor_kkt_t_pallas (B = 4), at the tolerance
    of tests/test_torch_kernels_chol.py (5e-5 on factors)."""
    B = 4
    A = _spd_np(rng, B, m)
    want = np.asarray(cholesky_t_pallas(jnp.asarray(A), interpret=True))
    npt.assert_allclose(chol_model(torch.tensor(A)).numpy(), want, atol=5e-5)
    d = rng.rand(B, m).astype(np.float32) + 0.5
    want = np.asarray(factor_kkt_t_pallas(jnp.asarray(A[:1]), jnp.asarray(d),
                                          interpret=True))
    got = chol_model(torch.tensor(A[:1]), torch.tensor(1.0 / d))
    npt.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("m", [1, 32, 33])
def test_trinv_model_matches_pallas(rng, m):
    Lt = np.linalg.cholesky(_spd_np(rng, 4, m)).transpose(0, 2, 1).copy()
    want = np.asarray(trinv_pallas(jnp.asarray(Lt), interpret=True))
    npt.assert_allclose(trinv_model(torch.tensor(Lt)).numpy(), want,
                        atol=1e-5)


@pytest.mark.parametrize("m", [8, 13])
def test_chol_model_matches_lanes_kernels(rng, m):
    """factor_kkt_lanes and factor_solve_kkt_lanes in their (m_p, m_p, B)
    layout, converted as tests/test_torch_kernels_chol.py does (B = 8)."""
    B = 8
    L0 = rng.rand(B, m, m).astype(np.float32)
    R = L0 @ L0.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    dinv = (rng.rand(B, m) + 0.5).astype(np.float32)
    v = rng.randn(B, m).astype(np.float32)
    R_t = pad_spd_lanes(jnp.asarray(R.transpose(1, 2, 0)))
    Lt_l, x_l = factor_solve_kkt_lanes(R_t, jnp.asarray(dinv.T),
                                       jnp.asarray(v.T), interpret=True)
    Lt_k = factor_kkt_lanes(R_t, jnp.asarray(dinv.T), interpret=True)
    Lt, x = chol_model(torch.tensor(R), torch.tensor(dinv), torch.tensor(v))
    for ref in (Lt_l, Lt_k):
        want = np.triu(np.asarray(ref).transpose(2, 0, 1)[:, :m, :m])
        npt.assert_allclose(Lt.numpy(), want, atol=5e-5)
    npt.assert_allclose(x.numpy(), np.asarray(x_l).T, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# Block barriers and the fit predicate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 31, 32, 33, 65, 100])
def test_barriers_per_qp(rng, m):
    """The models pass a block barrier wherever the kernels call
    __syncthreads(). Their counts are the ones the source notes state and
    the libraries give chip_smoke.py phase 10 (chol.cu::chol_barriers,
    trinv.cu::trinv_barriers): 3 per panel for C, 1 per panel more with
    rhs, 2 per row block for E; 12, 16 and 8 at m = 100 (the per-pivot
    kernel C passed 100)."""
    panels = -(-m // P)
    for variant, want in (("shift", 3 * panels), ("shift_rhs", 4 * panels)):
        bars = []
        chol_model(*_args(rng, m, variant, False, torch.float64, B=1),
                   barriers=bars)
        assert len(bars) == want
    bars = []
    trinv_model(kernels.chol_plain(_gram(rng, 1, m, torch.float64)),
                barriers=bars)
    assert len(bars) == 2 * panels


def test_fit_predicates_follow_the_launchers():
    """chol_fits states, by value, the bytes kernels C and E launch with
    (csrc/panel.cuh::chol_smem_bytes: the m x m tile and 4 m-vectors within
    227 KB, m <= 256 threads), so E's wrapper admits every n that E can
    launch: float32 n <= 239, float64 n <= 168, where the two-tile version
    of E fitted only 169 / 120."""
    for dtype, largest in ((torch.float32, 239), (torch.float64, 168)):
        elt = dtype.itemsize
        for m in range(1, 300):
            assert kernels.chol_fits(m, dtype) == (
                m <= 256 and (m * m + 4 * m) * elt <= 227 * 1024)
        assert kernels.chol_fits(largest, dtype)
        assert not kernels.chol_fits(largest + 1, dtype)
        # A kernel E that staged two n x (n | 1) tiles could not launch at
        # float32 n = 200, 239 or float64 n = 150, 168, inside chol_fits.
        for n in ((200, 239) if dtype == torch.float32 else (150, 168)):
            assert 2 * n * (n | 1) * elt > 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fits_is_unchanged_by_the_panel_step(dtype):
    """The fused steps factor on the panels inside the working set they
    had (csrc/common.cuh::smem_bytes: the m x m tile, 8 m-vectors, the
    nz-vector and 4 neq-vectors, beside 8 words of reduction scratch), so
    kernels.fits admits exactly what it admitted with the factor-inverse:
    m <= 237 in float32 and m <= 166 in float64 at nz = neq = 0, and path
    8c's shape (nineq = 100, nz = 512, neq = 64)."""
    src = (Path(kernels.__file__).resolve().parents[2] / "csrc"
           / "common.cuh").read_text()
    for name, value in (("kSmemVectors", kernels.SMEM_VECTORS),
                        ("kSmemEqVectors", kernels.SMEM_EQ_VECTORS),
                        ("kThreads", kernels.THREADS)):
        assert f"constexpr int {name} = {value};" in src
    elt = dtype.itemsize
    for m in range(1, 300):
        for nz, neq in ((0, 0), (7, 8), (100, 0), (100, 50), (512, 64)):
            words = m * m + 8 * m + 8 + nz + 4 * neq
            assert kernels.fits(m, dtype, nz, neq) == (
                m <= 256 and words * elt <= 227 * 1024)
    largest = 237 if dtype == torch.float32 else 166
    assert kernels.fits(largest, dtype)
    assert not kernels.fits(largest + 1, dtype)
    assert kernels.fits(100, dtype, 512, 64)
