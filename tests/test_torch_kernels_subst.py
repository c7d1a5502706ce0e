"""A CPU model of kernel D's two substitutions
(``qpth_tpu_torch/csrc/cho_solve.cu``), held to the plain version
``cho_solve_plain``.

The kernel runs only on the card, where ``chip_smoke.py`` holds it to the
plain version. This model runs the kernel's order of operations step by
step in plain PyTorch, vectorized over the batch and over the 32 lanes of a
warp, and reads the factor from its flat storage with the kernel's own
index arithmetic:

* per-lane factors (``cho_solve_lanes_kernel``): the right-hand side in
  slots of 32 (element 32 t + lane in slot t), panels of 32 rows, each
  32 x 32 block of U = L^T staged into a tile from rows of Lt as they are
  or rows of L transposed (a diagonal block only up to the diagonal); the
  chain over each diagonal block, then the panel's block row (forward) or
  block column (backward) on the panels not yet solved;
* a shared factor (``cho_solve_shared_kernel``): the triangle packed as the
  block stages it, 32 right-hand sides per block (the batch padded to a
  multiple of 32 with zero columns), warp 0's chain over each panel's
  diagonal block, then the update of the remaining rows.

A layout, orientation or ordering mistake in the scheme shows here on the
CPU. Both substitutions run in column (SAXPY) order, each division a
product with the pivot's reciprocal: the forward pass adds as the plain
version does, the backward pass (a dot product per row in the plain
version) adds the same products in another order.
"""

import numpy as np
import pytest
import torch

from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

P = 32  # panel rows = lanes per warp

#: float32 tolerance of chip_smoke.py phase 2 (max difference scaled by
#: max(1, max |plain|)): the backward pass adds in another order than the
#: plain version, the pivots are applied as reciprocals, and the kernel
#: fuses each update into one multiply-add; each of these moves a result
#: by a few units in the last place times the factor's condition.
TOL_F32 = 1e-3
#: float64: relative to max |plain|.
TOL_F64 = 1e-12


def _flat_read(flat, idx, ok):
    """flat[:, idx] where ok, else 0 (the kernel's masked loads)."""
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    return torch.where(ok, flat[:, safe], torch.zeros((), dtype=flat.dtype))


def _stage_block(flat, n, lower, s, t):
    """stage_block: tile[:, a, b] = U[32 s + a][32 t + b], read from rows of
    Lt (upper) or rows of L stored transposed (lower); zero beyond n and,
    in a diagonal block, across the diagonal."""
    lanes = torch.arange(P)
    tile = torch.zeros(flat.shape[0], P, P, dtype=flat.dtype)
    for q in range(P):
        row = (P * t if lower else P * s) + q
        col = (P * s if lower else P * t) + lanes
        ok = (col < n) & (row < n)
        if s == t:
            ok &= (col <= row) if lower else (col >= row)
        val = _flat_read(flat, row * n + col, ok)
        if lower:
            tile[:, :, q] = val
        else:
            tile[:, q, :] = val
    return tile


def _chain_forward(tile, r, rows):
    """chain_forward on r (B, 32): the pivot's reciprocal, then the
    diagonal block's updates, lane by lane."""
    lanes = torch.arange(P)
    inv = 1.0 / torch.diagonal(tile, dim1=1, dim2=2)   # each lane's pivot
    for i in range(rows):
        u = tile[:, i, :]                                # U[32s+i][32s+lane]
        r[:, i] = r[:, i] * inv[:, i]
        after = lanes > i
        r[:, after] -= u[:, after] * r[:, i:i + 1]


def _chain_backward(tile, r, rows):
    lanes = torch.arange(P)
    inv = 1.0 / torch.diagonal(tile, dim1=1, dim2=2)
    for k in range(rows - 1, -1, -1):
        u = tile[:, :, k]                                # U[32s+lane][32s+k]
        r[:, k] = r[:, k] * inv[:, k]
        before = lanes < k
        r[:, before] -= u[:, before] * r[:, k:k + 1]


def lanes_model(F, v, lower, backward=True):
    """cho_solve_lanes_kernel, one warp per QP: F (B, n, n) as stored.
    Both passes right-looking: panel p's diagonal block, then its block row
    (forward) or block column (backward) of U on the other panels.
    ``backward=False`` returns y of the forward pass."""
    B, n = v.shape
    flat = F.reshape(B, n * n)
    ns = (n + P - 1) // P
    lanes = torch.arange(P)
    r = torch.zeros(B, ns, P, dtype=v.dtype)
    for t in range(ns):
        k = P * t + lanes
        r[:, t] = _flat_read(v, k, k < n)

    for p in range(ns):                                  # forward
        rows = min(P, n - P * p)
        _chain_forward(_stage_block(flat, n, lower, p, p), r[:, p], rows)
        ys = r[:, p, :].clone()
        for t in range(p + 1, ns):
            tile = _stage_block(flat, n, lower, p, t)
            for i in range(rows):
                r[:, t] -= tile[:, i, :] * ys[:, i:i + 1]
    if not backward:
        return r.reshape(B, ns * P)[:, :n]

    for p in range(ns - 1, -1, -1):                      # backward
        rows = min(P, n - P * p)
        _chain_backward(_stage_block(flat, n, lower, p, p), r[:, p], rows)
        ys = r[:, p, :].clone()
        for t in range(p - 1, -1, -1):
            tile = _stage_block(flat, n, lower, t, p)
            for k in range(rows - 1, -1, -1):
                r[:, t] -= tile[:, :, k] * ys[:, k:k + 1]

    return r.reshape(B, ns * P)[:, :n]


def _tri(k):
    return k * (k + 1) // 2


def shared_model(F, v, lower, backward=True):
    """cho_solve_shared_kernel: F (1, n, n) as stored, v (B, n).
    ``backward=False`` returns y of the forward pass."""
    B, n = v.shape
    flat = F.reshape(n * n)
    Lp = torch.zeros(_tri(n), dtype=v.dtype)              # packed lower L
    for k in range(n):
        for j in range(k + 1):
            Lp[_tri(k) + j] = flat[k * n + j] if lower else flat[j * n + k]
    inv = 1.0 / Lp[[_tri(k) + k for k in range(n)]]    # the pivots
    nb = (B + P - 1) // P
    X = torch.zeros(n, nb * P, dtype=v.dtype)            # X[i][c], padded
    X[:, :B] = v.T

    for p0 in range(0, n, P):                            # forward
        rows = min(P, n - p0)
        yr = X[p0:p0 + rows].clone()                     # warp 0's registers
        for j in range(rows):
            jg = p0 + j
            y = yr[j] * inv[jg]
            yr[j] = y
            for i in range(j + 1, rows):
                yr[i] -= Lp[_tri(p0 + i) + jg] * y
        X[p0:p0 + rows] = yr
        for i in range(p0 + rows, n):                    # rows below
            for j in range(rows):
                X[i] -= Lp[_tri(i) + p0 + j] * X[p0 + j]
    if not backward:
        return X[:, :B].T.contiguous()

    for p0 in range(((n - 1) // P) * P, -1, -P):         # backward
        rows = min(P, n - p0)
        xr = X[p0:p0 + rows].clone()
        for k in range(rows - 1, -1, -1):
            kg = p0 + k
            xk = xr[k] * inv[kg]
            xr[k] = xk
            for i in range(k):
                xr[i] -= Lp[_tri(kg) + p0 + i] * xk
        X[p0:p0 + rows] = xr
        for i in range(p0):                              # rows above
            for k in range(rows - 1, -1, -1):
                X[i] -= Lp[_tri(p0 + k) + i] * X[p0 + k]

    return X[:, :B].T.contiguous()


def _factor(rng, bF, n, dtype, lower, garbage=True):
    """A Cholesky factor as the callers hold it: Lt from chol_plain, or L
    with lower=True; with ``garbage`` the entries across the diagonal hold
    noise, which neither version may read."""
    M = torch.tensor(rng.rand(bF, n, n))
    R = torch.matmul(M, M.transpose(-1, -2)) / n + torch.eye(n,
                                                           dtype=M.dtype)
    F = kernels.chol_plain(R)
    if lower:
        F = F.transpose(-1, -2)
    if garbage and n > 1:
        noise = torch.tensor(rng.randn(bF, n, n))
        F = F + (torch.triu(noise, 1) if lower else torch.tril(noise, -1))
    return F.to(dtype).contiguous()


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _scaled(got, want):
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


@pytest.mark.parametrize("n", [1, 37, 100, 239])
@pytest.mark.parametrize("lower", [False, True])
def test_lanes_model_matches_plain_f64(n, lower):
    rng = np.random.RandomState(n + 7 * lower)
    B = 3
    F = _factor(rng, B, n, torch.float64, lower)
    v = torch.tensor(rng.randn(B, n))
    got = lanes_model(F, v, lower)
    want = kernels.cho_solve_plain(F, v, lower)
    assert _rel(got, want) <= TOL_F64


@pytest.mark.parametrize("n", [1, 37, 100, 168, 239])
@pytest.mark.parametrize("lower", [False, True])
def test_shared_model_matches_plain_f64(n, lower):
    rng = np.random.RandomState(100 + n + 7 * lower)
    B = 37                                  # not a multiple of 32
    F = _factor(rng, 1, n, torch.float64, lower)
    v = torch.tensor(rng.randn(B, n))
    got = shared_model(F, v, lower)
    want = kernels.cho_solve_plain(F, v, lower)
    assert _rel(got, want) <= TOL_F64


@pytest.mark.parametrize("B", [1, 64, 65])
def test_shared_model_ragged_batch(B):
    """Right-hand-side tiles of 32: a batch of 1, a multiple of 32, and one
    column into a new tile."""
    rng = np.random.RandomState(B)
    n = 37
    F = _factor(rng, 1, n, torch.float64, True)
    v = torch.tensor(rng.randn(B, n))
    got = shared_model(F, v, True)
    assert got.shape == (B, n)
    assert _rel(got, kernels.cho_solve_plain(F, v, True)) <= TOL_F64


@pytest.mark.parametrize("regime", ["lanes", "shared"])
@pytest.mark.parametrize("n", [37, 100])
def test_models_match_plain_f32(regime, n):
    rng = np.random.RandomState(300 + n)
    B = 5
    for lower in (False, True):
        F = _factor(rng, 1 if regime == "shared" else B, n, torch.float32,
                    lower)
        v = torch.tensor(rng.randn(B, n), dtype=torch.float32)
        model = shared_model if regime == "shared" else lanes_model
        got = model(F, v, lower)
        want = kernels.cho_solve_plain(F, v, lower)
        assert bool(torch.isfinite(got).all())
        assert _scaled(got, want) <= TOL_F32


@pytest.mark.parametrize("lower", [False, True])
def test_forward_pass_adds_as_the_plain_version(lower):
    """The forward pass runs the plain version's column order with each
    division made a product with the pivot's reciprocal: in both regimes
    and layouts the model's y equals that loop bit for bit, and the plain
    version's to a few units in the last place."""
    rng = np.random.RandomState(5)
    B, n = 3, 70
    for model, bF in ((lanes_model, B), (shared_model, 1)):
        F = _factor(rng, bF, n, torch.float64, lower)
        v = torch.tensor(rng.randn(B, n))
        U = (F.transpose(-1, -2) if lower else F).expand(B, n, n)
        y, y_div = v.clone(), v.clone()
        for j in range(n):
            yj = y[:, j] * (1.0 / U[:, j, j])
            y[:, j + 1:] -= U[:, j, j + 1:] * yj.unsqueeze(-1)
            y[:, j] = yj
            yj = y_div[:, j] / U[:, j, j]
            y_div[:, j + 1:] -= U[:, j, j + 1:] * yj.unsqueeze(-1)
            y_div[:, j] = yj
        got = model(F, v, lower, backward=False)
        assert torch.equal(got, y)
        assert _rel(got, y_div) <= TOL_F64


def test_nan_lane_stays_alone():
    """A lane whose factor has NaN (kernel C's non-SPD lane) gives NaN in
    that lane alone; in the shared regime a NaN right-hand side stays in
    its own column."""
    rng = np.random.RandomState(9)
    B, n = 6, 37
    for lower in (False, True):
        F = _factor(rng, B, n, torch.float64, lower)
        F[3, 5, 5] = float("nan")
        v = torch.tensor(rng.randn(B, n))
        got = lanes_model(F, v, lower)
        want = kernels.cho_solve_plain(F, v, lower)
        bad = torch.isnan(got).any(dim=1)
        assert bad.tolist() == [k == 3 for k in range(B)]
        assert torch.equal(bad, torch.isnan(want).any(dim=1))
        assert _rel(got[~bad], want[~bad]) <= TOL_F64

        Fs = _factor(rng, 1, n, torch.float64, lower)
        vs = torch.tensor(rng.randn(B, n))
        vs[3, 0] = float("nan")
        got = shared_model(Fs, vs, lower)
        bad = torch.isnan(got).any(dim=1)
        assert bad.tolist() == [k == 3 for k in range(B)]
        want = kernels.cho_solve_plain(Fs, vs, lower)
        assert _rel(got[~bad], want[~bad]) <= TOL_F64


@pytest.mark.parametrize("regime", ["lanes", "shared"])
def test_only_the_triangle_is_read(regime):
    """Entries across the diagonal never reach the result: NaN there
    changes nothing, in either layout."""
    rng = np.random.RandomState(13)
    B, n = 4, 40
    bF = 1 if regime == "shared" else B
    model = shared_model if regime == "shared" else lanes_model
    for lower in (False, True):
        F = _factor(rng, bF, n, torch.float64, lower, garbage=False)
        v = torch.tensor(rng.randn(B, n))
        clean = model(F, v, lower)
        across = (torch.ones(n, n, dtype=torch.bool).triu(1) if lower
                  else torch.ones(n, n, dtype=torch.bool).tril(-1))
        dirty = torch.where(across, torch.full_like(F, float("nan")), F)
        assert torch.equal(model(dirty, v, lower), clean)
