"""A CPU model of the one-tile factor-inverse recurrence of
``qpth_tpu_torch/csrc/common.cuh::chol_inv_smem`` (kernel 11 runs it;
kernel A and the fused IPM steps factor on panels, see
``test_torch_kernels_factor_inv_panel.py`` and
``test_torch_kernels_step_panel.py``), held to the plain version
``factor_inv_plain``.

The kernel runs only on the card, where ``chip_smoke.py`` holds it to the
plain version. This model runs the same storage scheme step by step in
plain PyTorch, vectorized over the batch: T's trailing block in the upper
triangle and diagonal of one m x m tile, inv(L)'s rows unscaled in the
strictly lower triangle with an implicit unit diagonal, the pivots' rsqrt
in ``isqv``; the mirror of the lower triangle onto the upper one first,
the scaling pass last. A layout or lazy-scaling mistake in the scheme shows
here on the CPU."""

import numpy as np
import pytest
import torch

from qpth_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

#: float32 tolerance of chip_smoke.py phase 2 (max difference scaled by
#: max(1, max |plain|)).
TOL_F32 = 1e-3


def tile_factor_inv(R, dinv):
    """inv(chol(R + diag(dinv))) by chol_inv_smem's one-tile recurrence."""
    B, m = dinv.shape
    tile = R.expand(B, m, m).clone()
    strict_lower = torch.ones(m, m, dtype=torch.bool).tril(-1)
    zero = torch.zeros((), dtype=R.dtype)
    # Mirror pass: (r, c), c < r, moves to (c, r); the strictly lower part
    # is cleared. Only R's lower triangle and diagonal survive.
    tile = torch.where(strict_lower.T, tile.transpose(-1, -2), tile)
    tile = torch.where(strict_lower, zero, tile)
    isqv = torch.zeros(B, m, dtype=R.dtype)
    cols = torch.arange(m)
    for j in range(m):
        rowj = tile[:, j, :].clone()        # step j reads row j only
        isq = torch.rsqrt(rowj[:, j] + dinv[:, j])
        isqv[:, j] = isq
        src = rowj.clone()
        src[:, j] = 1.0                      # G's implicit unit diagonal
        scaled = src * isq.unsqueeze(-1)     # row j of G, or of T, times isq
        lk = rowj[:, j + 1:] * isq.unsqueeze(-1)     # L[k][j], k > j
        # Row k > j: G's columns [0, j] and T's [k, m); columns (j, k) wait
        # for later pivots.
        ks = torch.arange(j + 1, m).unsqueeze(-1)
        swept = (cols <= j) | (cols >= ks)
        upd = lk.unsqueeze(-1) * scaled.unsqueeze(-2)
        tile[:, j + 1:, :] = torch.where(swept, tile[:, j + 1:, :] - upd,
                                         tile[:, j + 1:, :])
    # Last pass: scale G's rows, write the diagonal, clear T's remnant.
    eye = torch.eye(m, dtype=torch.bool)
    return torch.where(strict_lower, tile * isqv.unsqueeze(-1),
                       torch.where(eye, torch.diag_embed(isqv), zero))


def _gram_R(rng, bR, m, dtype):
    """R = G G^T / m + I from a product, with its two triangles parted by
    one unit in the last place here and there (as R = G Q^-1 G^T from a
    matrix product may be): which triangle is read then shows."""
    G = torch.tensor(rng.rand(bR, m, m) - 0.5)
    R = torch.matmul(G, G.transpose(-1, -2)) / m + torch.eye(m,
                                                             dtype=G.dtype)
    nudge = torch.tensor(rng.randint(-1, 2, size=(bR, m, m)), dtype=G.dtype)
    R = R + R * nudge * torch.finfo(G.dtype).eps
    return R.to(dtype).contiguous()


def _scaled_err(got, want):
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


@pytest.mark.parametrize("m", [1, 37, 100])
@pytest.mark.parametrize("shared", [False, True])
def test_tile_model_matches_plain_f64(m, shared):
    rng = np.random.RandomState(m)
    B = 3
    R = _gram_R(rng, 1 if shared else B, m, torch.float64)
    if m > 1:
        assert not torch.equal(R, R.transpose(-1, -2))
    dinv = torch.tensor(rng.rand(B, m) + 0.5)
    got = tile_factor_inv(R, dinv)
    want = kernels.factor_inv_plain(R, dinv)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-14
    # Lower triangular, with the exact zeros the callers multiply.
    assert not bool(torch.triu(got, 1).any())
    # Only the lower triangle and diagonal of R are read.
    garbage = R + torch.triu(torch.full_like(R, 7.0), 1)
    assert torch.equal(tile_factor_inv(garbage, dinv), got)


def test_tile_model_solves_from_the_lower_triangle():
    """x = G^T (G r) from the model's inv(L) is T^-1 r."""
    rng = np.random.RandomState(5)
    B, m = 4, 37
    R = _gram_R(rng, B, m, torch.float64)
    dinv = torch.tensor(rng.rand(B, m) + 0.5)
    r = torch.tensor(rng.randn(B, m))
    G = tile_factor_inv(R, dinv)
    x = torch.matmul(G.transpose(-1, -2),
                     torch.matmul(G, r.unsqueeze(-1))).squeeze(-1)
    T = torch.tril(R) + torch.tril(R, -1).transpose(-1, -2)
    T = T + torch.diag_embed(dinv)
    np.testing.assert_allclose(
        x.numpy(), torch.linalg.solve(T, r.unsqueeze(-1)).squeeze(-1).numpy(),
        rtol=1e-10, atol=1e-12)


def test_tile_model_non_spd_lane_is_nan_alone():
    rng = np.random.RandomState(7)
    B, m = 6, 37
    R = _gram_R(rng, B, m, torch.float64)
    R[3] = R[3] - 3.0 * torch.eye(m, dtype=torch.float64)
    dinv = torch.tensor(rng.rand(B, m) + 0.5)
    got = tile_factor_inv(R, dinv)
    want = kernels.factor_inv_plain(R, dinv)
    bad = torch.isnan(got).any(dim=(1, 2))
    assert bad.tolist() == [k == 3 for k in range(B)]
    assert torch.equal(bad, torch.isnan(want).any(dim=(1, 2)))
    keep = ~bad
    assert float((got[keep] - want[keep]).abs().max()) <= 1e-14 * float(
        want[keep].abs().max())


@pytest.mark.parametrize("m", [37, 100])
def test_tile_model_matches_plain_f32(m):
    rng = np.random.RandomState(11 + m)
    B = 4
    R = _gram_R(rng, B, m, torch.float32)
    dinv = torch.tensor(rng.rand(B, m) + 0.5, dtype=torch.float32)
    got = tile_factor_inv(R, dinv)
    want = kernels.factor_inv_plain(R, dinv)
    assert bool(torch.isfinite(got).all())
    assert _scaled_err(got, want) <= TOL_F32
