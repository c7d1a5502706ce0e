"""A CPU model of kernel A on the 32-row panels
(``qpth_tpu_torch/csrc/factor_inv.cu`` over ``csrc/panel.cuh``), held to
its plain version ``factor_inv_plain`` and, at small m, to the JAX
package's ``factor_inv_lanes``, ``factor_inv_solve_lanes`` and
``factor_inv_solve_rz_lanes`` (interpret mode).

The kernel runs only on the card, where ``chip_smoke.py`` phase 2 and
``tests/test_torch_cuda.py`` hold it to the plain version. This
model runs its order of operations in plain PyTorch, vectorized over the
batch, from the models of kernels C and E (``test_torch_kernels_panel.py``)
and the fused steps' mirror (``test_torch_kernels_step_panel.py``):

* with z, R z from the whole raw R, taken from rhs;
* R's lower triangle mirrored onto the upper one, which the panel routines
  read;
* T = R + diag(dinv) factored on the panels in kernel C's order, the shift
  folded into each pivot, y = L^-1 rhs riding as one more column;
* L inverted in the same tile in kernel E's order, the pivots' rsqrt
  standing for the reciprocals of Lt's diagonal;
* x = L^-T y by back substitution on the panels, in one warp beside the
  inverse in the others (``back_warp``: per panel from the last, its chain,
  then the rows above it, the order of kernel C's ``back_panels``). It
  reads only Lt's strict upper triangle, which the inverse never writes, so
  its result does not depend on where it runs; ``chol_model`` runs it after
  the factor.

Up to ``kernels.factor_inv_tile_max`` the kernel launches the per-pivot
factor-inverse instead, whose model is ``test_torch_kernels_tile.py``.

A layout, masking or ordering mistake in the scheme shows here on the CPU.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from qpth_tpu.ops.pallas.lanes import (factor_inv_lanes,
                                       factor_inv_solve_lanes,
                                       factor_inv_solve_rz_lanes,
                                       pad_spd_lanes)
from qpth_tpu_torch.ops.cuda import kernels
from test_torch_kernels_panel import (P, TOL_F32, TOL_F64, _scaled_err,
                                      chol_model, trinv_model)
from test_torch_kernels_step_panel import mirror

torch.set_num_threads(1)

MS = [1, 8, 31, 32, 33, 40, 64, 100]
VARIANTS = ["inv", "solve", "solve_rz"]
CSRC = Path(kernels.__file__).resolve().parents[2] / "csrc"


def factor_inv_model(R, dinv, rhs=None, z=None, barriers=None):
    """Kernel A's order of operations on the panels: Linv, or (Linv, x)
    with ``rhs``. Each barrier of the kernel is appended to ``barriers`` in
    the kernel's order: the staging's, with z R z's and the mirror's, the
    factor's, the inverse's (of the warps that run it), and with rhs the
    one that joins the back substitution to it (at m <= 224, where warp 0
    runs it beside the inverse)."""
    bar = [] if barriers is None else barriers
    if z is not None:
        rhs = rhs - torch.matmul(R, z.unsqueeze(-1)).squeeze(-1)
    m = dinv.shape[-1]
    fac, inv = [], []
    isqv = torch.zeros_like(dinv)
    out = chol_model(mirror(R), dinv, rhs, barriers=fac, isqv=isqv)
    Lt, x = out if rhs is not None else (out, None)
    Linv = trinv_model(Lt, barriers=inv, rd=isqv)
    panels = -(-m // P)
    n_fac = 3 * panels             # the staging's and the factor's
    bar += fac[:1] + (["R z", "mirror"] if z is not None else [])
    bar += fac[1:n_fac] + inv[1:]
    if rhs is not None and panels < 8:
        bar.append("join")
    return Linv if rhs is None else (Linv, x)


def _args(rng, B, m, variant, shared, dtype, noise=True):
    """R with a random strict upper triangle (only the lower one counts),
    dinv, rhs, z for ``variant``."""
    G = torch.tensor(rng.rand(1 if shared else B, m, m) - 0.5)
    R = torch.matmul(G, G.transpose(-1, -2)) / m + torch.eye(m,
                                                             dtype=G.dtype)
    if noise:
        R = R + torch.triu(torch.tensor(rng.randn(*R.shape)), 1)
    dinv = torch.tensor(rng.rand(B, m) + 0.5)
    rhs = torch.tensor(rng.rand(B, m) - 0.5)
    z = torch.tensor(rng.rand(B, m))
    args = [t.to(dtype) for t in (R, dinv, rhs, z)]
    return tuple(args[:2 + VARIANTS.index(variant)])


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", MS)
def test_model_matches_plain_f64(m, variant, shared):
    """Every variant at the banded (8, 32), path 5a (40), hybrid (64) and
    cell (100) widths and the ragged panels around 32, from an R whose
    upper triangle is noise."""
    args = _args(np.random.RandomState(m), 3, m, variant, shared,
                 torch.float64)
    got = _outs(factor_inv_model(*args))
    want = _outs(kernels.factor_inv_plain(*args))
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _scaled_err(a, b) <= TOL_F64
    assert not torch.triu(got[0], 1).any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [33, 100])
def test_model_matches_plain_f32(m, variant):
    args = _args(np.random.RandomState(50 + m), 4, m, variant, False,
                 torch.float32)
    for a, b in zip(_outs(factor_inv_model(*args)),
                    _outs(kernels.factor_inv_plain(*args))):
        assert bool(torch.isfinite(a).all())
        assert _scaled_err(a, b) <= TOL_F32


@pytest.mark.parametrize("variant", VARIANTS)
def test_upper_triangle_is_never_read(variant):
    """R's strict upper triangle may hold anything: the factor and the
    inverse come from the lower one, to the last bit (R z alone reads the
    whole R, as the plain version's does)."""
    m = 65
    clean = _args(np.random.RandomState(3), 4, m, variant, False,
                  torch.float64, noise=False)
    R = clean[0]
    noisy = (R + torch.triu(torch.full_like(R, 7.0), 1),) + clean[1:]
    got, want = (_outs(factor_inv_model(*a)) for a in (noisy, clean))
    npt.assert_array_equal(got[0].numpy(), want[0].numpy())
    if variant == "solve":
        npt.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [37, 100])
def test_non_spd_lane_is_nan_alone(m, variant):
    """A lane whose T is not SPD comes back NaN, in Linv and x, and the
    other lanes are untouched, as in the plain version."""
    B, bad = 5, 2
    args = list(_args(np.random.RandomState(m), B, m, variant, False,
                      torch.float64))
    args[1][bad] = -3.0 * args[0][bad].diagonal().max()
    got = _outs(factor_inv_model(*args))
    want = _outs(kernels.factor_inv_plain(*args))
    keep = torch.tensor([k != bad for k in range(B)])
    for a, b in zip(got, want):
        assert torch.isnan(a.flatten(1)).any(1).tolist() == (~keep).tolist()
        assert _scaled_err(a[keep], b[keep]) <= TOL_F64
    assert not torch.triu(got[0], 1).nan_to_num(1.0).any()


def _lanes(R):
    return pad_spd_lanes(jnp.asarray(R.transpose(1, 2, 0)))


@pytest.mark.parametrize("m", [8, 13])
def test_model_matches_lanes_kernels(m):
    """The three TPU kernels kernel A replaces (B = 8, float32) in their
    (m_p, m_p, B) layout, at the tolerances of
    tests/test_torch_kernels.py and tests/test_torch_kernels_rz.py."""
    rng = np.random.RandomState(m)
    B = 8
    L0 = rng.rand(B, m, m).astype(np.float32)
    R = L0 @ L0.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    dinv, v, z = (rng.rand(B, m).astype(np.float32) + 0.5 for _ in range(3))
    R_t, d_t, v_t, z_t = (_lanes(R), jnp.asarray(dinv.T), jnp.asarray(v.T),
                          jnp.asarray(z.T))
    T = [torch.tensor(a) for a in (R, dinv, v, z)]

    def unlanes(G):
        return np.asarray(G).transpose(2, 0, 1)[:, :m, :m]

    G = factor_inv_lanes(R_t, d_t, interpret=True)
    npt.assert_allclose(factor_inv_model(*T[:2]).numpy(), unlanes(G),
                        atol=2e-5)
    G, x = factor_inv_solve_lanes(R_t, d_t, v_t, interpret=True)
    Linv, xm = factor_inv_model(*T[:3])
    npt.assert_allclose(Linv.numpy(), unlanes(G), atol=2e-5)
    npt.assert_allclose(xm.numpy(), np.asarray(x).T, atol=2e-4, rtol=1e-3)
    G, x = factor_inv_solve_rz_lanes(R_t, d_t, v_t, z_t, interpret=True)
    Linv, xm = factor_inv_model(*T)
    npt.assert_allclose(Linv.numpy(), unlanes(G), atol=2e-5)
    npt.assert_allclose(xm.numpy(), np.asarray(x).T, atol=2e-3)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [1, 31, 32, 33, 65, 100, 225])
def test_barriers_per_qp(m, variant):
    """The model passes a barrier wherever the kernel calls
    __syncthreads() or the inverse's warps_sync, as many as
    factor_inv.cu::factor_inv_barriers states (and qpth_factor_inv_barriers
    gives chip_smoke.py phase 10): 1 for the staging (3 with z), 3 P - 1 in
    the factor, 2 P - 1 in the inverse, 1 joining the back substitution
    beside it; 19 / 20 / 22 at m = 100, where the factor-inverse with one
    barrier a pivot passed ~103."""
    bars = []
    factor_inv_model(*_args(np.random.RandomState(1), 1, m, variant, False,
                            torch.float64), barriers=bars)
    panels = -(-m // P)
    rhs, rz = variant != "inv", variant == "solve_rz"
    assert len(bars) == (1 + 2 * rz + 5 * panels - 2
                         + (rhs and panels < 8))
    src = (CSRC / "factor_inv.cu").read_text()
    assert re.search(r"return 1 \+ \(rz \? 2 : 0\) \+ 5 \* panels\(m\) - 2 \+\s+"
                     r"\(rhs && panels\(m\) < kWarps \? 1 : 0\);", src)


def _function(src, name):
    """The text of the CUDA function ``name`` in ``src``, comments out."""
    src = re.sub(r"//.*", "", src)
    start = src.index(name + "(")
    end = src.find("\ntemplate <", start)
    return src[start:end if end > 0 else len(src)]


def test_kernel_a_runs_the_panel_routines():
    """Kernel A factors with kernel C's loop and inverts with kernel E's
    (one routine, trinv_panels, in both), and its panel kernel no longer
    runs the one-barrier-per-pivot factor-inverse, which kernel 11 and
    kernel A's small-m kernel alone keep."""
    src = {f: (CSRC / f).read_text()
           for f in ("factor_inv.cu", "trinv.cu", "diag_step.cu")}
    panel = _function(src["factor_inv.cu"], "factor_inv_kernel")
    for call in ("factor_panels<T, true, RHS>(", "trinv_panels(",
                 "back_warp(", "cp_async_elt("):
        assert call in panel
    for call in ("chol_inv_smem(", "apply_inv("):
        assert call not in panel
        assert call in _function(src["factor_inv.cu"],
                                 "factor_inv_tile_kernel")
        assert call in _function(src["diag_step.cu"], "diag_step_kernel")
    assert "trinv_panels(" in _function(src["trinv.cu"], "trinv_kernel")
    assert "__launch_bounds__(kThreads, PanelBlocks<T>::value)" in src[
        "factor_inv.cu"]


def test_model_matches_lanes_kernel_across_panels():
    """Over two panels (m = 33, the second of one row): the trailing
    update, the inverse's second row block and the back substitution
    across panels, held to the TPU kernel factor_inv_solve_rz_lanes
    (B = 2, float32, interpret mode) at the tolerances above."""
    rng = np.random.RandomState(33)
    B, m = 2, 33
    L0 = rng.rand(B, m, m).astype(np.float32)
    R = L0 @ L0.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    dinv, v, z = (rng.rand(B, m).astype(np.float32) + 0.5 for _ in range(3))
    G, x = factor_inv_solve_rz_lanes(_lanes(R), jnp.asarray(dinv.T),
                                     jnp.asarray(v.T), jnp.asarray(z.T),
                                     interpret=True)
    Linv, xm = factor_inv_model(*(torch.tensor(a) for a in (R, dinv, v, z)))
    npt.assert_allclose(Linv.numpy(), np.asarray(G).transpose(2, 0, 1)[:, :m, :m],
                        atol=2e-5)
    npt.assert_allclose(xm.numpy(), np.asarray(x).T, atol=2e-3)
