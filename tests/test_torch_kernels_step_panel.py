"""A CPU model of the fused IPM steps' body on kernel C's panels
(``qpth_tpu_torch/csrc/ipm_step_body.cuh`` over ``csrc/panel.cuh``), held to
the plain versions ``ipm_step_xfree_plain``, ``ipm_step_plain`` and
``ipm_step_eq_plain``.

The kernels run only on the card, where ``chip_smoke.py`` holds them to the
plain versions. This model runs the body's order of operations in plain
PyTorch, vectorized over the batch:

* R's lower triangle staged to its mirror places in the tile's upper
  triangle, which the panel routines read (the kernel takes R z from the raw
  R in the same pass over R's rows; here by the plain versions' own
  algebra);
* T = R + diag(s/z) factored on 32-row panels with the shift folded into
  each pivot and the predictor's RHS riding as one more column, then the
  back substitution by panels for dz_a (``chol_model`` of
  ``test_torch_kernels_panel.py``, kernel C's order);
* the corrector and each Gondzio pass as a forward substitution by panels
  (``solve_panels``: each panel's chain in column order, then the rows
  below it take the panel's solution) and a back substitution by panels.

The Mehrotra and Gondzio algebra around the solves is the kernels', step
for step, with a mark at each block barrier; the [EQ] and [X] parts and the
NaN freeze are the plain versions' own (the model stands in for
``kernels._mehrotra_plain``). A layout or ordering mistake in the scheme
shows here on the CPU.
"""

import re
from pathlib import Path

import numpy.testing as npt
import pytest
import torch

from qpth_tpu_torch.ops.cuda import kernels
from test_torch_kernels_panel import P, chol_model

torch.set_num_threads(1)

B = 4
BAD = 2  # the lane whose T is not SPD
MS = [7, 32, 33, 100]
#: float64 against the plain versions, relative to max(1, max |plain|).
TOL_F64 = 1e-10
#: float32: the limit of tests/test_torch_kernels_step.py.
TOL_F32 = 2e-5
CSRC = Path(kernels.__file__).resolve().parents[2] / "csrc"
BODY = CSRC / "ipm_step_body.cuh"


def mirror(R):
    """The tile after the body's mirror pass: R's lower triangle and
    diagonal, and their mirror above the diagonal (the raw upper triangle
    is overwritten, never read)."""
    m = R.shape[-1]
    upper = torch.ones(m, m, dtype=torch.bool).triu(1)
    return torch.where(upper, R.transpose(-1, -2), R)


def fwd_panels(Lt, isqv, r, bar):
    """solve_panels' forward substitution L y = r: per panel, warp 0's
    chain (y_j = r_j isq_j, then the panel's later rows, j ascending), then
    the rows below the panel take its solution, k ascending; a barrier
    between panels."""
    y = r.clone()
    m = y.shape[-1]
    for p0 in range(0, m, P):
        w = min(P, m - p0)
        if p0 > 0:
            bar.append("forward panel")
        for j in range(p0, p0 + w):
            y[:, j] = y[:, j] * isqv[:, j]
            y[:, j + 1:p0 + w] -= Lt[:, j, j + 1:p0 + w] * y[:, j:j + 1]
        for k in range(p0, p0 + w):
            y[:, p0 + w:] -= Lt[:, k, p0 + w:] * y[:, k:k + 1]
    return y


def back_panels(Lt, isqv, y, bar):
    """back_panels: per panel from the last, warp 0's chain (k descending),
    then the rows above take the panel's solution, k ascending; a barrier
    per panel."""
    x = y.clone()
    m = x.shape[-1]
    for p0 in range(((m - 1) // P) * P, -1, -P):
        w = min(P, m - p0)
        r = x[:, p0:p0 + w]
        for k in range(w - 1, -1, -1):
            r[:, k] = r[:, k] * isqv[:, p0 + k]
            r[:, :k] -= Lt[:, p0:p0 + k, p0 + k] * r[:, k:k + 1]
        for k in range(w):
            x[:, :p0] -= Lt[:, :p0, p0 + k] * x[:, p0 + k:p0 + k + 1]
        bar.append("back panel")
    return x


def mehrotra_model(R, s, z, rhs_a, n_correctors, W=None, u=None,
                   barriers=None):
    """The body's predictor, corrector and Gondzio passes, with the
    signature and results of ``kernels._mehrotra_plain``. Each block
    barrier the x-free kernel passes is appended to ``barriers``: the
    vectors' first, the freeze's ``__syncthreads_or`` last."""
    bar = [] if barriers is None else barriers
    m = s.shape[-1]
    d = z / s
    bar.append("vectors")
    isqv = torch.zeros_like(s)
    # The staging pass's barrier is chol_model's "staged"; the predictor's
    # forward substitution rides in the factor, its back substitution
    # follows.
    Lt, dz_a = chol_model(mirror(R), s / z, rhs_a, barriers=bar, isqv=isqv)

    def solve(r):
        return back_panels(Lt, isqv, fwd_panels(Lt, isqv, r, bar), bar)

    def step_min(dz_, ds_):
        bar.extend(["reduce"] * 2)
        return torch.minimum(kernels._step(z, dz_), kernels._step(s, ds_))

    def block_sum(v):
        bar.extend(["reduce"] * 2)
        return v.sum(dim=-1, keepdim=True)

    one = torch.ones((), dtype=s.dtype)
    ds_a = (-z - dz_a) / d
    dy = u - kernels._mv(W, dz_a) if W is not None else None
    alpha = torch.minimum(step_min(dz_a, ds_a), one)
    t2 = block_sum(s * z)
    t1 = block_sum((s + alpha * ds_a) * (z + alpha * dz_a))
    ratio = t1 / t2
    sig = ratio * ratio * ratio
    mu = t2.abs() / m

    rs_c = (-(mu * sig) + ds_a * dz_a) / s
    dz_c = solve(-(rs_c / d))
    ds_c = (-rs_c - dz_c) / d
    dz = dz_a + dz_c
    ds = ds_a + ds_c
    if W is not None:
        dy = dy - kernels._mv(W, dz_c)

    for _ in range(n_correctors):
        a_g = torch.minimum(step_min(dz, ds), one)
        a_t = torch.minimum(1.08 * a_g + 0.08, one)
        v = (s + a_t * ds) * (z + a_t * dz)
        mu_t = sig * mu
        rs_g = (v - torch.minimum(torch.maximum(v, 0.1 * mu_t),
                                  10.0 * mu_t)) / s
        ddz = solve(-(rs_g / d))
        dds = (-rs_g - ddz) / d
        dz_n, ds_n = dz + ddz, ds + dds
        a_n = torch.minimum(step_min(dz_n, ds_n), one)
        acc = a_n > a_g
        dz = torch.where(acc, dz_n, dz)
        ds = torch.where(acc, ds_n, ds)
        if W is not None:
            dy = torch.where(acc, dy - kernels._mv(W, ddz), dy)

    alpha2 = torch.minimum(0.999 * step_min(dz, ds), one)
    bar.append("freeze")
    return dz, ds, dy, alpha2


def _operands(seed, m, shared, dtype, nz=9, neq=3):
    """A fused step's operands. R = C C^T - 2 I with noise above its
    diagonal (R z reads it, the factor must not), so T = R + diag(s/z) is
    SPD for s/z in [3, 4] and not SPD for lane BAD's s/z in [0.5, 1].
    ``shared``: every matrix with batch 1."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * (torch.rand(*shape, generator=g,
                                   dtype=torch.float64) - 0.5)

    b = 1 if shared else B
    C = torch.rand(b, m, m, generator=g, dtype=torch.float64) / m ** 0.5
    R = C @ C.transpose(-1, -2) - 2.0 * torch.eye(m, dtype=torch.float64)
    R = R + torch.triu(rnd(b, m, m, scale=1e-3), 1)
    z = torch.rand(B, m, generator=g, dtype=torch.float64) + 0.5
    ratio = torch.rand(B, m, generator=g, dtype=torch.float64) + 3.0
    ratio[BAD] = 0.5 * ratio[BAD] - 1.0
    t = dict(R=R, iGT=rnd(b, nz, m), S21=rnd(b, m, neq), W=rnd(b, neq, m),
             iS11=rnd(b, neq, neq), S11=rnd(b, neq, neq), iAT=rnd(b, nz, neq),
             x=rnd(B, nz, scale=4.0), s=z * ratio, z=z,
             y=rnd(B, neq, scale=4.0), q=rnd(B, m, scale=4.0),
             ip=rnd(B, nz, scale=4.0), rb=rnd(B, neq, scale=4.0))
    return {k: v.to(dtype).contiguous() for k, v in t.items()}


def _step(mode, t, nc):
    if mode == "xfree":
        return kernels.ipm_step_xfree_plain(t["R"], t["s"], t["z"], t["q"],
                                            nc)
    if mode == "x":
        return kernels.ipm_step_plain(t["R"], t["iGT"], t["x"], t["s"],
                                      t["z"], t["q"], t["ip"], nc)
    return kernels.ipm_step_eq_plain(
        *(t[k] for k in ("R", "iGT", "S21", "W", "iS11", "S11", "iAT", "x",
                         "s", "z", "y", "q", "ip", "rb")), nc)


#: The state each output of a mode starts from (a frozen lane keeps it).
STATE = {"xfree": ("z", "s", "z"), "x": ("x", "s", "z"),
         "eq": ("x", "s", "z", "y")}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("mode", ["xfree", "x", "eq"])
def test_step_model_matches_plain(monkeypatch, mode, m, shared, n_correctors,
                                  dtype):
    """Every mode, the ragged and whole last panels: the model within 1e-10
    (float64) or 2e-5 (float32) of the plain version, scaled by max(1, max
    |plain|), and lane BAD frozen by both, the others stepped."""
    t = _operands(1000 * m + 10 * n_correctors + shared, m, shared, dtype)
    want = _step(mode, t, n_correctors)
    monkeypatch.setattr(kernels, "_mehrotra_plain", mehrotra_model)
    got = _step(mode, t, n_correctors)
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    for g, w, name in zip(got, want, STATE[mode] + ("alpha",)):
        npt.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                            atol=tol * max(1.0, float(w.abs().max())))
        if name != "alpha":
            npt.assert_array_equal(g[BAD].numpy(), t[name][BAD].numpy())
    alpha = got[-1]
    assert float(alpha[BAD]) == 0.0
    assert bool((alpha[torch.arange(B) != BAD] > 0).all())


@pytest.mark.parametrize("m", [33, 100])
def test_noise_above_the_diagonal_is_never_factored(m):
    """The factor reads R's lower triangle alone: noise above the diagonal
    leaves the model's factor, pivots and riding solve bit for bit as they
    were (R z, taken from the raw R as it is staged, does see it)."""
    t = _operands(m, m, False, torch.float64)
    R = t["R"]
    clean = torch.tril(R) + torch.tril(R, -1).transpose(-1, -2)
    noisy = R + torch.triu(torch.randn(B, m, m, dtype=R.dtype,
                                       generator=torch.Generator()
                                       .manual_seed(m)), 1)
    dinv, rhs = t["s"] / t["z"], t["q"]
    outs = []
    for M in (clean, R, noisy):
        isqv = torch.zeros_like(dinv)
        Lt, x = chol_model(mirror(M), dinv, rhs, isqv=isqv)
        outs.append((Lt, x, isqv))
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            npt.assert_array_equal(torch.nan_to_num(a).numpy(),
                                   torch.nan_to_num(b).numpy())
    # Lane BAD's T is not SPD: NaN in its factor alone.
    bad = torch.isnan(outs[0][0]).any(dim=(1, 2))
    assert bad.tolist() == [k == BAD for k in range(B)]


def _step_barriers_of_the_source():
    """ipm_step_body.cuh::step_barriers as a Python function of (m, nc),
    read from the source's return expression."""
    src = BODY.read_text()
    body = re.search(r"constexpr int step_barriers\(int m, int n_correctors\)"
                     r"\s*\{\s*return ([^;]+);", src).group(1)
    expr = body.replace("panels(m)", "((m + 31) // 32)").replace(
        "n_correctors", "nc")
    return lambda m, nc: eval(expr, {}, {"m": m, "nc": nc})


@pytest.mark.parametrize("n_correctors", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 7, 31, 32, 33, 65, 100, 237])
def test_barriers_per_qp(m, n_correctors):
    """The model passes a block barrier wherever the x-free kernel calls
    __syncthreads(); their number is the count that step_barriers gives in
    the source (and qpth_ipm_step_barriers exports)."""
    t = _operands(m, m, False, torch.float64, nz=1, neq=1)
    bars = []
    mehrotra_model(t["R"][:1], t["s"][:1], t["z"][:1], t["q"][:1],
                   n_correctors, barriers=bars)
    assert len(bars) == _step_barriers_of_the_source()(m, n_correctors)


def _source_int(path, name):
    return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                         path.read_text()).group(1))


#: An SM's shared memory on an H100 (228 KB), and what the runtime keeps of
#: it for each resident block.
SM_SMEM, BLOCK_RESERVED = 233_472, 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_launched_tile_follows_the_fit(dtype):
    """The words the launcher asks for (prepare_step: m rows of stride
    m | 1 where that fits beside the 8 words of reduction scratch, else m,
    and the vectors) lie within kernels.SMEM_LIMIT (common.cuh's
    kSmemLimit) wherever kernels.fits admits the step, so the fit predicate,
    which counts the m x m tile, stays the bound. And in float32 the 6-warp
    blocks (step_warps, up to kSixWarpMaxM) fit 5 an SM by shared memory in
    every mode while nz + 4 neq <= 511, one more than 8-warp blocks' 4, and
    no longer 3 rows past it."""
    body = BODY.read_text()
    assert _source_int(CSRC / "common.cuh", "kSmemLimit") == kernels.SMEM_LIMIT
    assert ("step_smem_bytes<T>(SquareTile{m, m | 1}, nz, neq) + "
            "kWarps * sizeof(T) <=") in body
    assert "return sizeof(T) == 4 && m <= kSixWarpMaxM ? 6 : kWarps;" in body
    six = _source_int(BODY, "kSixWarpMaxM")
    elt = dtype.itemsize

    def launched_words(m, nz, neq):
        vecs = kernels.SMEM_VECTORS * m + nz + kernels.SMEM_EQ_VECTORS * neq
        padded = m * (m | 1) + vecs
        fits_padded = (padded + kernels.RED_WORDS) * elt <= kernels.SMEM_LIMIT
        return padded if fits_padded else m * m + vecs

    for m in range(1, 257):
        for nz, neq in ((0, 0), (7, 8), (100, 50), (511, 0), (512, 64)):
            if kernels.fits(m, dtype, nz, neq):
                words = launched_words(m, nz, neq)
                assert (words + kernels.RED_WORDS) * elt <= kernels.SMEM_LIMIT

    def blocks_by_smem(m, nz, neq):
        smem = (launched_words(m, nz, neq) + 6) * elt  # with red[6]
        return SM_SMEM // (smem + BLOCK_RESERVED)

    if dtype == torch.float32:
        for m in range(1, six + 1):
            for nz, neq in ((0, 0), (511, 0), (7, 126)):
                assert blocks_by_smem(m, nz, neq) >= 5
        assert blocks_by_smem(six + 3, 0, 0) == 4
    # The kernel table's shape: 43.6 KB a float32 block, 87.2 KB float64.
    assert launched_words(100, 0, 0) * elt == {4: 43_600, 8: 87_200}[elt]
