"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; these tests import only the port.)
"""

import numpy as np
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch.ops.cuda import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _spd(bR, m, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    L = torch.rand(bR, m, m, generator=g, dtype=torch.float64)
    R = L @ L.transpose(1, 2) / m + torch.eye(m, dtype=torch.float64)
    return R.to(dtype=dtype, device=device)


def _vecs(B, m, dtype, device, seed=1, lo=0.5):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(B, m, generator=g, dtype=torch.float64) + lo).to(
        dtype=dtype, device=device) for _ in range(3)]


TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", ["inv", "solve", "solve_rz"])
def test_factor_inv_kernel_matches_plain(cuda, variant, shared, dtype):
    B, m = 64, 37
    R = _spd(1 if shared else B, m, dtype, cuda)
    dinv, rhs, z = _vecs(B, m, dtype, cuda)
    args = {"inv": (R, dinv), "solve": (R, dinv, rhs),
            "solve_rz": (R, dinv, rhs, z)}[variant]
    got = kernels.factor_inv(*args)
    torch.cuda.synchronize()
    want = kernels.factor_inv_plain(*args)
    got, want = ((got,), (want,)) if variant == "inv" else (got, want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", ["inv", "solve", "solve_rz"])
@pytest.mark.parametrize("m", [1, 8, 17, 18, 31, 32, 33, 40, 50, 51, 64,
                               100])
def test_factor_inv_kernel_at_every_width(cuda, m, variant, dtype):
    """Kernel A on both sides of factor_inv_tile_max (the per-pivot kernel
    up to it, the panels past it, ragged last panels around 32), from an R
    whose upper triangle is noise (only the lower one counts), with one
    lane whose T is not SPD: NaN there alone, the other lanes the plain
    version's. The profiler names the kernel that ran, which the counter
    LAUNCHES["factor_inv_tile"] reports."""
    B, bad = 64, 5
    R = _spd(B, m, dtype, cuda, seed=m)
    R = R + torch.triu(_rand(R.shape, dtype, cuda, m + 1), 1)
    dinv, rhs, z = _vecs(B, m, dtype, cuda)
    dinv[bad] = -2.0 * R[bad].diagonal().max()
    args = {"inv": (R, dinv), "solve": (R, dinv, rhs),
            "solve_rz": (R, dinv, rhs, z)}[variant]
    # Built, loaded and launched once before the profile: a first call
    # inside it may build the library with nvcc and load its module there,
    # and the profiler then missed the launch it was to name.
    kernels.factor_inv(*args)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = kernels.factor_inv(*args)
        torch.cuda.synchronize()
    ran = [e.key for e in prof.key_averages() if "factor_inv" in e.key]
    assert len(ran) == 1
    tile = "factor_inv_tile_kernel" in ran[0]
    assert tile == (m <= kernels.factor_inv_tile_max(dtype))
    assert kernels.LAUNCHES["factor_inv_tile"] == int(tile)
    want = kernels.factor_inv_plain(*args)
    got, want = ((got,), (want,)) if variant == "inv" else (got, want)
    keep = torch.arange(B, device=cuda) != bad
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a.flatten(1)).any(1), ~keep)
        assert (a[keep] - b[keep]).abs().max().item() <= TOL[dtype] * 10
    assert not torch.triu(got[0], 1).nan_to_num(1.0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n_correctors", [0, 2])
def test_ipm_step_kernel_matches_plain(cuda, n_correctors, shared, dtype):
    B, m = 64, 37
    R = _spd(1 if shared else B, m, dtype, cuda)
    s, z, q = _vecs(B, m, dtype, cuda)
    got = kernels.ipm_step_xfree(R, s, z, q - 1.0, n_correctors)
    torch.cuda.synchronize()
    want = kernels.ipm_step_xfree_plain(R, s, z, q - 1.0, n_correctors)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10


def _rand(shape, dtype, device, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * (torch.rand(*shape, generator=g, dtype=torch.float64)
                     - 0.5)).to(dtype=dtype, device=device)


def _linv(B, m, dtype, device):
    """Kernel A's Linv; beyond its fit (f64 m > 166) the plain version's,
    which kernel 5 takes up to m = 256."""
    R = _spd(B, m, dtype, device)
    dinv, rhs, _ = _vecs(B, m, dtype, device)
    fac = kernels.factor_inv if kernels.fits(m, dtype) else \
        kernels.factor_inv_plain
    return fac(R, dinv), rhs


def _upper_nan(Linv):
    m = Linv.shape[-1]
    return Linv.masked_fill(torch.ones(m, m, dtype=torch.bool,
                                       device=Linv.device).triu(1),
                            float("nan"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 7, 13, 16, 17, 31, 32, 33, 37, 40, 64,
                               100, 166, 237])
def test_inv_solve_kernel_matches_plain(cuda, m, dtype):
    """Every m up to kernel A's largest fit (237 f32, 166 f64; f64 237
    from the plain factor): odd m takes the scalar path, rows of whole
    16-byte vectors the vector path."""
    B = 64
    Linv, rhs = _linv(B, m, dtype, cuda)
    kernels.reset_launches()
    got = kernels.inv_solve(Linv, rhs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["inv_solve"] == 1
    want = kernels.inv_solve_plain(Linv, rhs)
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [33, 40, 100])
def test_inv_solve_kernel_ragged_batch_nan(cuda, m, dtype):
    """B = 4097 leaves a ragged last block of QPs; the kernel gets NaN above
    the diagonal, which it must not read, and lane 3's NaN stays in lane
    3."""
    B = 4097
    Linv, rhs = _linv(B, m, dtype, cuda)
    Linv[3, m // 2, m // 2] = float("nan")
    got = kernels.inv_solve(_upper_nan(Linv), rhs)
    torch.cuda.synchronize()
    want = kernels.inv_solve_plain(Linv, rhs)
    bad = torch.isnan(got).any(dim=1)
    assert bad.tolist() == [k == 3 for k in range(B)]
    assert torch.equal(bad, torch.isnan(want).any(dim=1))
    assert (got[~bad] - want[~bad]).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [16, 40, 100])
def test_inv_solve_kernel_scalar_path_off_16_bytes(cuda, m, dtype):
    """An rhs one element off a 16-byte boundary takes the scalar path at
    an m whose rows are whole 16-byte vectors; the result is the aligned
    call's to rounding."""
    B = 129
    Linv, rhs = _linv(B, m, dtype, cuda)
    buf = torch.empty(B * m + 1, dtype=dtype, device=cuda)
    rhs_off = buf[1:].view(B, m)
    rhs_off.copy_(rhs)
    assert rhs_off.data_ptr() % 16 != 0
    dirty = _upper_nan(Linv)
    got = kernels.inv_solve(dirty, rhs_off)
    aligned = kernels.inv_solve(dirty, rhs)
    torch.cuda.synchronize()
    want = kernels.inv_solve_plain(Linv, rhs)
    for x in (got, aligned):
        assert (x - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv_solve_kernel_at_its_limit(cuda, dtype):
    """m = 256, the wrapper's limit, solves; m = 257 raises."""
    Linv, rhs = _linv(8, 256, dtype, cuda)
    got = kernels.inv_solve(_upper_nan(Linv), rhs)
    torch.cuda.synchronize()
    want = kernels.inv_solve_plain(Linv, rhs)
    assert (got - want).abs().max().item() <= TOL[dtype]
    Lbig, rbig = _linv(2, 257, dtype, cuda)
    with pytest.raises(ValueError):
        kernels.inv_solve(Lbig, rbig)


def _step_operands(B, m, nz, neq, shared, dtype, device):
    """Operands of the fused steps; ``shared`` names the matrices given
    with batch 1 ("R", "g" for Q^-1 G^T, "eq" for the five equality
    operands)."""
    def b(key):
        return 1 if key in shared else B

    R = _spd(b("R"), m, dtype, device)
    iGT = _rand((b("g"), nz, m), dtype, device, 2, 0.5)
    be = b("eq")
    S21 = _rand((be, m, neq), dtype, device, 3, 0.5)
    W = _rand((be, neq, m), dtype, device, 4, 0.5)
    iS11 = _rand((be, neq, neq), dtype, device, 5, 0.5)
    S11 = _rand((be, neq, neq), dtype, device, 6, 0.5)
    iAT = _rand((be, nz, neq), dtype, device, 7, 0.5)
    s, z, q = _vecs(B, m, dtype, device)
    x, ip = (_rand((B, nz), dtype, device, k) for k in (8, 9))
    y, rb = (_rand((B, neq), dtype, device, k) for k in (10, 11))
    return (R, iGT, S21, W, iS11, S11, iAT), (x, s, z, y, q - 1.0, ip, rb)


SHAPES = [(37, 37, 11), (17, 33, 5), (40, 24, 48)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [(), ("R", "g"), ("R",)],
                         ids=["batched", "shared", "shared_R"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ipm_step_direct_x_kernel_matches_plain(cuda, shape, n_correctors,
                                                shared, dtype):
    m, nz, _ = shape
    (R, iGT, *_), (x, s, z, _, q, ip, _) = _step_operands(
        64, m, nz, 1, shared, dtype, cuda)
    got = kernels.ipm_step(R, iGT, x, s, z, q, ip, n_correctors)
    torch.cuda.synchronize()
    want = kernels.ipm_step_plain(R, iGT, x, s, z, q, ip, n_correctors)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [(), ("R", "g", "eq"), ("eq",), ("R",)],
                         ids=["batched", "shared", "shared_eq", "shared_R"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ipm_step_eq_kernel_matches_plain(cuda, shape, n_correctors, shared,
                                          dtype):
    m, nz, neq = shape
    mats, vecs = _step_operands(64, m, nz, neq, shared, dtype, cuda)
    got = kernels.ipm_step_eq(*mats, *vecs, n_correctors)
    torch.cuda.synchronize()
    want = kernels.ipm_step_eq_plain(*mats, *vecs, n_correctors)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10


# The largest m of the one-tile fit (kernels.fits), and an nz / neq that
# fill what is left of the block's shared memory at it.
TILE_MAX = {torch.float32: (237, 7, 8), torch.float64: (166, 100, 16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", ["inv", "solve", "solve_rz"])
def test_factor_inv_kernel_at_largest_fit(cuda, variant, shared, dtype):
    m = TILE_MAX[dtype][0]
    assert kernels.fits(m, dtype) and not kernels.fits(m + 1, dtype)
    B = 16
    R = _spd(1 if shared else B, m, dtype, cuda)
    dinv, rhs, z = _vecs(B, m, dtype, cuda)
    args = {"inv": (R, dinv), "solve": (R, dinv, rhs),
            "solve_rz": (R, dinv, rhs, z)}[variant]
    got = kernels.factor_inv(*args)
    torch.cuda.synchronize()
    want = kernels.factor_inv_plain(*args)
    got, want = ((got,), (want,)) if variant == "inv" else (got, want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10
    assert not torch.triu(got[0], 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [(), ("R", "g", "eq")],
                         ids=["batched", "shared"])
def test_fused_steps_at_largest_fit(cuda, shared, dtype):
    m, nz, neq = TILE_MAX[dtype]
    assert kernels.fits(m, dtype, nz, neq)
    assert not kernels.fits(m, dtype, nz + 1, neq)
    mats, (x, s, z, y, q, ip, rb) = _step_operands(16, m, nz, neq, shared,
                                                   dtype, cuda)
    for fn, plain, args in (
            (kernels.ipm_step_xfree, kernels.ipm_step_xfree_plain,
             (mats[0], s, z, q, 2)),
            (kernels.ipm_step, kernels.ipm_step_plain,
             (mats[0], mats[1], x, s, z, q, ip, 2)),
            (kernels.ipm_step_eq, kernels.ipm_step_eq_plain,
             (*mats, x, s, z, y, q, ip, rb, 2))):
        got = fn(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, plain(*args)):
            assert bool(torch.isfinite(a).all())
            assert (a - b).abs().max().item() <= TOL[dtype] * 10


def _step_call(mode, mats, vecs, n_correctors):
    """(kernel, plain version, arguments) of one fused step."""
    x, s, z, y, q, ip, rb = vecs
    if mode == "xfree":
        return (kernels.ipm_step_xfree, kernels.ipm_step_xfree_plain,
                (mats[0], s, z, q, n_correctors))
    if mode == "x":
        return (kernels.ipm_step, kernels.ipm_step_plain,
                (mats[0], mats[1], x, s, z, q, ip, n_correctors))
    return (kernels.ipm_step_eq, kernels.ipm_step_eq_plain,
            (*mats, x, s, z, y, q, ip, rb, n_correctors))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [(), ("R", "g", "eq")],
                         ids=["batched", "shared"])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("m", [100, 101, 129])
@pytest.mark.parametrize("mode", ["xfree", "x", "eq"])
def test_fused_steps_either_side_of_the_warp_counts(cuda, mode, m,
                                                    n_correctors, shared,
                                                    dtype):
    """Every mode either side of the float32 steps' 6-warp limit (m = 100,
    and 101 in 8 warps) and past four panels (129): every output within
    the plain version's tolerance."""
    mats, vecs = _step_operands(64, m, m, m // 2, shared, dtype, cuda)
    fn, plain, args = _step_call(mode, mats, vecs, n_correctors)
    got = fn(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, plain(*args)):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= TOL[dtype] * 10


@pytest.mark.parametrize("mode", ["xfree", "x", "eq"])
def test_fused_step_shape(cuda, mode):
    """The blocks each fused step launches (kernels.ipm_step_shape, read
    from its library): at the kernel table's shape (m = nz = 100, neq = 50)
    float32 runs 6 warps, 5 blocks an SM where 8 warps held 4, and float64 8
    warps, 2 blocks; from m = 101 float32 runs 8 warps too."""
    nz = 100 if mode != "xfree" else 0
    neq = 50 if mode == "eq" else 0
    assert kernels.ipm_step_shape(100, torch.float32, mode, nz, neq) == (6, 5)
    assert kernels.ipm_step_shape(100, torch.float64, mode, nz, neq) == (8, 2)
    for dtype in (torch.float32, torch.float64):
        for m in (8, 33, 64, 101, 129, 160):
            warps, blocks = kernels.ipm_step_shape(m, dtype, mode, nz, neq)
            assert warps == (6 if dtype == torch.float32 and m <= 100 else 8)
            assert blocks >= 1


@pytest.mark.parametrize("eq", [False, True])
def test_fused_step_freezes_non_spd_lane(cuda, eq):
    """A lane whose T is not SPD comes back unchanged with alpha = 0, from
    the kernel as from the plain version; the other lanes move."""
    B, m, nz, neq = 16, 20, 24, 6
    mats, vecs = _step_operands(B, m, nz, neq, (), torch.float64, cuda)
    R = (mats[0] - 2.0 * torch.eye(m, dtype=torch.float64, device=cuda))
    x, s, z, y, q, ip, rb = vecs
    s = z * (3.0 + s)          # T = R - 2 I + diag(s/z) is SPD ...
    s[5] = 0.1 * z[5]          # ... but not in lane 5
    if eq:
        args = (R.contiguous(), *mats[1:], x, s, z, y, q, ip, rb, 1)
        got = kernels.ipm_step_eq(*args)
        want = kernels.ipm_step_eq_plain(*args)
    else:
        args = (R.contiguous(), mats[1], x, s, z, q, ip, 1)
        got = kernels.ipm_step(*args)
        want = kernels.ipm_step_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= 1e-9
    assert got[-1][5].item() == 0.0 and (got[-1] > 0).sum().item() == B - 1
    assert torch.equal(got[0][5], x[5])


@pytest.mark.parametrize("case", ["eq_inverse", "eq_f64_default",
                                  "direct_x", "f64_default"])
def test_slice2_solve_on_card_matches_cpu(cuda, case):
    """The paths of the equality-constrained, direct-x and float64-default
    branches: the card (kernels) against the CPU (plain versions). Where
    every iterate is scored, eps = 1e-9 (refinement off) ends the solve on
    the eps test; at the default eps = 1e-12 the window closes on float64
    rounding noise and the iteration count is not comparable."""
    r = np.random.RandomState(1)
    B, nz, nineq, neq = 16, 20, 18, 7
    L = r.rand(B, nz, nz)
    Q = L @ L.transpose(0, 2, 1) + np.eye(nz)
    G = r.randn(B, nineq, nz)
    z0 = r.randn(B, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + r.rand(B, nineq)
    p = r.randn(B, nz)
    A = r.randn(B, neq, nz)
    b = np.einsum("bmn,bn->bm", A, z0)
    cfg, eq, key = {
        "eq_inverse": (qt.SolverConfig(solve_method="inverse",
                                       resid_every=7), True, "ipm_step_eq"),
        "eq_f64_default": (qt.SolverConfig(eps=1e-9, refine_steps=0), True,
                           "inv_solve"),
        "direct_x": (qt.SolverConfig(solve_method="inverse", resid_every=1,
                                     eps=1e-9, refine_steps=0),
                     False, "ipm_step"),
        "f64_default": (qt.SolverConfig(eps=1e-9, refine_steps=0), False,
                        "inv_solve"),
    }[case]
    args = [torch.tensor(v) for v in ((Q, p, G, h, A, b) if eq
                                      else (Q, p, G, h))]
    kernels.reset_launches()
    on_card = qt.solve_qp_full(*args, config=cfg)
    assert kernels.LAUNCHES[key] > 0
    on_cpu = qt.solve_qp_full(*args, config=cfg, device="cpu")
    assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    for name in ("z", "lam", "s") + (("nu",) if eq else ()):
        assert (getattr(on_card, name).cpu()
                - getattr(on_cpu, name)).abs().max().item() < 1e-8


def test_solve_on_card_matches_cpu(cuda):
    r = np.random.RandomState(0)
    L = r.rand(16, 20, 20)
    Q = L @ L.transpose(0, 2, 1) + np.eye(20)
    G = r.randn(16, 18, 20)
    h = G @ r.randn(16, 20)[..., None]
    h = h[..., 0] + r.rand(16, 18)
    p = r.randn(16, 20)
    cfg = qt.SolverConfig(solve_method="inverse", resid_every=7)
    args = [torch.tensor(v) for v in (Q, p, G, h)]
    kernels.reset_launches()
    on_card = qt.solve_qp_full(*args, config=cfg)
    assert kernels.LAUNCHES["ipm_step_xfree"] > 0
    on_cpu = qt.solve_qp_full(*args, config=cfg, device="cpu")
    assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < 1e-8


def _diag_step_operands(B, n, neq, g_batched, dtype, device, nan_lane=None):
    """One interior iterate of a diagonal-tier QP and M = A diag(1/H) A^T
    from it; ``nan_lane`` gets a non-SPD M."""
    g_ = torch.Generator().manual_seed(n * 1000 + neq)

    def r(*shape):
        return torch.rand(*shape, generator=g_, dtype=torch.float64)

    A = r(1, neq, n) - 0.5
    g = -(0.5 + r(B if g_batched else 1, n))
    s, z = 0.5 + r(B, n), 0.5 + r(B, n)
    H = 0.5 + r(B, n) + g * g * z / s
    M = torch.matmul(A * (1.0 / H).unsqueeze(-2), A.transpose(-1, -2))
    if nan_lane is not None:
        M[nan_lane] = -M[nan_lane]
    vecs = [r(B, n) - 0.5, r(B, n) - 0.5, r(B, neq) - 0.5, r(B, n) - 0.5,
            s, z, r(B, neq) - 0.5]                # rx, rz, ry, x, s, z, y
    return [t.to(dtype=dtype, device=device).contiguous()
            for t in [M, A, g, H] + vecs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g_batched", [False, True])
@pytest.mark.parametrize("n_correctors", [0, 2])
@pytest.mark.parametrize("shape", [(64, 40), (300, 20), (1, 1)], ids=str)
def test_diag_step_kernel_matches_plain(cuda, shape, n_correctors,
                                        g_batched, dtype):
    """Kernel 11 at the sudoku shape, at n = 300 (more than the block's
    threads) and at n = neq = 1; lane 5 has a non-SPD M and must come back
    unchanged from both."""
    n, neq = shape
    args = _diag_step_operands(16, n, neq, g_batched, dtype, cuda,
                               nan_lane=5)
    kernels.reset_launches()
    got = kernels.diag_step(*args, n_correctors)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["diag_step"] == 1
    want = kernels.diag_step_plain(*args, n_correctors)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= TOL[dtype] * 10 * scale
    for a, v in zip(got, (args[7], args[8], args[9], args[10])):
        assert torch.equal(a[5], v[5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_m_factor_and_solve_kernels_at_neq_40(cuda, dtype):
    """Kernels A (dinv = 0) and inv_solve on the sudoku layer's M."""
    M = _diag_step_operands(64, 64, 40, False, dtype, cuda)[0]
    zero = torch.zeros(64, 40, dtype=dtype, device=cuda)
    rhs = _vecs(64, 40, dtype, cuda)[0]
    Linv = kernels.factor_inv(M, zero)
    torch.cuda.synchronize()
    want = kernels.factor_inv_plain(M, zero)
    scale = want.abs().max().item()
    assert (Linv - want).abs().max().item() <= TOL[dtype] * 10 * scale
    x = kernels.inv_solve(Linv, rhs)
    xw = kernels.inv_solve_plain(Linv, rhs)
    assert (x - xw).abs().max().item() <= TOL[dtype] * xw.abs().max().item()


@pytest.mark.parametrize("fused", [False, True])
def test_diag_solve_on_card_matches_cpu(cuda, fused):
    """The diagonal tier in float64, composed and fused steps: the card
    against the CPU, forward and the gradient to the shared A."""
    r = np.random.RandomState(2)
    n, neq, B = 64, 40, 16
    A = r.rand(neq, n)
    x0 = r.rand(B, n) + 0.1
    data = (np.full(n, 0.1), -(r.rand(B, n) < 0.25).astype(float),
            np.full(n, -1.0), np.zeros(n), A, x0 @ A.T)
    cfg = qt.SolverConfig(eps=1e-9, fused_diag_step=fused)
    out = {}
    for device in ("cuda", "cpu"):
        args = [torch.tensor(v, device=device) for v in data]
        args[4].requires_grad_(True)
        kernels.reset_launches()
        sol = qt.solve_qp_diag_full(*args, config=cfg, device=device)
        z = qt.solve_qp_diag(*args, config=cfg, device=device)
        (z * z).sum().backward()
        out[device] = (sol, args[4].grad.cpu(), dict(kernels.LAUNCHES))
    (sc, gc, lc), (sh, gh, _) = out["cuda"], out["cpu"]
    assert int(sc.stats.iterations) == int(sh.stats.iterations)
    for name in ("z", "nu", "lam", "s"):
        assert (getattr(sc, name).cpu() - getattr(sh, name)).abs().max() < 1e-8
    assert (gc - gh).abs().max().item() <= 1e-7 * gh.abs().max().item()
    assert lc["diag_step" if fused else "inv_solve"] > 0


# Kernels C, D, E (the Cholesky-factor backend, use_pallas="blocked").
CHOL_MAX = {torch.float32: 239, torch.float64: 168}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", ["plain_factor", "shift", "shift_rhs",
                                     "rhs"])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 37, 65, 100, "max"])
def test_chol_kernel_matches_plain(cuda, m, variant, shared, dtype):
    m = CHOL_MAX[dtype] if m == "max" else m
    assert kernels.chol_fits(m, dtype)
    B = 16
    R = _spd(1 if shared else B, m, dtype, cuda).contiguous()
    dinv, rhs, _ = _vecs(B, m, dtype, cuda)
    args = {"plain_factor": (R,), "shift": (R, dinv),
            "shift_rhs": (R, dinv, rhs), "rhs": (R, None, rhs)}[variant]
    if variant == "plain_factor" and shared:
        args = (R.expand(B, m, m).contiguous(),)
    kernels.reset_launches()
    got = kernels.chol(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol_solve" if len(args) == 3 else "chol"] == 1
    want = kernels.chol_plain(*args)
    got, want = ((got,), (want,)) if len(args) < 3 else (got, want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[dtype] * 10
    assert not torch.tril(got[0], -1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_kernel_non_spd_lane_is_nan_alone(cuda, dtype):
    B, m = 8, 37
    R = _spd(B, m, dtype, cuda).contiguous()
    R[5] = -R[5]
    dinv, rhs, _ = _vecs(B, m, dtype, cuda)
    Lt, x = kernels.chol(R, dinv * 0.1, rhs)
    bad = torch.isnan(Lt).any(dim=(1, 2)).cpu()
    assert bad.tolist() == [k == 5 for k in range(B)]
    assert torch.isnan(x).any(dim=1).cpu().tolist() == bad.tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("n", [1, 37, 100, "max"])
@pytest.mark.parametrize("B", [1, 16, 64, 4097])
def test_cho_solve_kernel_matches_plain(cuda, B, n, lower, shared, dtype):
    """Both regimes (a factor per lane, one shared factor) and layouts, at
    ragged n and B: the shared regime's right-hand-side tiles are 32 wide,
    the per-lane regime runs 4 QPs per block. Entries across the diagonal
    hold noise, which the kernel must not read."""
    n = CHOL_MAX[dtype] if n == "max" else n
    Lt = kernels.chol(_spd(1 if shared else B, n, dtype, cuda).contiguous())
    F = Lt.transpose(1, 2).contiguous() if lower else Lt
    if n > 1:
        noise = torch.randn_like(F)
        F = F + (torch.triu(noise, 1) if lower else torch.tril(noise, -1))
    g = torch.Generator().manual_seed(3)
    v = (torch.rand(B, n, generator=g, dtype=torch.float64) - 0.5).to(
        dtype=dtype, device=cuda)
    kernels.reset_launches()
    got = kernels.cho_solve(F, v, lower=lower)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cho_solve"] == 1
    assert kernels.LAUNCHES["cho_solve_shared"] == int(shared or B == 1)
    want = kernels.cho_solve_plain(F, v, lower=lower)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= TOL[dtype] * 10
    else:  # 1e-12 relative to the solution, |x| <= |v| here
        assert err <= 1e-12 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lower", [False, True])
def test_cho_solve_kernel_nan_lane_is_nan_alone(cuda, lower, dtype):
    """A NaN in one lane's factor (per-lane regime) or right-hand side
    (shared regime) stays in that lane."""
    B, n = 70, 37
    Lt = kernels.chol(_spd(B, n, dtype, cuda).contiguous())
    F = Lt.transpose(1, 2).contiguous() if lower else Lt
    F[5, 9, 9] = float("nan")
    v = _vecs(B, n, dtype, cuda)[0] - 1.0
    bad = torch.isnan(kernels.cho_solve(F, v, lower=lower)).any(dim=1)
    assert bad.cpu().tolist() == [k == 5 for k in range(B)]
    v[5, 0] = float("nan")
    bad = torch.isnan(kernels.cho_solve(F[:1].contiguous(), v,
                                        lower=lower)).any(dim=1)
    assert bad.cpu().tolist() == [k == 5 for k in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 37, 65, 100, "mid", "max"])
def test_trinv_kernel_matches_plain(cuda, n, dtype):
    """Ragged panels, and n up to the largest fit of kernel C, which kernel
    E now shares (float32 200 and 239, float64 150 and 168: beyond a
    two-tile working set)."""
    n = {"mid": {torch.float32: 200, torch.float64: 150}[dtype],
         "max": CHOL_MAX[dtype]}.get(n, n)
    B = 16
    Lt = kernels.chol(_spd(B, n, dtype, cuda).contiguous())
    kernels.reset_launches()
    got = kernels.trinv(Lt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trinv"] == 1
    assert (got - kernels.trinv_plain(Lt)).abs().max().item() <= TOL[dtype]
    assert not torch.triu(got, 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ["mid", "max"])
def test_spd_inverse_at_the_largest_fit(cuda, n, dtype):
    """ops/cholesky.py::spd_inverse (kernels C and E, the Gram product) at
    float32 n = 200, 239 and float64 n = 150, 168."""
    from qpth_tpu_torch.ops import cholesky as chol_ops
    n = {"mid": {torch.float32: 200, torch.float64: 150}[dtype],
         "max": CHOL_MAX[dtype]}[n]
    A = _spd(8, n, dtype, cuda).contiguous()
    kernels.reset_launches()
    got = chol_ops.spd_inverse(A)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol"] == 1 and kernels.LAUNCHES["trinv"] == 1
    Lp = kernels.trinv_plain(kernels.chol_plain(A))
    want = torch.matmul(Lp.transpose(-1, -2), Lp)
    assert (got - want).abs().max().item() <= TOL[dtype] * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("case", ["f32_inverse", "f64_subst_eq",
                                  "f64_subst_shared"])
def test_blocked_solve_on_card_matches_cpu(cuda, case):
    """use_pallas="blocked" end to end: the card (kernels C and D) against
    the CPU (their plain versions), with its launches counted."""
    r = np.random.RandomState(2)
    B, nz, nineq, neq = 16, 20, 18, 7
    L = r.rand(B, nz, nz)
    Q = L @ L.transpose(0, 2, 1) + np.eye(nz)
    G = r.randn(B, nineq, nz)
    z0 = r.randn(B, nz)
    h = np.einsum("bmn,bn->bm", G, z0) + r.rand(B, nineq)
    p = r.randn(B, nz)
    A = r.randn(B, neq, nz)
    b = np.einsum("bmn,bn->bm", A, z0)
    if case == "f64_subst_shared":
        data = (Q[0], p, G[0], np.einsum("mn,bn->bm", G[0], z0) + 0.5)
    else:
        data = (Q, p, G, h, A, b) if case == "f64_subst_eq" else (Q, p, G, h)
    dtype = torch.float32 if case == "f32_inverse" else torch.float64
    cfg = qt.SolverConfig(use_pallas="blocked", eps=1e-9, refine_steps=0)
    args = [torch.tensor(v, dtype=dtype) for v in data]
    kernels.reset_launches()
    on_card = qt.solve_qp_full(*args, config=cfg)
    n = dict(kernels.LAUNCHES)
    assert n["chol_solve"] > 0 and n["cho_solve"] > 0
    assert n["ipm_step_xfree"] == n["ipm_step"] == n["inv_solve"] == 0
    on_cpu = qt.solve_qp_full(*args, config=cfg, device="cpu")
    tol = 1e-4 if dtype == torch.float32 else 1e-8
    if dtype == torch.float64:
        assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < tol


def _refine_dinv(B, m, dtype, device, seed=3):
    """1/d for refinement's clamped d = max(z, c) / max(s, c), c = 1e-10:
    active rows (s -> 0) give d ~ 1e10, inactive ones (z -> 0) d ~ 1e-10,
    so T's diagonal holds 1/d from ~1e-10 to ~1e10."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(B, m, generator=g, dtype=torch.float64)
    active = torch.rand(B, m, generator=g) < 0.5
    tiny, big = 10.0 ** (-16.0 + 6.0 * u), 0.5 + u
    s = torch.where(active, tiny, big)
    z = torch.where(active, big, tiny)
    d = z.clamp(min=1e-10) / s.clamp(min=1e-10)
    return (1.0 / d).to(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kernel", ["factor_inv", "chol"])
def test_factor_solve_on_refinement_diagonal(cuda, kernel, shared, dtype):
    """Refinement's one solve per step: kernel A with rhs ("auto") and
    kernel C with rhs ("blocked") on T = R + diag(1/d) with the clamped d,
    against their plain versions (relative to each output's largest
    entry)."""
    B, m = 256, 100
    R = _spd(1 if shared else B, m, dtype, cuda, seed=4)
    dinv = _refine_dinv(B, m, dtype, cuda)
    rhs = _vecs(B, m, dtype, cuda, seed=5)[0] - 1.0
    fn, plain = {"factor_inv": (kernels.factor_inv, kernels.factor_inv_plain),
                 "chol": (kernels.chol, kernels.chol_plain)}[kernel]
    got = fn(R, dinv, rhs)
    torch.cuda.synchronize()
    want = plain(R, dinv, rhs)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= TOL[dtype] * 10 * scale


def _refine_data(B=16, nz=20, nineq=18, seed=3):
    r = np.random.RandomState(seed)
    L = r.rand(B, nz, nz)
    Q = L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(nz)
    G = r.randn(B, nineq, nz)
    h = np.einsum("bmn,bn->bm", G, r.randn(B, nz)) + r.rand(B, nineq)
    return Q, r.randn(B, nz), G, h


@pytest.mark.parametrize("backend", ["auto", "blocked"])
def test_refined_solve_on_card(cuda, backend):
    """The eps dial on the card: float32 at eps = 1e-8 refines through
    kernel A (or C) with rhs, one launch per step, to float64 outputs
    within 1e-8 of the card's float64 solve of the float32-rounded data on
    the median lane; float64 at eps = 1e-9 matches the CPU to 1e-8 with
    equal iterations."""
    data = _refine_data()
    a32 = [torch.tensor(v, dtype=torch.float32) for v in data]
    cfg = qt.SolverConfig(eps=1e-8, use_pallas=backend, check_Q_spd=False)
    kernels.reset_launches()
    sol = qt.solve_qp_full(*a32, config=cfg)
    key = "factor_inv_solve" if backend == "auto" else "chol_solve"
    assert kernels.LAUNCHES[key] > 0 and sol.z.dtype == torch.float64
    y = qt.solve_qp_full(*(a.double() for a in a32),
                         config=qt.SolverConfig(eps=1e-9, check_Q_spd=False))
    err = (sol.z - y.z).norm(dim=1) / y.z.norm(dim=1)
    assert err.median().item() <= 1e-8
    a64 = [torch.tensor(v) for v in data]
    cfg64 = qt.SolverConfig(eps=1e-9, use_pallas=backend, check_Q_spd=False)
    on_card = qt.solve_qp_full(*a64, config=cfg64)
    on_cpu = qt.solve_qp_full(*a64, config=cfg64, device="cpu")
    assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < 1e-8


def test_escalation_and_oracle_on_card(cuda):
    """Escalation from CUDA tensors: the flagged lanes are those above
    escalate_tol, the others bit-identical to the solve without it, and the
    results stay on the card; ``QPSolvers.CPU_ORACLE`` returns on the card
    and its backward launches kernel A. ``CPU_ORACLE`` runs the native
    oracle, as the JAX package's does: on the planted cond ~1e8 lane (2) it
    reports a numerical failure and NaN-fills that lane, as the JAX
    package's does on the same data (the numpy copy returned a best-effort
    iterate there), so the other lanes' results and gradients are held
    finite and lane 2 is held NaN."""
    Q, p, G, h = _refine_data(B=8)
    n = Q.shape[-1]
    U, _ = np.linalg.qr(np.random.RandomState(7).randn(n, n))
    Q[2] = (U * np.logspace(0, -8, n)) @ U.T + 1e-9 * np.eye(n)
    a32 = [torch.tensor(v, dtype=torch.float32) for v in (Q, p, G, h)]
    cfg = qt.SolverConfig(eps=1e-8, refine_steps=12, check_Q_spd=False,
                          verbose=-1)
    base = qt.solve_qp_full(*a32, config=cfg)
    import dataclasses
    sol = qt.solve_qp_full(*a32, config=dataclasses.replace(
        cfg, escalate="oracle"))
    esc = sol.stats.escalated
    assert esc.device.type == "cuda" and sol.lo.z.device.type == "cuda"
    assert torch.equal(esc, base.stats.best_resids > 1e-4)
    assert torch.equal(sol.z[~esc], base.z[~esc])
    a64 = [torch.tensor(v) for v in (Q, p, G, h)]
    cfg_o = qt.SolverConfig(solver=qt.QPSolvers.CPU_ORACLE, check_Q_spd=False)
    args = [t.cuda().requires_grad_(True) for t in a64]
    kernels.reset_launches()
    z = qt.solve_qp(*args, config=cfg_o)
    assert z.device.type == "cuda" and kernels.LAUNCHES["factor_inv"] == 0
    ok = torch.arange(z.shape[0], device=z.device) != 2
    assert bool(torch.isfinite(z[ok]).all()) and bool(z[2].isnan().all())
    (z * z).sum().backward()
    assert kernels.LAUNCHES["factor_inv_solve"] == 1
    assert all(bool(torch.isfinite(a.grad[ok]).all()) for a in args)


@pytest.mark.parametrize("solver", ["FULL", "IR"])
def test_kkt_variants_on_card_match_cpu(cuda, solver):
    """KKTSolver.FULL / IR from CUDA tensors (LU of the saddle system on the
    card) against the CPU, float64, to 1e-8."""
    Q, p, G, h = _refine_data(B=8)
    Q = Q + np.eye(Q.shape[-1])
    a64 = [torch.tensor(v) for v in (Q, p, G, h)]
    cfg = qt.SolverConfig(kkt_solver=qt.KKTSolver[solver], eps=1e-9,
                          refine_steps=0, check_Q_spd=False)
    on_card = qt.solve_qp_full(*a64, config=cfg)
    on_cpu = qt.solve_qp_full(*a64, config=cfg, device="cpu")
    assert on_card.z.device.type == "cuda"
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < 1e-8


@pytest.mark.parametrize("dtype,m", [(torch.float32, 238),
                                     (torch.float32, 300),
                                     (torch.float64, 167)])
def test_hybrid_functions_on_card_match_cpu(cuda, dtype, m):
    """ops/hybrid.py past kernel A's fit: kernel A on the diagonal blocks
    on the card against the same functions on the CPU (its plain
    version)."""
    from qpth_tpu_torch.ops import hybrid

    T = _spd(8, m, dtype, cuda, seed=5)
    v, _, dinv = _vecs(8, m, dtype, cuda, seed=6)
    kernels.reset_launches()
    fac, x = hybrid.factor_solve_hybrid(T, v, dinv=dinv)
    inv = hybrid.spd_inv_hybrid(T)
    torch.cuda.synchronize()
    blk = hybrid.BLOCK
    assert kernels.LAUNCHES["factor_inv"] == 2 * -(-m // blk)
    fac_c, x_c = hybrid.factor_solve_hybrid(T.cpu(), v.cpu(),
                                            dinv=dinv.cpu())
    assert (x.cpu() - x_c).abs().max().item() <= TOL[dtype] * 10
    assert ((inv.cpu() - hybrid.spd_inv_hybrid(T.cpu())).abs().max().item()
            <= TOL[dtype] * 10)
    for a, b in zip(fac.Gs, fac_c.Gs):
        assert (a.cpu() - b).abs().max().item() <= TOL[dtype] * 10


def test_auto_past_the_fit_on_card_matches_cpu(cuda):
    """"auto" past kernel A's fit (float64 nz = nineq = 170, 4 equality
    rows): the hybrid backend and Q's blocked factor on the card, kernel
    A's plain version within no fit on the CPU; z and the iterations."""
    r = np.random.RandomState(4)
    B, n, neq = 4, 170, 4
    L = r.rand(B, n, n)
    Q = L @ L.transpose(0, 2, 1) + 0.05 * n * np.eye(n)
    G = r.randn(B, n, n) / np.sqrt(n)
    z0 = r.randn(n)
    h = G @ z0 + r.rand(B, n)
    A = r.randn(B, neq, n) / np.sqrt(n)
    args = [torch.tensor(v) for v in (Q, r.randn(B, n), G, h, A, A @ z0)]
    cfg = qt.SolverConfig(eps=1e-9, refine_steps=0, solve_method="inverse",
                          check_Q_spd=False)
    kernels.reset_launches()
    on_card = qt.solve_qp_full(*args, config=cfg)
    assert kernels.LAUNCHES["factor_inv"] > 0
    assert kernels.LAUNCHES["ipm_step_eq"] == 0
    on_cpu = qt.solve_qp_full(*args, config=cfg, device="cpu")
    assert int(on_card.stats.iterations) == int(on_cpu.stats.iterations)
    assert (on_card.z.cpu() - on_cpu.z).abs().max().item() < 1e-8


# The banded and general tiers: kernel A on every block-Thomas stage.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [2, 3, 8, 16, 32])
def test_factor_inv_kernel_at_the_stage_widths(cuda, m, dtype):
    """Kernel A without the shift at the banded tier's stage widths (MPC's
    bs = 3, the benchmarks' 16 and 32, the planners' 2 and 8)."""
    B = 257
    R = _spd(B, m, dtype, cuda, seed=m)
    zero = torch.zeros(B, m, dtype=dtype, device=cuda)
    got = kernels.factor_inv(R, zero)
    torch.cuda.synchronize()
    want = kernels.factor_inv_plain(R, zero)
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("neq", [0, 3])
def test_banded_solve_on_card_matches_cpu(cuda, neq):
    """A float64 banded solve with box rows (``g_cols``): the card against
    the CPU, forward with equal iterations and the gradients to all seven
    inputs; kernel A (and, with equality rows, kernel 5) launched."""
    r = np.random.RandomState(5)
    B, nb, bs = 8, 5, 4
    n = nb * bs
    Ld = np.tril(r.randn(B, nb, bs, bs) * 0.4) + np.eye(bs) * 1.8
    Le = 0.35 * r.randn(B, nb - 1, bs, bs)
    Qd = np.einsum("bnij,bnkj->bnik", Ld, Ld)
    Qd[:, 1:] += np.einsum("bnij,bnkj->bnik", Le, Le)
    Qe = np.einsum("bnij,bnkj->bnik", Le, Ld[:, :-1])
    z0 = 0.3 * r.randn(B, n)
    g = np.concatenate([np.ones((B, n)), -np.ones((B, n))], axis=1)
    # Box rows x <= z0 + 0.5 + r, -x <= -z0 + 0.5 + r: z0 lies inside.
    h = np.concatenate([z0, -z0], axis=1) + 0.5 + r.rand(B, 2 * n)
    data = [Qd, Qe, r.randn(B, n), g, h]
    if neq:
        A = r.randn(neq, n) / np.sqrt(n)
        data += [A, z0 @ A.T]
    g_cols = list(range(n)) * 2
    cfg = qt.SolverConfig(eps=1e-9, check_Q_spd=False)
    out = {}
    for device in ("cuda", "cpu"):
        args = [torch.tensor(v, device=device, requires_grad=True)
                for v in data]
        kernels.reset_launches()
        sol = qt.solve_qp_banded_full(*args, config=cfg, g_cols=g_cols,
                                      device=device)
        z = qt.solve_qp_banded(*args, config=cfg, g_cols=g_cols,
                               device=device)
        (z * z).sum().backward()
        out[device] = (sol, [a.grad.cpu() for a in args],
                       dict(kernels.LAUNCHES))
    (sc, gc, lc), (sh, gh, lh) = out["cuda"], out["cpu"]
    assert int(sc.stats.iterations) == int(sh.stats.iterations)
    for name in ("z", "nu", "lam", "s"):
        d = getattr(sc, name).cpu() - getattr(sh, name)
        assert d.numel() == 0 or d.abs().max() < 1e-8, name
    for a, b in zip(gc, gh):
        assert (a - b).abs().max().item() <= 1e-7 * max(b.abs().max().item(),
                                                        1.0)
    assert lc["factor_inv"] > 0 and (lc["inv_solve"] > 0) == (neq > 0)
    assert all(v == 0 for v in lh.values())
