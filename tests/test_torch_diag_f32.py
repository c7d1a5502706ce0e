"""Where float32 ends on the sudoku layer's diagonal tier, the port
against the JAX package.

The on-card run (chip_smoke.py, path 5) drives the tier at B = 4096 on the
draws of ``chip_smoke.make_sudoku`` (seed 0). These tests pin, on lanes of
that draw, the two float32 limits it reports, so that they rest on the
reference and not on the card alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

torch.set_num_threads(1)

NX, NEQ, B_CARD = 64, 40, 4096


def _sudoku_lanes(lanes, seed=0):
    """Lanes of make_sudoku(4096, 64, 40, seed)'s draw in the diagonal
    tier's form, A given per lane so that each lane's gradient is its own."""
    rng = np.random.RandomState(seed)
    A = rng.rand(NEQ, NX)
    p = -(rng.rand(B_CARD, NX) < 0.25).astype(np.float64)[lanes]
    return (np.full(NX, 0.1), p, np.full(NX, -1.0), np.zeros(NX),
            np.broadcast_to(A, (len(lanes), NEQ, NX)).copy(),
            A @ np.full(NX, 2.0 / NX))


def test_sudoku_f32_default_grad_clamp_limit_is_the_references_diag():
    """At the default ``grad_clamp=1e-8`` the backward's d = lam / s reaches
    1e8 on the bounds that are active, and on a lane with more than
    nx - neq = 24 of them M = A diag(1/H) A^T has a condition number near
    1e9, beyond float32 (1 / eps = 1.7e7). Lane 2773 of the seed-0 draw is
    such a lane. There the gradient to A is NaN in the port and in the JAX
    package's XLA path; its Pallas path (interpret mode) returns a finite
    one that is off from float64 by more than its own size. The other
    lanes are finite and close to float64 on all three, and
    ``grad_clamp=1e-5`` (the on-card run's gate) clears the port's NaN."""
    lanes = [2773, 0, 1, 2]
    data = _sudoku_lanes(lanes)

    def grad_jax(dtype, use_pallas):
        cfg = qpth_tpu.SolverConfig(use_pallas=use_pallas, verbose=-1)
        args = [jnp.asarray(v, dtype) for v in data]

        def loss(A_):
            z = qpth_tpu.solve_qp_diag(*args[:4], A_, args[5], config=cfg)
            return jnp.sum(z * z)

        g = jax.grad(loss)(args[4])
        return np.asarray(g, np.float64).reshape(len(lanes), -1)

    def grad_port(clamp):
        args = [torch.tensor(v, dtype=torch.float32) for v in data]
        args[4].requires_grad_(True)
        config = qt.SolverConfig(grad_clamp=clamp, verbose=-1)
        z = qt.solve_qp_diag(*args, config=config, device="cpu")
        (z * z).sum().backward()
        sol = qt.solve_qp_diag_full(*[a.detach() for a in args],
                                    config=config, device="cpu")
        return args[4].grad.double().flatten(1).numpy(), sol

    g64 = grad_jax(jnp.float64, False)

    def rel(g):
        return np.abs(g - g64).max(axis=1) / np.abs(g64).max(axis=1)

    g_xla, g_pallas = grad_jax(jnp.float32, False), grad_jax(jnp.float32,
                                                             True)
    g_port, sol = grad_port(1e-8)
    # M's condition at the port's float32 solution, in float64.
    lam, s = sol.lam.double(), sol.s.double()
    H = 0.1 + lam.clamp(min=1e-8) / s.clamp(min=1e-8)
    A = torch.tensor(data[4][0])
    ev = torch.linalg.eigvalsh(A @ torch.diag_embed(1.0 / H) @ A.T)
    cond = (ev[:, -1] / ev[:, 0]).numpy()
    assert cond[0] > 1e8 and (cond[1:] < 1e6).all(), cond

    assert np.isnan(g_xla[0]).any() and np.isnan(g_port[0]).any()
    assert np.isnan(g_pallas[0]).any() or rel(g_pallas)[0] > 1.0
    for g in (g_xla, g_pallas, g_port):
        assert np.isfinite(g[1:]).all()
        assert (rel(g)[1:] < 5e-3).all(), rel(g)
    g_port5, _ = grad_port(1e-5)
    assert np.isfinite(g_port5).all()


def _excess(a, b):
    """Per lane: how far |a - b| exceeds the fused-vs-composed tolerance
    2e-4 + 1e-3 |b| (> 0: beyond it)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) - (2e-4 + 1e-3 * np.abs(b))).max(axis=-1)


@pytest.mark.parametrize("witness", ["jax_xla_vs_pallas", "port_composed",
                                     "port_fused"])
def test_sudoku_f32_duals_are_set_by_rounding(witness):
    """On a few lanes of the sudoku draw the float32 duals are decided by
    rounding: two float32 runs of the same algorithm that only sum in
    another order return multipliers 0.1-0.4 apart, beyond the reference's
    fused-vs-composed tolerance, while z agrees on every lane. These lanes
    have a bound near the degenerate corner (s + lam ~ 1e-5 in float64) on
    top of nx - neq = 24 active ones. The on-card run's fused kernel parts
    from the composed step on such lanes (lane 1939 of seed 0, by 0.135),
    so its dual gate allows 0.5% of the lanes.

    ``jax_xla_vs_pallas``: the JAX package's own float32 paths (XLA, and the
    fused Pallas kernel in interpret mode), seed 1, lanes 603 and 3220.
    ``port_composed`` / ``port_fused``: the port on the problem with its 64
    variables and 40 equality rows permuted, against the problem as drawn,
    seed 0, lane 1939."""
    if witness == "jax_xla_vs_pallas":
        seed, lanes, n_off = 1, [603, 3220, 344, 919, 1347, 2564, 3889, 0], 2
    else:
        seed, lanes, n_off = 0, [1939, 0, 1, 2, 3, 4, 5, 6], 1
    data = list(_sudoku_lanes(lanes, seed))
    data[4] = data[4][0]
    q, p, g, h, A, b = data
    s64 = qt.solve_qp_diag_full(*[torch.tensor(v) for v in data],
                                device="cpu")
    if witness == "jax_xla_vs_pallas":
        def jax_solve(use_pallas):
            cfg = qpth_tpu.SolverConfig(use_pallas=use_pallas,
                                        fused_diag_step=use_pallas,
                                        verbose=-1)
            sol = qpth_tpu.solve_qp_diag_full(
                *[jnp.asarray(v, jnp.float32) for v in data], config=cfg)
            return [np.asarray(getattr(sol, k)) for k in ("z", "lam", "nu")]

        one, two = jax_solve(False), jax_solve(True)
    else:
        cfg = qt.SolverConfig(fused_diag_step=witness == "port_fused",
                              verbose=-1)
        rng = np.random.RandomState(100)
        pc, pr = rng.permutation(NX), rng.permutation(NEQ)

        def port_solve(q, p, g, h, A, b):
            sol = qt.solve_qp_diag_full(
                *[torch.tensor(v, dtype=torch.float32)
                  for v in (q, p, g, h, A, b)], config=cfg, device="cpu")
            return [getattr(sol, k).numpy() for k in ("z", "lam", "nu")]

        one = port_solve(*data)
        z, lam, nu = port_solve(q[pc], p[:, pc], g[pc], h[pc], A[pr][:, pc],
                                b[pr])
        ic, ir = np.argsort(pc), np.argsort(pr)
        two = [z[:, ic], lam[:, ic], nu[:, ir]]

    assert (_excess(two[0], one[0]) <= 0).all()            # z: every lane
    lam64 = s64.lam.numpy()
    apart = _excess(two[1], one[1]) > 0
    assert apart[:n_off].all() and not apart[n_off:].any(), apart
    gap = np.abs(two[1] - one[1]).max(axis=1)
    assert (gap[:n_off] > 0.1).all(), gap
    # One of the two runs is at float64's multipliers on the parted lanes.
    near = np.minimum(np.abs(one[1] - lam64).max(axis=1),
                      np.abs(two[1] - lam64).max(axis=1))
    assert (near < 1e-4).all(), near
    gap64 = (s64.s + s64.lam).amin(dim=-1).numpy()
    assert (gap64[:n_off] < 1e-4).all(), gap64


def test_sudoku_layer_f32_default_grad_is_nan_in_the_reference_too():
    """``OptNetSudoku()`` at its defaults (b = 1, ``grad_clamp=1e-8``,
    float32) on 64 puzzles of the seed-0 draw, with the Flax module's
    initial A: b = 1 is infeasible for a random A, the duals run away on
    some lanes and the gradient to the shared A is NaN, in the Flax module
    as in the port (on other lanes: float32 picks them). The outputs are
    finite in both. The on-card run (path 5e) therefore gates the layer's
    output, and its float64 gradient card against CPU."""
    from qpth_tpu.nn import OptNetSudoku as FlaxSudoku

    rng = np.random.RandomState(0)
    rng.rand(NEQ, NX)
    x = (rng.rand(64, NX) < 0.25).astype(np.float32).reshape(64, 4, 4, 4)
    flax_model = FlaxSudoku()
    params = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(pr):
        out = flax_model.apply(pr, jnp.asarray(x))
        return jnp.mean((out - x) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    model = qt.nn.OptNetSudoku(device="cpu")
    qt.optnet_params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, params))
    xt = torch.tensor(x)
    out_t = model(xt)
    ((out_t - xt) ** 2).mean().backward()
    assert np.isfinite(np.asarray(out_j)).all()
    assert bool(torch.isfinite(out_t).all())
    assert np.isnan(np.asarray(g_j["params"]["A"])).any()
    assert bool(torch.isnan(model.A.grad).any())
