"""The torch example scripts (``examples/torch_cls_layer.py``,
``examples/torch_sudoku.py``, ``examples/torch_mpc.py``,
``examples/torch_graph_qp.py``) against the JAX scripts they follow
(``examples/cls_layer.py``, ``examples/sudoku.py``, ``examples/mpc.py``,
``examples/graph_qp.py``), on the CPU at small sizes. The port's model takes the Flax model's initial parameters
(``optnet_params_from_numpy``) and the scripts' own data; the first step's
loss, gradients and Adam update then agree with the JAX script's step
(``jax.value_and_grad`` and ``optax.adam``): float64 to 1e-8, and one
float32 classifier step to 5e-4 of each gradient's largest entry (the
float32 gradient tolerance of ``tests/test_torch_grads_f32.py``). A few
steps of each script then lower its loss on the whole data set. The MPC
script's first two receding-horizon steps (cold, then warm-started) match
the JAX package's solves of the same data in float64, in both
formulations; the graph layer's first loss and weight gradient match the
JAX SpQPFunction's on the general tier."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu.nn import OptNetClassifier as FlaxClassifier
from qpth_tpu.nn import OptNetSudoku as FlaxSudoku

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
CLS = dict(n_features=10, n_hidden=16, n_cls=4, n_ineq=8)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    npt.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale,
                        err_msg=err_msg)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _cls_pairs(model):
    """(port tensor, Flax path) for every classifier parameter; Dense
    kernels are the transposes of the Linear weights."""
    return [(model.fc1.weight, ("Dense_0", "kernel"), True),
            (model.fc1.bias, ("Dense_0", "bias"), False),
            (model.fc2.weight, ("Dense_1", "kernel"), True),
            (model.fc2.bias, ("Dense_1", "bias"), False)] + [
        (getattr(model, k), (k,), False) for k in ("L", "G", "z0", "s0")]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _first_step(flax_model, flax_loss, model, script, x, y, lr, pairs,
                np_dtype, tol):
    """One step of each side from the same parameters: loss, gradients
    and the parameters after the Adam update."""
    params = _cast(flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                   np_dtype)
    qt.optnet_params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, params))
    loss_j, g_j = jax.value_and_grad(flax_loss)(params)
    opt_j = optax.adam(lr)
    upd, _ = opt_j.update(g_j, opt_j.init(params))
    new_j = optax.apply_updates(params, upd)

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    dt = next(model.parameters()).dtype
    xt = torch.tensor(x, dtype=dt)
    yt = torch.tensor(y, dtype=dt) if y.dtype.kind == "f" else torch.tensor(y)
    loss_t = script.loss_fn(model, xt, yt)
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j), tol, "loss")
    for t, path, tr in pairs:
        g = _get(g_j["params"], path)
        _close(t.grad.numpy(), np.asarray(g).T if tr else g, tol,
               f"gradient {path}")
    opt.step()
    for t, path, tr in pairs:
        w = _get(new_j["params"], path)
        _close(t.detach().numpy(), np.asarray(w).T if tr else w, tol,
               f"updated {path}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cls_first_step_matches_jax_script(dtype):
    script = _script("torch_cls_layer")
    np_dtype = np.float64 if dtype == "float64" else np.float32
    tol = 1e-8 if dtype == "float64" else 5e-4
    rng, x_all, y_all = script.make_data(CLS["n_features"], CLS["n_cls"],
                                         12, seed=0)
    idx = rng.choice(len(x_all), 12, replace=False)
    x, y = x_all[idx].astype(np_dtype), y_all[idx]
    flax_model = FlaxClassifier(**CLS)

    def flax_loss(params):
        logp = flax_model.apply(params, jnp.asarray(x))
        return -jnp.mean(logp[jnp.arange(x.shape[0]), y])

    model = qt.nn.OptNetClassifier(**CLS, device="cpu",
                                   dtype=getattr(torch, dtype))
    _first_step(flax_model, flax_loss, model, script, x, y, 1e-3,
                _cls_pairs(model), np_dtype, tol)


def test_sudoku_first_step_matches_jax_script():
    script = _script("torch_sudoku")
    rng = np.random.RandomState(0)
    puzzles, solutions = script.gen_sudoku_data(rng, 16)
    idx = rng.choice(16, 8, replace=False)
    x, y = puzzles[idx], solutions[idx]
    flax_model = FlaxSudoku(n=2, n_eq=40)

    def flax_loss(params):
        return jnp.mean((flax_model.apply(params, jnp.asarray(x)) - y) ** 2)

    model = qt.nn.OptNetSudoku(n=2, n_eq=40, device="cpu",
                               dtype=torch.float64)
    _first_step(flax_model, flax_loss, model, script, x, y, 0.02,
                [(model.A, ("A",), False)], np.float64, 1e-8)


def test_sudoku_data_is_the_jax_scripts():
    """``gen_sudoku_data`` is a copy: the same boards from the same seed."""
    import sys

    sys.path.insert(0, EXAMPLES)
    try:
        import sudoku as jax_sudoku
    finally:
        sys.path.remove(EXAMPLES)
    got = _script("torch_sudoku").gen_sudoku_data(
        np.random.RandomState(3), 10)
    want = jax_sudoku.gen_sudoku_data(np.random.RandomState(3), 10)
    for a, b in zip(got, want):
        npt.assert_array_equal(a, b)


def test_cls_script_lowers_its_loss():
    script = _script("torch_cls_layer")
    rng, x_all, y_all = script.make_data(CLS["n_features"], CLS["n_cls"],
                                         32, seed=0)
    model = qt.nn.OptNetClassifier(
        **CLS, device="cpu", generator=torch.Generator().manual_seed(0))
    xt, yt = torch.tensor(x_all), torch.tensor(y_all)
    with torch.no_grad():
        before = float(script.loss_fn(model, xt, yt))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = script.train(model, opt, rng, x_all, y_all, 32, 15, log=None)
    with torch.no_grad():
        after = float(script.loss_fn(model, xt, yt))
    assert len(losses) == 15 and all(np.isfinite(losses))
    assert after < before, (before, after)


def test_sudoku_script_lowers_its_loss():
    script = _script("torch_sudoku")
    rng = np.random.RandomState(0)
    puzzles, solutions = script.gen_sudoku_data(rng, 16)
    model = qt.nn.OptNetSudoku(n=2, n_eq=40, device="cpu",
                               dtype=torch.float64,
                               generator=torch.Generator().manual_seed(0))
    xt, yt = torch.tensor(puzzles), torch.tensor(solutions)
    with torch.no_grad():
        before = float(script.loss_fn(model, xt, yt))
    opt = torch.optim.Adam(model.parameters(), lr=0.02)
    losses = script.train(model, opt, rng, puzzles, solutions, 8, 8,
                          log=None)
    with torch.no_grad():
        after = float(script.loss_fn(model, xt, yt))
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert after < before, (before, after)


@pytest.mark.parametrize("name", ["torch_cls_layer", "torch_sudoku",
                                  "torch_mpc", "torch_graph_qp"])
def test_scripts_need_cuda_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _script(name).main(["--steps", "1"])


@pytest.mark.parametrize("formulation", ["condensed", "banded"])
def test_mpc_steps_match_jax(formulation):
    """The first receding-horizon step and the warm-started second one,
    float64, against the JAX package on the script's data: z to 1e-9 and
    equal iterations (the JAX script's own solves, ``solve_qp_full`` with
    ``prefactor_qp`` and ``solve_qp_banded_full`` with ``g_cols``)."""
    import qpth_tpu

    script = _script("torch_mpc")
    B, T = 8, 6
    pos, vel, target = (torch.tensor(a, dtype=torch.float64)
                        for a in script.initial_state(B))
    cfg_j = qpth_tpu.SolverConfig(check_Q_spd=False)
    cfg_t = qt.SolverConfig(check_Q_spd=False)
    if formulation == "condensed":
        Q, G, A, S = script.build_mpc_qp(T)
        h = np.full((B, 2 * T), script.U_MAX)
        fac_j = qpth_tpu.prefactor_qp(*map(jnp.asarray, (Q, G, A)),
                                      config=cfg_j)
        fac_t = qt.prefactor_qp(*map(torch.tensor, (Q, G, A)), config=cfg_t,
                                device="cpu")

        def solves(init_t, init_j):
            p, b = script.condensed_step_data(pos, vel, target,
                                              torch.tensor(S))
            ops = (Q, p.numpy(), G, h, A, b.numpy())
            st = qt.solve_qp_full(*map(torch.tensor, ops), config=cfg_t,
                                  init=init_t, factors=fac_t, device="cpu")
            sj = qpth_tpu.solve_qp_full(*map(jnp.asarray, ops), config=cfg_j,
                                        init=init_j, factors=fac_j)
            return st, sj
    else:
        Qd, Qe, A, g, h, g_cols = script.build_banded(T)

        def solves(init_t, init_j):
            p, b = script.banded_step_data(pos, vel, target, 3 * T)
            ops = (Qd, Qe, p.numpy(), g, h, A, b.numpy())
            st = qt.solve_qp_banded_full(*map(torch.tensor, ops),
                                         config=cfg_t, init=init_t,
                                         g_cols=g_cols, device="cpu")
            sj = qpth_tpu.solve_qp_banded_full(*map(jnp.asarray, ops),
                                               config=cfg_j, init=init_j,
                                               g_cols=g_cols)
            return st, sj

    init_t = init_j = None
    for _ in range(2):
        st, sj = solves(init_t, init_j)
        _close(st.z.numpy(), sj.z, 1e-9, "z")
        assert int(st.stats.iterations) == int(sj.stats.iterations)
        init_t = (st.z, st.s, st.lam, st.nu)
        init_j = (sj.z, sj.s, sj.lam, sj.nu)
        u0 = st.z[:, 0 if formulation == "condensed" else 2]
        pos, vel = (pos + script.DT * vel + 0.5 * script.DT ** 2 * u0,
                    vel + script.DT * u0)


@pytest.mark.parametrize("formulation", ["condensed", "banded"])
def test_mpc_script_tracks_its_targets(formulation):
    script = _script("torch_mpc")
    recs = script.run(formulation, 16, 8, 6, torch.device("cpu"), log=None)
    assert len(recs) == 6
    assert all(np.isfinite(r["error"]) and r["iterations"] > 0
               for r in recs)
    assert recs[-1]["error"] < recs[0]["error"]


def test_graph_first_step_matches_jax():
    """float64, the general tier in both packages: the loss of the first
    batch and its gradient to the log edge weights, the JAX package's
    ``jax.value_and_grad`` through its SpQPFunction with the JAX script's
    value construction, against the port's layer, to 1e-8."""
    script = _script("torch_graph_qp")
    n, B = 24, 6
    label, Qi, Gi, E, m = script.make_graph(n)
    noisy, clean = script.make_batch(np.random.RandomState(1), B, label)
    model = script.GraphDenoiser(Qi, Gi, n, E, m, device="cpu",
                                 dtype=torch.float64)
    assert model.f.structure == "general"
    assert model.f._tier(model.logw) == "general"
    logw0 = np.random.RandomState(2).randn(E) * 0.3
    with torch.no_grad():
        model.logw.copy_(torch.tensor(logw0))
    loss_t = script.loss_fn(model, torch.tensor(noisy), torch.tensor(clean))
    loss_t.backward()

    import qpth_tpu

    fj = qpth_tpu.SpQPFunction(
        Qi, (n, n), Gi, (m, n), np.zeros((2, 0), int), (0, n),
        config=qpth_tpu.SolverConfig(verbose=-1, check_Q_spd=False))
    assert fj.structure == "general"

    def loss_j(logw):
        # examples/graph_qp.py's qp_denoise.
        w = jnp.exp(logw)
        deg = jnp.zeros((n,)).at[Qi[0, n:n + 2 * E:2]].add(w).at[
            Qi[1, n:n + 2 * E:2]].add(w)
        Qv = jnp.concatenate([jnp.broadcast_to(1.0 + deg, (B, n)),
                              jnp.repeat(-w, 2)[None] * jnp.ones((B, 1))],
                             axis=1)
        Gv = jnp.concatenate([jnp.ones((B, m, 1)), -jnp.ones((B, m, 1))],
                             axis=-1).reshape(B, 2 * m)
        z = fj(Qv, -jnp.asarray(noisy), Gv, jnp.full((B, m), 0.8),
               jnp.zeros((B, 0)), jnp.zeros((B, 0)))
        return jnp.mean((z - clean) ** 2)

    lj, gj = jax.value_and_grad(loss_j)(jnp.asarray(logw0))
    _close(float(loss_t.detach()), float(lj), 1e-8, "loss")
    _close(model.logw.grad.numpy(), gj, 1e-8, "gradient")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_graph_script_lowers_its_loss(dtype):
    """A few SGD steps of the script's training (float32: the densified
    tier, as in the reference; float64: the general tier) end below the
    noisy input's error."""
    losses, base, tier = _script("torch_graph_qp").main(
        ["--steps", "4", "--nodes", "24", "--batch", "8", "--dtype", dtype,
         "--device", "cpu"])
    assert tier == ("dense" if dtype == "float32" else "general")
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < base
