"""The PyTorch port's OptNet layers (``qpth_tpu_torch.nn``) against the
JAX package's Flax modules. Flax initialises with ``jax.random``, so the
port's modules take the Flax parameters through
``convert.optnet_params_from_numpy``; both sides then run float64 (the
Flax parameters cast up), and the outputs and the gradients of a scalar
loss to every parameter agree within 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu.nn import OptNetClassifier as FlaxClassifier
from qpth_tpu.nn import OptNetSudoku as FlaxSudoku

torch.set_num_threads(1)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=1e-8, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    npt.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                        err_msg=err_msg)


def _run_both(flax_model, torch_model, x, target):
    """Outputs and gradients of mean((out - target)^2) from both."""
    params = _f64(flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    qt.optnet_params_from_numpy(torch_model, _numpy(params))

    def loss(pr):
        out = flax_model.apply(pr, jnp.asarray(x))
        return jnp.mean((out - target) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    out_t = torch_model(torch.tensor(x))
    ((out_t - torch.tensor(target)) ** 2).mean().backward()
    return out_j, g_j["params"], out_t.detach(), torch_model


@pytest.mark.parametrize("structure", ["diag", "dense"])
def test_sudoku_layer_matches_flax(structure):
    """n = 2, n_eq = 10 (tests/test_nn.py's shape), b = 1."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64)
    model_t = qt.nn.OptNetSudoku(n=2, n_eq=10, structure=structure,
                                 device="cpu", dtype=torch.float64)
    out_j, g_j, out_t, model_t = _run_both(
        FlaxSudoku(n=2, n_eq=10, structure=structure), model_t, x,
        rng.rand(2, 64))
    assert out_t.shape == (2, 64)
    _close(out_t.numpy(), out_j, err_msg="output")
    _close(model_t.A.grad.numpy(), g_j["A"], err_msg="dA")


def test_sudoku_structures_agree():
    """The default diagonal tier and the dense layer give the same output
    and gradient for the same parameters."""
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.rand(3, 4, 4, 4))
    outs, grads = [], []
    for structure in ("diag", "dense"):
        m = qt.nn.OptNetSudoku(n=2, n_eq=10, structure=structure,
                               device="cpu", dtype=torch.float64,
                               generator=torch.Generator().manual_seed(2))
        out = m(x)
        (out * out).sum().backward()
        outs.append(out.detach().numpy())
        grads.append(m.A.grad.numpy())
    assert outs[0].shape == (3, 4, 4, 4)
    _close(outs[0], outs[1], 1e-7)
    _close(grads[0], grads[1], 1e-7)


def test_classifier_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 20)
    model_t = qt.nn.OptNetClassifier(n_features=20, n_hidden=16, n_cls=4,
                                     n_ineq=8, device="cpu",
                                     dtype=torch.float64)
    out_j, g_j, out_t, model_t = _run_both(
        FlaxClassifier(n_features=20, n_hidden=16, n_cls=4, n_ineq=8),
        model_t, x, rng.randn(6, 4))
    _close(out_t.numpy(), out_j, err_msg="log-probabilities")
    npt.assert_allclose(np.exp(out_t.numpy()).sum(-1), 1.0, atol=1e-12)
    pairs = [(model_t.fc1.weight.grad.T, g_j["Dense_0"]["kernel"]),
             (model_t.fc1.bias.grad, g_j["Dense_0"]["bias"]),
             (model_t.fc2.weight.grad.T, g_j["Dense_1"]["kernel"]),
             (model_t.fc2.bias.grad, g_j["Dense_1"]["bias"])]
    pairs += [(getattr(model_t, k).grad, g_j[k])
              for k in ("L", "G", "z0", "s0")]
    for i, (a, e) in enumerate(pairs):
        _close(a.numpy(), e, err_msg=f"parameter {i}")
        assert np.abs(np.asarray(e)).max() > 0 or i == 3


def test_layers_are_modules_with_seeded_parameters():
    mk = [qt.nn.OptNetClassifier(5, 7, 3, n_ineq=4, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
          for _ in range(2)]
    assert isinstance(mk[0], torch.nn.Module)
    names = sorted(n for n, _ in mk[0].named_parameters())
    assert names == ["G", "L", "fc1.bias", "fc1.weight", "fc2.bias",
                     "fc2.weight", "s0", "z0"]
    for a, b in zip(mk[0].parameters(), mk[1].parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert bool((mk[0].L.triu(1) == 0).all())
    sud = qt.nn.OptNetSudoku(device="cpu")
    assert sud.A.shape == (40, 64) and bool((sud.A >= 0).all())
    with pytest.raises(ValueError, match="does not match"):
        qt.optnet_params_from_numpy(sud, {"A": np.zeros((10, 64))})
