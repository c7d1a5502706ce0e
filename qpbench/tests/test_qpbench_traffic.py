"""The generators: the same seed draws the same pool, another seed another
one, and every QP drawn is feasible at its witness (h - G z0 > 0 and
A z0 = b)."""

from types import SimpleNamespace

import pytest
import torch

from qpbench import harness
from qpbench.tests.conftest import CELLS, load, tiny

SEED = 2 ** 31 + 12345     # larger than 32 signed bits hold


def pool_of(name, seed):
    cell, config = tiny(name)
    return harness.Pool(config, cell, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_pool(name):
    a, b, c = pool_of(name, SEED), pool_of(name, SEED), pool_of(name, 7)
    for key, (t, kind) in a.inputs.items():
        assert kind == b.inputs[key][1]
        assert torch.equal(t, b.inputs[key][0]), key
    assert any(not torch.equal(t, c.inputs[k][0])
               for k, (t, _) in a.inputs.items())
    if a.cot is not None:
        assert torch.equal(a.cot, b.cot)


def draws(name, seed):
    cell, config = tiny(name)
    gen = torch.Generator().manual_seed(seed)
    module = harness.load_module(
        harness.BENCH / "traffic" / f"{config['generator']}.py")
    return cell, config, module.draw(config, cell, gen, "cpu")


@pytest.mark.parametrize("name", ["dense100.fwd", "dense100.optnet_train"])
def test_dense_feasible(name):
    cell, config, (inputs, witness) = draws(name, SEED)
    G, h = inputs["G"][0].double(), inputs["h"][0].double()
    z0 = witness["z0"][0].double()
    if inputs["G"][1] == "shared":          # (S, m, n) x (L, n) -> (S, L, m)
        slack = h - torch.einsum("smn,ln->slm", G, z0)
    else:
        slack = h - torch.einsum("lmn,ln->lm", G, z0)
    assert bool((slack > 0).all())
    s0 = witness["s0"][0].double()
    assert torch.allclose(slack, s0.expand_as(slack), atol=1e-5)


def test_dense_q_is_spd():
    _, _, (inputs, _) = draws("dense100.fwd", SEED)
    Q = inputs["Q"][0].double()
    assert torch.allclose(Q, Q.transpose(-1, -2))
    assert bool((torch.linalg.eigvalsh(Q) > 0).all())


def test_sudoku_feasible():
    cell, config, (inputs, witness) = draws("sudoku4.diag_fwd", SEED)
    A, b = inputs["A"][0].double(), inputs["b"][0].double()
    z0 = witness["z0"][0].double()
    assert torch.allclose(torch.matmul(A, z0), b, atol=1e-6)
    # G = -I, h = 0: the bound -z0 <= 0 holds strictly.
    assert bool((inputs["h"][0] - inputs["g"][0] * z0 > 0).all())
    p = inputs["p"][0]
    assert set(p.unique().tolist()) <= {-1.0, 0.0}


@pytest.mark.parametrize("name", CELLS)
def test_plan_is_seeded_and_distinct(name):
    """At the cell's own pool sizes: the same calls for the same seed,
    never the previous call's shared entry, and batches that do not
    repeat within a window's worth of calls."""
    cell, _ = load(name)
    pool = SimpleNamespace(entries=cell["pool_shared"], B=cell["batch"],
                           lanes=cell["pool_lanes"])
    a, b = harness.Plan(pool, SEED), harness.Plan(pool, SEED)
    calls = [a.next() for _ in range(500)]
    assert calls == [b.next() for _ in range(500)]
    assert all(0 <= o <= pool.lanes - pool.B for _, o in calls)
    if pool.entries > 1:
        assert all(x[0] != y[0] for x, y in zip(calls, calls[1:]))
    assert len(set(calls)) > 450
