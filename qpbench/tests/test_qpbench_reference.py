"""The plain reference agrees with the program on the CPU at a tiny size,
in float64: solutions and the gradients of every input, in the fully
batched dense form, the OptNet-layer form (shared Q, G) and the diagonal
sudoku form (shared A). The test imports the program; the reference does
not."""

import pytest
import torch

import qpth_tpu_torch as qt
from qpbench import check, harness
from qpbench.reference import qp as ref
from qpbench.tests.conftest import tiny


def f64_pool(name, seed):
    cell, config = tiny(name, batch=5)
    config["dtype"] = "float64"
    return cell, config, harness.Pool(config, cell, seed,
                                      torch.device("cpu"))


@pytest.mark.parametrize("name", ["dense100.fwd", "dense100.optnet_train",
                                  "sudoku4.diag_fwd"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_reference_matches_program(name, seed):
    cell, config, pool = f64_pool(name, seed)
    cell = dict(cell, mode="train",
                grads=["p", "A"] if "A" in pool.inputs else list("QpGh"))
    pool.cot = torch.randn((pool.lanes, pool.inputs["p"][0].shape[-1]),
                           dtype=torch.float64,
                           generator=torch.Generator().manual_seed(seed))
    solver = qt.SolverConfig(**config["solver_config"])
    call = harness.make_call(config, cell, solver, qt, "cpu")
    x, cot = pool.batch(1, 2), pool.cotangent(2)
    got = call(x, cot)
    want = check.reference_outputs(x, cot, pool, config, cell)
    assert set(got) == set(want)
    for key in got:
        err = float((got[key] - want[key]).norm() / want[key].norm())
        assert err < 1e-5, (key, err)


def test_solution_satisfies_kkt():
    cell, config, pool = f64_pool("dense100.fwd", 4)
    Q, p, G, h, _, _ = pool.as_dense(pool.batch(0, 0))
    sol = ref.solve(Q, p, G, h)
    z, s, lam = sol["z"], sol["s"], sol["lam"]
    stat = (torch.matmul(Q, z.unsqueeze(-1)).squeeze(-1) + p
            + torch.matmul(G.transpose(-1, -2), lam.unsqueeze(-1))
            .squeeze(-1))
    prim = torch.matmul(G, z.unsqueeze(-1)).squeeze(-1) + s - h
    assert float(stat.abs().max()) < 1e-8
    assert float(prim.abs().max()) < 1e-8
    assert float((s * lam).abs().max()) < 1e-8
    assert bool((s >= 0).all() and (lam >= 0).all())


def test_blocks_agree():
    """Solving the lanes in blocks gives what one block gives."""
    cell, config, pool = f64_pool("dense100.optnet_train", 6)
    Q, p, G, h, _, _ = pool.as_dense(pool.batch(0, 0))
    one = ref.solve(Q, p, G, h)
    two = ref.solve(Q, p, G, h, block=2)
    assert torch.allclose(one["z"], two["z"], atol=1e-12)
    cot = torch.ones_like(p)
    g1 = ref.gradients(Q, G, None, one, cot, 1e-8, shared=("Q", "G"))
    g2 = ref.gradients(Q, G, None, two, cot, 1e-8, shared=("Q", "G"),
                       block=2)
    for key in g1:
        assert torch.allclose(g1[key], g2[key], atol=1e-10), key
