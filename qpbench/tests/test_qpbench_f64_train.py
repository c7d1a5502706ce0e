"""The float64 OptNet layer in training (cell ``dense100.f64_train``,
configuration ``qpth_dense100_f64``): the program against the plain
reference at float64's own accuracy, the path the configuration takes (the
composed step of the float64 default, no fused step), the program against
the exact optimum at the cell's own widths, and, on the card, limits that
the program's float32 solve of the same draws fails."""

import pytest
import torch

import qpth_tpu_torch as qt
from qpbench import check, harness
from qpbench.reference import qp as ref
from qpbench.tests.conftest import tiny
from qpth_tpu_torch.ops.cuda import kernels

CELL = "dense100.f64_train"

#: Relative errors |x - r| / |r| over the batch, on the CPU at nz = nineq
#: = 8 (two seeds, both calls of each). z reads 5e-14 - 1.8e-12, the
#: float64 floor of two interior point solves that both run to eps =
#: 1e-12: its tolerance is 50x that and 6,000x below the port's float32
#: solve of the same draws (6.5e-7 - 1.5e-5), which the 1e-5 of
#: ``test_reference_matches_program`` lets pass. Each gradient reads 4e-8
#: - 9.4e-7, since d = lam / s of a nearly active constraint (~1e10)
#: amplifies the two solvers' last digits of s: 10x the largest. The
#: float32 gradients read 8.7e-7 - 3.1e-3, so at this size z alone tells
#: the two precisions apart.
TOL = {"z": 1e-10, "Q": 1e-5, "p": 1e-5, "G": 1e-5, "h": 1e-5}


def _pool(seed, device="cpu", **sizes):
    if sizes:
        cell, config = harness.load_cell(CELL)
        cell.update(sizes)
    else:
        cell, config = tiny(CELL)
    return cell, config, harness.Pool(config, cell, seed,
                                      torch.device(device))


def _calls(cell, config, pool, seed, call):
    plan = harness.Plan(pool, seed)
    kept = []
    for i in range(cell["check_calls"]):
        j, o = plan.next()
        kept.append((i, (j, o, call(pool.batch(j, o), pool.cotangent(o)))))
    return kept


def _program(config, cell, dtype, device):
    """The timed call of the cell, in ``dtype`` on the pool's float64
    draws: the float32 program is the port as the float32 configurations
    run it, on the same QPs rounded to float32."""
    solver = qt.SolverConfig(**config["solver_config"])
    call = harness.make_call(config, cell, solver, qt, device)

    def run(x, cot):
        return call({k: v.to(dtype) for k, v in x.items()}, cot.to(dtype))

    return run


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_program_matches_reference(seed):
    cell, config, pool = _pool(seed)
    assert config["dtype"] == "float64"
    call = _program(config, cell, torch.float64, "cpu")
    for _, (j, o, got) in _calls(cell, config, pool, seed, call):
        x, cot = pool.batch(j, o), pool.cotangent(o)
        want = check.reference_outputs(x, cot, pool, config, cell)
        assert set(got) == set(want) == set(TOL)
        for key, tol in TOL.items():
            assert got[key].dtype == torch.float64
            err = float((got[key] - want[key]).norm() / want[key].norm())
            assert err < tol, (key, err)


def test_takes_the_composed_step(monkeypatch):
    """Each stepped iteration is one factor with its first solve (kernel A
    with a right-hand side) and one further solve (kernel 5); the init
    adds one factor-solve; no fused step runs."""
    counts = {"factor_solve": 0, "factor": 0, "inv_solve": 0}
    factor_inv, inv_solve = kernels.factor_inv, kernels.inv_solve

    def counted_factor_inv(R, dinv, rhs=None, z=None):
        counts["factor" if rhs is None else "factor_solve"] += 1
        return factor_inv(R, dinv, rhs, z)

    def counted_inv_solve(*args, **kw):
        counts["inv_solve"] += 1
        return inv_solve(*args, **kw)

    def no_fused(*args, **kw):
        raise AssertionError("a fused step ran")

    monkeypatch.setattr(kernels, "factor_inv", counted_factor_inv)
    monkeypatch.setattr(kernels, "inv_solve", counted_inv_solve)
    for name in ("ipm_step", "ipm_step_xfree", "ipm_step_eq"):
        monkeypatch.setattr(kernels, name, no_fused)
    cell, config, pool = _pool(5)
    solver = qt.SolverConfig(**config["solver_config"])
    x = pool.batch(0, 0)
    sol = qt.solve_qp_full(*(x[a] for a in config["args"]), config=solver,
                           device="cpu")
    stepped = int(sol.stats.iterations) - 1
    assert stepped > 0
    assert counts == {"factor_solve": stepped + 1, "factor": 0,
                      "inv_solve": stepped}


def _exact(x, cot, pool, config, cell, sol):
    """z and the gradients at the exact optimum of the active set of the
    program's float64 solve ``sol`` (rows with s < lam): one KKT solve
    with the other rows' multipliers held at 0, no interior point. It is
    the optimum where its multipliers are >= 0 and its other rows' slacks
    >= 0 (both returned); the gradients are the reference's equations at
    that point."""
    Q, p, G, h, A, _ = pool.as_dense(x)
    act = (sol.s < sol.lam).to(p.dtype)
    B, n = p.shape
    m = h.shape[-1]
    Ge = G.expand(B, m, n)
    Ga = act.unsqueeze(-1) * Ge
    K = p.new_zeros((B, n + m, n + m))
    K[:, :n, :n] = Q.expand(B, n, n)
    K[:, :n, n:] = Ga.transpose(-1, -2)
    K[:, n:, :n] = Ga
    K[:, n:, n:] = torch.diag_embed(1 - act)
    y = torch.linalg.solve(K, torch.cat([-p, h * act], -1))
    z, lam = y[:, :n], y[:, n:] * act
    s = (h - torch.matmul(Ge, z.unsqueeze(-1)).squeeze(-1)) * (1 - act)
    point = {"z": z, "s": s, "lam": lam, "nu": sol.nu}
    grads = ref.gradients(Q, G, A, point, cot,
                          config["solver_config"].get("grad_clamp", 1e-8),
                          shared=cell["shared"])
    out = dict({"z": z}, **{g: grads[g] for g in cell["grads"]})
    return out, float(lam[act.bool()].min()), float(s[~act.bool()].min())


#: Lane errors (``check.lane_errors``) of the program against the exact
#: optimum at the cell's own widths, 64 lanes. Measured at 512 lanes on
#: the CPU and 8192 on the card: z 1e-12 at most, each gradient 1.7e-6 a
#: lane and 6e-7 summed, the float64 floor of a solve with d = lam / s up
#: to ~1e8: 10x that. (A lane whose optimum is nearly degenerate, a row
#: with lam and s both below ~1e-6, parts further, since its active set is
#: then a matter of rounding: one lane in 32,768 on the card; none here.)
#: The plain reference reads up to 42% on ~1.5% of lanes there: it stops
#: at a duality gap ~1e-8 with or without its stall rule, where a row with
#: lam ~1e-4 still has s ~1e-4. That is why the cell's RMS and summed
#: limits sit where they do.
EXACT_TOL = {"z": 1e-11, "Q": 1e-5, "p": 1e-5, "G": 1e-5, "h": 1e-5}


@pytest.mark.parametrize("seed", [7, 2 ** 32 + 5])
def test_gradients_match_the_exact_optimum(seed):
    """At nz = nineq = 100: the program's z and gradients are those of the
    exact optimum of its own active set, to float64's floor."""
    cell, config, pool = _pool(seed, batch=64, pool_lanes=128,
                               check_calls=1)
    solver = qt.SolverConfig(**config["solver_config"])
    call = _program(config, cell, torch.float64, "cpu")
    (_, (j, o, got)), = _calls(cell, config, pool, seed, call)
    x, cot = pool.batch(j, o), pool.cotangent(o)
    sol = qt.solve_qp_full(*(x[a] for a in config["args"]), config=solver,
                           device="cpu")
    want, lam_min, s_min = _exact(x, cot, pool, config, cell, sol)
    assert lam_min > 0 and s_min > 0
    for key, tol in EXACT_TOL.items():
        if key in cell["shared"]:
            err = check.shared_error(got[key], want[key])
        else:
            err = float(check.lane_errors(got[key], want[key])[0].max())
        assert err < tol, (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12])
def test_float32_fails_every_limit(seed):
    """On the card, at 512 lanes a call: the port in float32 on the cell's
    draws fails each of the cell's limits (its readings near 1e-4 on the
    medians and 3e-2 on the rest, the limits near float64's and the plain
    reference's own error). That the float64 port passes them on the same
    draws is ``test_qpbench_control.py``'s, for every benchmarked cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, config, pool = _pool(seed, "cuda", batch=512, pool_lanes=1024)
    call = _program(config, cell, torch.float32, torch.device("cuda"))
    kept = _calls(cell, config, pool, seed, call)
    numbers, failed = check.readings(kept, pool, cell, config)
    assert failed == 0
    passed = [k for k, v in cell["limits"].items() if numbers[k] <= v]
    assert not passed, numbers
