"""Carrying the JAX package's cached factorization over to the port with
equality constraints, in inverse and in substitution mode:
``qpth_tpu.prefactor_qp(Q, G, A)`` -> numpy -> ``factors_from_numpy`` ->
``solve_qp_full(factors=)`` equals the JAX solve with the same cached
factors (float64; the two solvers then differ by rounding only)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt

from test_torch_qp import _jax_factors_as_numpy
from test_torch_qp_eq import make_eq_problem

torch.set_num_threads(1)

MODES = {
    "inverse": dict(solve_method="inverse", resid_every=7),
    "inverse_equilibrated": dict(solve_method="inverse", resid_every=7,
                                 equilibrate=True),
    "subst": dict(eps=1e-9, refine_steps=0),
    "subst_equilibrated": dict(equilibrate=True, eps=1e-9, refine_steps=0),
}


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
@pytest.mark.parametrize("mode", list(MODES))
def test_carried_factors_with_equalities(mode, shared):
    Q, p, G, h, A, b = make_eq_problem(8, 12, 10, 4, seed=2)
    if shared:
        # shared Q and A; G and the vectors stay per lane
        z0 = np.linalg.lstsq(A[0], b[0], rcond=None)[0]
        Q, A, b = Q[0], A[0], b[0]
        h = np.einsum("bmn,n->bm", G, z0) + 0.5
    kw = MODES[mode]
    cj, ct = qpth_tpu.SolverConfig(**kw), qt.SolverConfig(**kw)
    fj = qpth_tpu.prefactor_qp(jnp.asarray(Q), jnp.asarray(G),
                               jnp.asarray(A), config=cj)
    carried = qt.factors_from_numpy(_jax_factors_as_numpy(fj), "cpu")
    subst = mode.startswith("subst")
    assert (carried.L_Q is not None) == subst
    assert (carried.invQ_AT is None) == subst
    assert (carried.scaling is not None) == mode.endswith("equilibrated")
    if carried.scaling is not None:
        assert carried.scaling.RA is not None
    for k, v in fj._asdict().items():
        if k not in ("scaling", "sem_scaling", "facQ"):
            assert (getattr(carried, k) is None) == (v is None), k

    sj = qpth_tpu.solve_qp_full(*(jnp.asarray(v)
                                  for v in (Q, p, G, h, A, b)),
                                config=cj, factors=fj)
    st = qt.solve_qp_full(*(torch.tensor(v) for v in (Q, p, G, h, A, b)),
                          config=ct, factors=carried, device="cpu")
    for name in ("z", "nu", "lam", "s"):
        npt.assert_allclose(getattr(st, name).numpy(),
                            np.asarray(getattr(sj, name)), atol=1e-9,
                            err_msg=name)
    assert int(st.stats.iterations) == int(sj.stats.iterations)

    # and against the port's own prefactorization of the same data
    own = qt.solve_qp_full(*(torch.tensor(v) for v in (Q, p, G, h, A, b)),
                           config=ct, device="cpu")
    npt.assert_allclose(st.z.numpy(), own.z.numpy(), atol=1e-9)


def test_carried_factors_refusals():
    Q, _, G, _, A, _ = make_eq_problem(2, 5, 4, 2, seed=0)
    f = _jax_factors_as_numpy(qpth_tpu.prefactor_qp(
        jnp.asarray(Q), jnp.asarray(G), jnp.asarray(A),
        config=qpth_tpu.SolverConfig(solve_method="inverse")))
    # Q's blocked factor (the hybrid regime) stands in for invQ; without
    # either, and without L_Q, the factors are refused.
    facQ = dict(Gs=[np.eye(5)[None]], Ps=[None], m=5, block=5)
    got = qt.factors_from_numpy(
        dict({k: v for k, v in f.items() if k != "invQ"}, facQ=facQ), "cpu")
    assert got.invQ is None and got.facQ.m == 5
    with pytest.raises(ValueError, match="needs R"):
        qt.factors_from_numpy({k: v for k, v in f.items() if k != "invQ"},
                              "cpu")
