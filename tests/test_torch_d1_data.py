"""``tests/data_torch_d1.npz``, the inputs of ROADMAP §3's D1 measurement
on the card (``chip_smoke.py``, ``d1_measure``), written on the CPU by
``tests/make_torch_d1_data.py``: the stored Q is bench.py's, the stored
iteration's T is symmetric positive definite, and the port's plain version
still gives the stored CPU reading on it."""

import os

import numpy as np
import numpy.testing as npt
import torch

from qpth_tpu_torch.ops.cuda import kernels

from make_torch_d1_data import NZ, make_problem, unpack

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data_torch_d1.npz")


def _load():
    return np.load(DATA)


def test_stored_q_is_the_bench_q():
    d = _load()
    n = d["s"].shape[0]
    # Q depends only on L, the first draw: the first n lanes of B = 4096
    # are those of B = n.
    Q = make_problem(n, NZ, NZ, seed=0)[0].astype(np.float32)
    npt.assert_array_equal(unpack(d["Q"]), Q)


def test_stored_t_is_spd_and_the_plain_reading_holds():
    d = _load()
    s, z = d["s"], d["z"]
    assert (s > 0).all() and (z > 0).all()
    for key, M, dinv in (("Q", unpack(d["Q"]), np.zeros_like(s)),
                         ("T", unpack(d["R"]), s / z)):
        T64 = M.astype(np.float64) + np.apply_along_axis(
            np.diag, 1, dinv.astype(np.float64))
        # Cholesky raises on a lane that is not positive definite (the
        # diagonal spans 1e-18 to 1e19 at this iteration: eigenvalues
        # would be rounding there).
        exact = np.linalg.inv(np.linalg.cholesky(T64))
        G = kernels.factor_inv_plain(torch.from_numpy(M),
                                     torch.from_numpy(dinv)).numpy()
        err = (np.linalg.norm(G.astype(np.float64) - exact, axis=(1, 2))
               / np.linalg.norm(exact, axis=(1, 2)))
        npt.assert_allclose(np.median(err),
                            np.median(d[f"err_{key}_port_plain"]),
                            rtol=0.05)
        # The JAX kernel's reading sits below the plain version's on both.
        assert (np.median(d[f"err_{key}_jax_kernel"])
                < np.median(d[f"err_{key}_port_plain"]))
