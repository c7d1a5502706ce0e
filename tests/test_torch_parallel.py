"""Batch sharding and start-up of the PyTorch port (``qpth_tpu_torch.
parallel``: ``solve_qp_sharded``, ``batch_mesh`` / ``batch_sharding``,
``init_multihost``, ``local_batch_slice``) on two gloo ranks on the CPU,
against the port's unsharded solve and the JAX package's ``shard_map``
solve on a 2-device mesh (tests/test_sharding.py's cases).

The two ranks start once for the file (``tests/_torch_parallel_worker.py``
runs every case and writes each rank's results); the tests read them."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu
import qpth_tpu_torch as qt
from qpth_tpu.parallel import batch_mesh as jax_batch_mesh
from qpth_tpu.parallel import solve_qp_sharded as jax_solve_qp_sharded
from qpth_tpu_torch.parallel import init_multihost, local_batch_slice

import _torch_parallel_worker as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.launch("parallel", tmp_path_factory.mktemp("parallel"))


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _torch(arrs, dtype=torch.float64):
    return [None if a is None else torch.tensor(a, dtype=dtype)
            for a in arrs]


def _jax_mesh2():
    return jax_batch_mesh(jax.devices()[:2])


@pytest.mark.parametrize("batched_mats", [False, True])
def test_sharded_matches_unsharded_and_jax(ranks, batched_mats):
    """(i) float64, 2 equality rows: the two ranks' lanes against the
    port's unsharded solve and the JAX package's sharded solve, 1e-9."""
    tag = "batched" if batched_mats else "shared"
    z = _cat(ranks, f"i_{tag}_z")
    args = W.sharding_args(batched_mats)
    z1 = qt.solve_qp(*_torch(args), device="cpu").numpy()
    npt.assert_allclose(z, z1, atol=1e-9, rtol=1e-9)
    mesh = _jax_mesh2()
    zj = jax.jit(lambda *a: jax_solve_qp_sharded(*a, mesh=mesh))(
        *[jnp.asarray(a) for a in args])
    npt.assert_allclose(z, np.asarray(zj), atol=1e-9, rtol=1e-9)


def test_sharded_f32_per_lane_termination(ranks):
    """(ii) float32 under the default max_iter, where the per-lane latched
    window decides the exit: the all-lanes-done test reduces over the
    group. Rank 0's lanes alone close one iteration before rank 1's, so a
    rank that did not reduce would stop early; every rank reports the
    iteration count of the unsharded 16-lane solve. z against the JAX
    package's sharded solve on its float32 kernel path (``use_pallas=
    True``, interpret mode), whose loop the port's float32 default is, at
    tests/test_torch_qp_f32.py's float32 port-vs-reference tolerance, and
    its error against float64 at most twice the reference's; and against
    the unsharded port solve at the same tolerance. The reference test's
    1e-6 / 1e-5 between the sharded and the 16-lane solve holds on no
    float32 kernel path: on this draw the JAX package's own sharded kernel
    path parts from its unsharded one by 4.0e-4, and the port's 8-lane
    solves from its 16-lane one by 7.3e-4 (|z| up to 67), since the shared
    matrices' products round by their row count."""
    args = W.termination_args()
    z1 = qt.solve_qp_full(*_torch(args, torch.float32), device="cpu")
    its = int(z1.stats.iterations)
    alone = []
    for r, res in enumerate(ranks):
        a = _torch(W.local(args, W.RANKS6, r, 2, W.B1), torch.float32)
        alone.append(int(qt.solve_qp_full(*a, device="cpu")
                         .stats.iterations))
        assert int(res["ii_its"]) == its, (r, int(res["ii_its"]), its)
        npt.assert_array_equal(res["ii_z"], res["ii_full_z"])
    assert alone[0] < alone[1] == its, (alone, its)
    z = _cat(ranks, "ii_z")
    npt.assert_allclose(z, z1.z.numpy(), atol=2e-4, rtol=1e-3)
    mesh = _jax_mesh2()
    cfg = qpth_tpu.SolverConfig(use_pallas=True)
    zj = np.asarray(jax.jit(lambda *a: jax_solve_qp_sharded(
        *a, mesh=mesh, config=cfg))(
            *[jnp.asarray(a, jnp.float32) for a in args]))
    npt.assert_allclose(z, zj, atol=2e-4, rtol=1e-3)
    z64 = qt.solve_qp(*_torch(args), device="cpu").numpy()
    err_port, err_ref = np.abs(z - z64).max(), np.abs(zj - z64).max()
    assert err_port <= 2.0 * err_ref + 1e-5, (err_port, err_ref)


def test_sharded_f32_window_exit_reduces_over_the_group(ranks):
    """(ii') float32 substitution mode scores every iterate, so each lane's
    not-improved window closes on float32 noise before the score reaches
    eps and the all-lanes-done test alone ends the loop. Each rank's lanes
    run as in the port's solve of those lanes alone, which end at different
    iterations; both ranks end at the later one. (The 16-lane solve is no
    yardstick for the count here: its float32 noise differs with the batch
    size, and so does where its windows close.) z against the 16-lane
    solve at tests/test_torch_qp_f32.py's float32 tolerance."""
    args = W.sharding_args(False)
    cfg = qt.SolverConfig(solve_method="subst")
    alone = [int(qt.solve_qp_full(
        *_torch(W.local(args, W.RANKS6, r, 2, W.B1), torch.float32),
        config=cfg, device="cpu").stats.iterations) for r in range(2)]
    assert alone[0] != alone[1], alone
    assert [int(res["iiw_its"]) for res in ranks] == [max(alone)] * 2, alone
    z1 = qt.solve_qp(*_torch(args, torch.float32), config=cfg, device="cpu")
    npt.assert_allclose(_cat(ranks, "iiw_z"), z1.numpy(), atol=2e-4,
                        rtol=1e-3)


def test_sharded_gradients_match_jax(ranks):
    """(iii) gradients of sum(z^2) to the batched p and to the shared h, Q
    and G (summed over the ranks in the backward) against ``jax.grad`` of
    the JAX package's sharded solve, 1e-8."""
    args = W.sharding_args(False)
    ja = [None if a is None else jnp.asarray(a) for a in args]
    mesh = _jax_mesh2()

    def loss(Q, p, G, h):
        z = jax_solve_qp_sharded(Q, p, G, h, ja[4], ja[5], mesh=mesh)
        return jnp.sum(z ** 2)

    gQ, gp, gG, gh = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*ja[:4])
    npt.assert_allclose(_cat(ranks, "iii_dp"), np.asarray(gp), atol=1e-8,
                        rtol=1e-8)
    for res in ranks:
        for name, want in (("Q", gQ), ("G", gG), ("h", gh)):
            npt.assert_allclose(res[f"iii_d{name}"], np.asarray(want),
                                atol=1e-8, rtol=1e-8, err_msg=name)


@pytest.mark.parametrize("tier", ["diag", "band"])
def test_structured_tiers_with_the_group(ranks, tier):
    """(iv) the diagonal and banded tiers with ``process_group`` set, their
    exit tests reduced over the group, against the port unsharded, 1e-9."""
    if tier == "diag":
        want = qt.solve_qp_diag(*_torch(W.diag_args()), device="cpu")
    else:
        want = qt.solve_qp_banded(*_torch(W.banded_args()), device="cpu")
    npt.assert_allclose(_cat(ranks, f"iv_{tier}_z"), want.numpy(),
                        atol=1e-9, rtol=1e-9)


def test_mixed_batch_ruiz_norms_reduce_over_the_group(ranks):
    """(v) shared Q with batched G in float32: the batch-collapsed Ruiz
    norms are maxima over the global batch, so the sharded solve equals the
    unsharded one (1e-6 / 1e-5)."""
    want = qt.solve_qp(*_torch(W.mixed_args(), torch.float32),
                       config=qt.SolverConfig(max_iter=8), device="cpu")
    npt.assert_allclose(_cat(ranks, "v_z"), want.numpy(), atol=1e-6,
                        rtol=1e-5)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_collective_count_and_shapes(ranks, dt):
    """(v') every collective of a sharded solve with shared matrices under
    the default config: the entry check of the batch sizes, one
    ``all_reduce`` per IPM iteration (the packed exit test) and the
    post-loop INACC check, each of at most a few scalars; no
    ``broadcast`` and nothing batch-shaped."""
    dtype = torch.float64 if dt == "f64" else torch.float32
    its = int(qt.solve_qp_full(*_torch(W.sharding_args(False), dtype),
                               device="cpu").stats.iterations)
    for res in ranks:
        kinds, numels = res[f"vp_{dt}_kinds"], res[f"vp_{dt}_numels"]
        assert list(kinds) == ["all_reduce"] * (its + 2), kinds
        assert numels[0] == 2 and numels[-1] == 1
        assert all(n <= 4 for n in numels), numels


def test_uneven_batch_and_startup_helpers(ranks):
    """(vi) shards of 8 and 6 lanes raise on both ranks; the batch slices
    and shares of a group of 2; in one process ``init_multihost`` without
    arguments or environment is a no-op and the slice is the batch."""
    for res in ranks:
        assert "not divisible" in str(res["vi_uneven"])
        assert "not divisible" in str(res["vi_slice9"])
        assert int(res["vi_world"]) == 2
    assert list(ranks[0]["vi_slice"]) == [0, 5]
    assert list(ranks[1]["vi_slice"]) == [5, 10]
    assert list(ranks[1]["vi_shard"]) == [5, 6, 7, 8, 9]
    assert init_multihost() is None
    assert not torch.distributed.is_initialized()
    assert local_batch_slice(10) == slice(0, 10)


def _exported(path):
    """The names a package's ``__init__`` binds: its imports and top-level
    assignments."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def test_exports_cover_the_jax_package():
    """Every name the JAX package's ``__init__`` and ``parallel/__init__``
    export has a counterpart in the port, and ``__version__`` is the
    same."""
    from pathlib import Path

    import qpth_tpu_torch.parallel as tpar

    ref = Path(qpth_tpu.__file__).parent
    top = _exported(ref / "__init__.py")
    par = _exported(ref / "parallel" / "__init__.py")
    assert {"parallel", "profiling", "__version__", "solve_qp"} <= top
    assert [n for n in sorted(top) if not hasattr(qt, n)] == []
    assert [n for n in sorted(par) if not hasattr(tpar, n)] == []
    assert qt.__version__ == qpth_tpu.__version__
