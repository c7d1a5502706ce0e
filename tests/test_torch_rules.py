"""Ground rules of the PyTorch port (``qpth_tpu_torch``):

* it imports neither JAX nor ``qpth_tpu`` (nor does ``chip_smoke.py``),
  and it solves in a process where JAX cannot be imported;
* its entry points run on CUDA unless asked for the CPU: without CUDA they
  raise instead of falling back;
* on the CPU the kernel wrappers take their plain versions and count no
  launch;
* every branch not ported yet raises ``NotImplementedError``."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch.ops import kkt as kkt_ops
from qpth_tpu_torch.ops.cuda import kernels

from conftest import make_feasible_qp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _banned(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "qpth_tpu" or name.startswith("qpth_tpu."))


def test_port_imports_no_jax():
    files = sorted((REPO / "qpth_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _banned(n)]
            assert not bad, f"{f.relative_to(REPO)} imports {bad}"


def test_port_solves_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch, qpth_tpu_torch as qt\n"
        "r = np.random.RandomState(0)\n"
        "L = r.rand(8, 6, 6); Q = L @ L.transpose(0, 2, 1) + np.eye(6)\n"
        "G = r.randn(8, 5, 6); h = r.rand(8, 5) + 1.0; p = r.randn(8, 6)\n"
        "z = qt.solve_qp(*(torch.tensor(v) for v in (Q, p, G, h)),\n"
        "                config=qt.SolverConfig(solve_method='inverse',\n"
        "                                       resid_every=7), device='cpu')\n"
        "assert z.shape == (8, 6) and bool(torch.isfinite(z).all())\n"
        "assert not [m for m in sys.modules\n"
        "            if m == 'qpth_tpu' or m.startswith('qpth_tpu.')]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _qp(dtype=torch.float32, B=8, nz=6, nineq=5):
    Q, p, G, h, _, _ = make_feasible_qp(np.random.RandomState(4), nz=nz,
                                        nineq=nineq, nbatch=B)
    return [torch.tensor(v, dtype=dtype) for v in (Q, p, G, h)]


@pytest.mark.parametrize("entry", ["solve_qp", "solve_qp_full",
                                   "prefactor_qp", "QPFunction"])
def test_no_silent_cpu_fallback(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Q, p, G, h = _qp()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "prefactor_qp":
            qt.prefactor_qp(Q, G)
        elif entry == "QPFunction":
            qt.QPFunction()(Q, p, G, h)
        else:
            getattr(qt, entry)(Q, p, G, h)


def test_cpu_solve_counts_no_launch():
    kernels.reset_launches()
    Q, p, G, h = _qp()
    z = qt.QPFunction(device="cpu")(Q, p, G, h)
    assert torch.isfinite(z).all()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    npt.assert_array_equal(
        z.numpy(), qt.solve_qp(Q, p, G, h, device="cpu").numpy())


def test_kernel_fit_predicate():
    """One QP's two m x m tiles and 8 m-vectors within 227 KB of shared
    memory per block."""
    assert kernels.fits(168, torch.float32)
    assert not kernels.fits(169, torch.float32)
    assert kernels.fits(118, torch.float64)
    assert not kernels.fits(119, torch.float64)


F32 = qt.SolverConfig()
CASES = {
    "equality_constraints": dict(eq=True),
    "nineq_zero": dict(no_ineq=True),
    "kkt_full": dict(config=qt.SolverConfig(kkt_solver=qt.KKTSolver.FULL)),
    "kkt_ir": dict(config=qt.SolverConfig(kkt_solver=qt.KKTSolver.IR)),
    "cpu_oracle": dict(config=qt.SolverConfig(
        solver=qt.QPSolvers.CPU_ORACLE)),
    "subst": dict(config=qt.SolverConfig(solve_method="subst")),
    "f64_default": dict(dtype=torch.float64),
    "resid_every_1": dict(config=qt.SolverConfig(resid_every=1)),
    "coeff_x_false": dict(config=qt.SolverConfig(coeff_x=False)),
    "refine_steps": dict(config=qt.SolverConfig(refine_steps=2)),
    "refine_auto_eps": dict(config=qt.SolverConfig(eps=1e-8)),
    "escalate": dict(config=qt.SolverConfig(escalate="oracle")),
    "warm_start": dict(init=True),
    "verbose": dict(config=qt.SolverConfig(verbose=1)),
    "beyond_fit": dict(fit=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unported_branch_raises(case):
    spec = CASES[case]
    if spec.get("fit"):
        # The shared-memory fit is checked on CUDA only; the predicate is
        # device-independent, so ask for the CUDA backend directly.
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            kkt_ops.resolve_backend(torch.float32, 200, "cuda")
        return
    Q, p, G, h = _qp(spec.get("dtype", torch.float32))
    kw = dict(config=spec.get("config", F32), device="cpu")
    A = b = None
    if spec.get("eq"):
        A, b = torch.ones(1, 6), torch.zeros(1)
    if spec.get("no_ineq"):
        G = h = None
    if spec.get("init"):
        kw["init"] = (torch.zeros(8, 6), torch.ones(8, 5), torch.ones(8, 5),
                      None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        qt.solve_qp_full(Q, p, G, h, A, b, **kw)


def test_config_matches_jax_fields():
    """SolverConfig keeps every JAX field but the two TPU-only ones, with
    the same defaults."""
    import qpth_tpu

    jf = {f.name: f.default for f in dataclasses.fields(qpth_tpu.SolverConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(qt.SolverConfig)}
    assert set(jf) - set(tf) == {"use_pallas", "axis_name"}
    assert set(tf) <= set(jf)
    for k, v in tf.items():
        if k not in ("kkt_solver", "solver"):
            assert jf[k] == v, k
