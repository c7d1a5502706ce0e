"""Ground rules of the PyTorch port (``qpth_tpu_torch``):

* it imports neither JAX nor ``qpth_tpu`` (nor does ``chip_smoke.py``),
  and it solves in a process where JAX cannot be imported;
* its entry points run on CUDA unless asked for the CPU: without CUDA they
  raise instead of falling back;
* on the CPU the kernel wrappers take their plain versions and count no
  launch;
* every branch not ported yet raises ``NotImplementedError``, and the
  branches ported since run and match the JAX package."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import qpth_tpu_torch as qt
from qpth_tpu_torch.ops import hybrid
from qpth_tpu_torch.ops import kkt as kkt_ops
from qpth_tpu_torch.ops.cuda import kernels

from conftest import make_feasible_qp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _banned(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "qpth_tpu" or name.startswith("qpth_tpu."))


#: The modules of the last slice, which the scans below must cover.
NEW_MODULES = ("profiling.py", "parallel/__init__.py", "parallel/sharding.py",
               "parallel/multihost.py", "parallel/intra.py",
               "native/__init__.py")


def test_port_imports_no_jax():
    files = sorted((REPO / "qpth_tpu_torch").rglob("*.py"))
    for rel in NEW_MODULES:
        assert REPO / "qpth_tpu_torch" / rel in files, rel
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "examples").glob("torch_*.py"))
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


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_names_no_path_inside_the_jax_package():
    """No file of the port reads from the JAX package's tree: no string in
    the port's code names a path inside ``qpth_tpu/``, no C++ or CUDA
    source includes one, and the native oracle's source (a copy) names
    none at all."""
    import re

    inside = re.compile(r"(?<![\w.])qpth_tpu(?:[/\\]|$)")
    for f in sorted((REPO / "qpth_tpu_torch").rglob("*.py")):
        for text in _code_strings(ast.parse(f.read_text(), str(f))):
            assert not inside.search(text), (f.relative_to(REPO), text)
    for f in sorted((REPO / "qpth_tpu_torch").rglob("*")):
        if f.suffix not in (".cpp", ".cu", ".cuh", ".h"):
            continue
        for line in f.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not inside.search(line), (f.relative_to(REPO), line)
    src = (REPO / "qpth_tpu_torch" / "native" / "qp_oracle.cpp").read_text()
    assert not inside.search(src)
    # Nor any absolute path of the machine it was copied on.
    assert not re.search(r"(?:^|[\s(`'\"])/[A-Za-z_]+/", src, re.M)


def test_no_raise_names_a_roadmap_item():
    """Every ROADMAP item is ported: no ``NotImplementedError`` of the port
    names one."""
    import re

    for f in sorted((REPO / "qpth_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            call = node.exc
            name = getattr(getattr(call, "func", None), "id", None)
            if name != "NotImplementedError":
                continue
            text = " ".join(_code_strings(call))
            assert not re.search(r"item \d|ROADMAP", text), (
                f.relative_to(REPO), text)


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


def _diag_args():
    r = np.random.RandomState(5)
    return [torch.tensor(v) for v in (
        np.full(6, 0.5), r.randn(4, 6), np.full(6, -1.0), np.ones(6),
        r.rand(2, 6), r.rand(2))]


@pytest.mark.parametrize("entry", ["solve_qp_diag", "solve_qp_diag_full",
                                   "SpQPFunction", "OptNetSudoku",
                                   "OptNetClassifier"])
def test_no_silent_cpu_fallback_slice3(entry, monkeypatch):
    """The diagonal tier, SpQPFunction and the layers raise without CUDA
    unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "SpQPFunction":
            ii = np.stack([np.arange(3), np.arange(3)])
            f = qt.SpQPFunction(ii, (3, 3), ii, (3, 3),
                                np.zeros((2, 0), int), (0, 3))
            f(*(torch.ones(2, 3) for _ in range(4)), torch.ones(2, 0),
              torch.ones(2, 0))
        elif entry == "OptNetSudoku":
            qt.nn.OptNetSudoku()
        elif entry == "OptNetClassifier":
            qt.nn.OptNetClassifier(4, 4, 2)
        else:
            getattr(qt, entry)(*_diag_args())
    # ... and solve there when asked for the CPU.
    kernels.reset_launches()
    z = qt.solve_qp_diag(*_diag_args(), device="cpu")
    assert bool(torch.isfinite(z).all())
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_cpu_solve_counts_no_launch():
    kernels.reset_launches()
    Q, p, G, h = _qp()
    z = qt.QPFunction(device="cpu")(Q, p, G, h)
    assert torch.isfinite(z).all()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    npt.assert_array_equal(
        z.numpy(), qt.solve_qp(Q, p, G, h, device="cpu").numpy())


def test_kernel_fit_predicate():
    """One QP's m x m tile, 8 m-vectors and the 8 words of the block
    reductions' static scratch within 227 KB of shared memory per block;
    the fused steps with the direct x update add one nz-vector and, with
    equality constraints, 4 neq-vectors."""
    # float32: 58112 words; 237^2 + 8 * 237 + 8 = 58073,
    # 238^2 + 8 * 238 + 8 = 58556.
    assert kernels.fits(237, torch.float32)
    assert not kernels.fits(238, torch.float32)
    # float64: 29056 words; 166^2 + 8 * 166 + 8 = 28892,
    # 167^2 + 8 * 167 + 8 = 29233.
    assert kernels.fits(166, torch.float64)
    assert not kernels.fits(167, torch.float64)
    # float32 at m = 237 leaves 58112 - 58073 = 39 words: nz + 4 neq <= 39.
    assert kernels.fits(237, torch.float32, nz=39)
    assert not kernels.fits(237, torch.float32, nz=40)
    assert kernels.fits(237, torch.float32, nz=7, neq=8)
    assert not kernels.fits(237, torch.float32, nz=8, neq=8)
    # float64 at m = 166 leaves 29056 - 28892 = 164 words.
    assert kernels.fits(166, torch.float64, nz=100, neq=16)
    assert not kernels.fits(166, torch.float64, nz=101, neq=16)
    assert kernels.fits(100, torch.float64, nz=100, neq=50)
    # m is bound by the thread count whatever the bytes.
    assert not kernels.fits(257, torch.float32) and kernels.THREADS == 256


def test_fused_step_supported_follows_device():
    """The solver asks the per-kernel fit on CUDA only; the plain versions
    on the CPU take any size."""
    assert kkt_ops.fused_step_supported("cpu", torch.float32, 500, 500, 9)
    assert kkt_ops.fused_step_supported("cuda", torch.float32, 237)
    assert kkt_ops.fused_step_supported("cuda", torch.float32, 237, 39)
    assert not kkt_ops.fused_step_supported("cuda", torch.float32, 237, 40)
    assert not kkt_ops.fused_step_supported("cuda", torch.float32, 238)


@pytest.mark.parametrize("m", [169, 200, 237])
def test_kernels_backend_takes_widths_of_one_tile(m):
    """Widths between the old two-tile fit (168) and the one-tile fit (237)
    route to the kernels backend and the fused steps on CUDA in float32,
    not to the hybrid backend."""
    backend = kkt_ops.resolve_backend("auto", torch.float32, m, "cuda")
    assert backend.fused_step is not None
    assert kkt_ops.fused_step_supported("cuda", torch.float32, m)


CASES = {
    "kkt_full": dict(config=qt.SolverConfig(kkt_solver=qt.KKTSolver.FULL)),
    "kkt_ir": dict(config=qt.SolverConfig(kkt_solver=qt.KKTSolver.IR)),
    "cpu_oracle": dict(config=qt.SolverConfig(
        solver=qt.QPSolvers.CPU_ORACLE)),
    "refine_steps": dict(config=qt.SolverConfig(refine_steps=2)),
    "refine_auto_eps": dict(config=qt.SolverConfig(eps=1e-8)),
    "escalate": dict(config=qt.SolverConfig(escalate="oracle")),
    "verbose": dict(config=qt.SolverConfig(verbose=1)),
    "beyond_fit": dict(fit=True),
    "hybrid_xla": dict(config=qt.SolverConfig(use_pallas="hybrid_xla")),
}


def _jax_config(cfg):
    """The JAX package's SolverConfig with ``cfg``'s values."""
    import qpth_tpu

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "process_group"}
    kw["kkt_solver"] = qpth_tpu.KKTSolver[cfg.kkt_solver.name]
    kw["solver"] = qpth_tpu.QPSolvers(cfg.solver.value)
    return qpth_tpu.SolverConfig(**kw)


def _matches_jax(Q, p, G, h, config, z):
    """z is finite and within 1e-8 of the JAX package's float64 solve."""
    import jax.numpy as jnp
    import qpth_tpu

    want = qpth_tpu.solve_qp_full(*(jnp.asarray(v.numpy()) for v in
                                    (Q, p, G, h)),
                                  config=_jax_config(config)).z
    assert bool(torch.isfinite(z).all())
    npt.assert_allclose(z.numpy(), np.asarray(want), rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", list(CASES))
def test_unported_branch_raises(case):
    """Branches that raised ``NotImplementedError`` until their ROADMAP item
    was ported (items 9, 11, 12, 14, 13, 22) now run: each case solves to a
    finite solution equal to the JAX package's (float64, 1e-8).
    ``beyond_fit`` (item 13): past kernel A's fit "auto" takes the hybrid
    backend instead of raising. ``hybrid_xla`` (item 22) runs the hybrid
    backend; in float64 substitution mode the JAX package's value fails
    (ROADMAP.md §3), so its yardstick there is the JAX package's
    ``"hybrid"`` (its XLA backend at float64)."""
    spec = CASES[case]
    if spec.get("fit"):
        # The shared-memory fit is checked on CUDA only; the predicate is
        # device-independent, so ask for the CUDA backend directly.
        be = kkt_ops.resolve_backend("auto", torch.float32, 238, "cuda")
        assert be.fused_step is None and be.solve2 is hybrid.solve_hybrid
        return
    Q, p, G, h = _qp(torch.float64)
    sol = qt.solve_qp_full(Q, p, G, h, config=spec["config"], device="cpu")
    ref = spec["config"]
    if case == "hybrid_xla":
        ref = dataclasses.replace(ref, use_pallas="hybrid")
    _matches_jax(Q, p, G, h, ref, sol.z)


def test_config_matches_jax_fields():
    """SolverConfig keeps every JAX field, with the same defaults, but the
    shard_map axis (``axis_name``), whose counterpart is the
    ``torch.distributed`` group (``process_group``, None by default as
    ``axis_name`` is)."""
    import qpth_tpu

    jf = {f.name: f.default for f in dataclasses.fields(qpth_tpu.SolverConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(qt.SolverConfig)}
    assert set(jf) - set(tf) == {"axis_name"}
    assert set(tf) - set(jf) == {"process_group"}
    assert jf["axis_name"] is None and tf["process_group"] is None
    for k, v in tf.items():
        if k not in ("kkt_solver", "solver", "process_group"):
            assert jf[k] == v, k


def _params(fn):
    """(name, kind) of each parameter, a trailing ``**kwargs`` apart."""
    ps = [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]
    var_kw = bool(ps) and ps[-1][1] == inspect.Parameter.VAR_KEYWORD
    return (ps[:-1] if var_kw else ps), var_kw


@pytest.mark.parametrize("entry", [
    "QPFunction", "solve_qp", "solve_qp_full", "solve_qp_eq", "prefactor_qp",
    "solve_qp_diag", "solve_qp_diag_full", "SpQPFunction.__init__",
    "solve_qp_banded", "solve_qp_banded_full"])
def test_public_signatures_match_jax(entry):
    """Each public entry point takes the JAX package's parameters by the
    same names, in the same order and of the same kinds; the port adds
    only a trailing ``device`` (before ``**kwargs``)."""
    import qpth_tpu

    def get(mod):
        obj = mod
        for part in entry.split("."):
            obj = getattr(obj, part)
        return obj

    ref, ref_kw = _params(get(qpth_tpu))
    port, port_kw = _params(get(qt))
    assert port[-1][0] == "device"
    assert port[:-1] == ref
    assert port_kw == ref_kw


@pytest.mark.parametrize("by", ["position", "keyword"])
def test_qpfunction_cpu_oracle_raises(by):
    """QPSolvers.CPU_ORACLE binds to ``solver`` by position as upstream
    qpth's factory takes it (it raised naming item 12 until the oracle was
    ported), and solves on the host: the JAX package's z to 1e-8."""
    Q, p, G, h = _qp(torch.float64)
    fn = (qt.QPFunction(1e-12, 0, 3, 20, qt.QPSolvers.CPU_ORACLE,
                        device="cpu") if by == "position" else
          qt.QPFunction(1e-12, 0, 3, 20, solver=qt.QPSolvers.CPU_ORACLE,
                        device="cpu"))
    _matches_jax(Q, p, G, h, qt.SolverConfig(solver=qt.QPSolvers.CPU_ORACLE),
                 fn(Q, p, G, h))
