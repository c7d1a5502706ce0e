"""The result line: only the contract's keys, the compared numbers last,
plain JSON; no result without a card or with JAX loaded."""

import json
import subprocess
import sys

import pytest

from qpbench import harness, run
from qpbench.tests.conftest import CELLS, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_keys(name, traced):
    cell, config = tiny(name)
    result = harness.run(cell, config, seed=2 ** 31 + 3, seconds=0.1,
                         traced=traced, device="cpu")
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == want
    line = json.dumps(run._finite(result), allow_nan=False)
    assert json.loads(line)["correct"] is True
    kind = "per_layer" if traced else "end_to_end"
    names = {m.NAME for m in harness.metric_modules() if m.KIND == kind}
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in result["device"]
        assert "window_s" in result["device"]
    else:
        assert {"qps", "call_p95_ms", "setup_s"} <= set(result["metrics"])


def test_non_finite_prints_as_null():
    assert run._finite({"a": [float("inf"), 1.0], "b": float("nan")}) == {
        "a": [None, 1.0], "b": None}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "dense100.fwd", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "qpth_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "qpth_tpu.qp", object())
    assert harness.forbidden_modules() == ["jax", "qpth_tpu"]
