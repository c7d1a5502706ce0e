"""The harness is driven by its files: ``BENCHMARK.json`` agrees with the
cell, configuration and metric files, and a cell added as a new file runs
without an edit to any file already there."""

import json
import shutil

import pytest

from qpbench import harness
from qpbench.tests.conftest import tiny

ROOT = harness.BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = {m.NAME: m for m in harness.metric_modules()}


@pytest.mark.parametrize("w", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_workload_matches_cell_file(w):
    cell, config = harness.load_cell(w["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == w[key], key
    assert config["name"] == w["config"]
    assert cell["limits"] and set(cell["limits"]) <= set(
        cell_numbers(cell, config))


def cell_numbers(cell, config):
    """The numbers the comparison reads in a cell (``check`` docstring)."""
    stats = ("med", "p99", "rms", "max")
    names = [f"z_{s}" for s in stats]
    shared = set(cell["shared"])
    for g in cell["grads"]:
        names += [g] if g in shared else [f"{g}_{s}" for s in stats]
    return names


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_file(c):
    config = json.loads((ROOT / c["file"]).read_text())
    assert config["name"] == c["name"]
    assert config["source"] == c["source"]
    assert config["reduced"] == c["reduced"]
    assert c["file"] == f"qpbench/configs/{c['name']}.json"


@pytest.mark.parametrize("m", BENCHMARK["end_to_end"] + BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_matches_file(m):
    mod = METRICS[m["name"]]
    kind = "end_to_end" if m in BENCHMARK["end_to_end"] else "per_layer"
    assert mod.KIND == kind
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"],
                                                  m["source"])
    if kind == "per_layer":
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert not hasattr(mod, "WORKLOADS")


def test_backward_share_only_in_train_cells():
    """No metric file names a cell: ``backward.share`` reads the spans
    that only a forward+backward cell records, and BENCHMARK.json lists
    exactly those cells for it."""
    mod = METRICS["backward.share"]
    assert mod.read({"trace": {"wall_s": 0, "backward_s": 0}}) is None
    assert mod.read({"trace": {"wall_s": 2.0, "backward_s": 0.5}}) == 25.0
    entry = next(m for m in BENCHMARK["per_layer"]
                 if m["name"] == "backward.share")
    train = [w["name"] for w in BENCHMARK["workloads"]
             if harness.load_cell(w["name"])[0]["mode"] == "train"]
    assert entry["workloads"] == train


@pytest.mark.parametrize("name", ["dense100.fwd", "dense100.optnet_train"])
def test_backward_share_absent_without_spans(name):
    """A traced run that records no spans (a forward cell; any run on the
    CPU, where the spans' synchronize has no card) leaves the metric
    out."""
    cell, config = tiny(name)
    result = harness.run(cell, config, seed=9, seconds=0.1, traced=True,
                         device="cpu")
    assert "backward.share" not in result["metrics"]
    assert "ipm.iterations" in result["metrics"]


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCHMARK["end_to_end"]
              + BENCHMARK["per_layer"]}
    assert set(METRICS) == listed


def test_new_cell_file_is_found(tmp_path, monkeypatch):
    """A cell that exists only as a new file in a copy of the benchmark's
    folder is found and runs; no file that was there changes."""
    copy = tmp_path / "qpbench"
    shutil.copytree(harness.BENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cell, config = tiny("dense100.fwd")
    new = {k: v for k, v in cell.items() if k != "name"}
    new.update(config="qpth_dense8", traffic="fwd_b6_new",
               why="a cell added as a file")
    (copy / "configs" / "qpth_dense8.json").write_text(json.dumps(
        dict(config, name="qpth_dense8")))
    (copy / "workloads" / "dense100.new_cell.json").write_text(
        json.dumps(new))
    monkeypatch.setattr(harness, "BENCH", copy)
    cell2, config2 = harness.load_cell("dense100.new_cell")
    assert cell2["traffic"] == "fwd_b6_new" and config2["nz"] == 8
    result = harness.run(cell2, config2, seed=1, seconds=0.1, traced=False,
                         device="cpu")
    assert result["correct"] and result["attempted"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
