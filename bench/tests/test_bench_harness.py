"""The harness finds everything by name and prints the contract's line."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from bench.harness import spec
from bench.tests import small

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def test_every_config_traffic_driver_metric_and_reference_loads():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(cfg["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        spec.generator(cfg).make
        spec.reference(cfg).decompose
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        drv = spec.driver(cell.traffic)
        for fn in ("setup", "window", "finish", "check"):
            assert callable(getattr(drv, fn))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_scoped_metric_without_a_file_reads_its_quantity():
    # device_idle.<scope> has no file of its own: device_idle.py reads it
    assert not (BENCH / "metrics" / "device_idle.anycell.py").exists()
    assert (spec.metric_reader("device_idle.anycell")
            is spec.metric_reader("device_idle.batch"))
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.batch")


def test_contract_shape_of_benchmark_json():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(traced):
    r = small.run("collab.batch", traced=traced)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0
    names = set(r["metrics"])
    if traced:
        assert "breakdown" in r and "busy_s" in r["device"]
        assert "dispatch_s_per_graph.batch" in names
        # no device on the CPU: the device reader reads nothing, never 0
        assert "device_idle.batch" not in names
    else:
        assert names == {"graphs_per_s", "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0
    json.dumps(r)


@pytest.mark.parametrize("name", small.CELLS)
def test_every_cell_runs_correct_on_the_cpu(name):
    r = small.run(name, seconds=1.0)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_run_without_a_card_exits_3_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "collab.batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 3 and out.stdout == ""


def test_run_without_the_program_exits_4_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "collab.batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_loading_jax_in_the_run_refuses_the_result(monkeypatch):
    from bench.harness import runner
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    with pytest.raises(runner.Forbidden):
        small.run("collab.batch")
