"""Find a cell's configuration, traffic, driver, metrics and reference by
the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in files of its own, found by name:

* ``configs/<config>.json`` is a configuration (``BENCHMARK.json`` names the
  file); its ``generator`` names ``gen/<generator>.py`` and its
  ``reference`` names ``reference/<reference>.py``;
* ``traffic/<traffic>.json`` is a traffic mix: parameters, and the
  ``driver`` (``drivers/<driver>.py``) that plays them;
* ``metrics/<metric name>.py`` reads one metric; a metric named
  ``<quantity>.<scope>`` with no file of its own is read by
  ``metrics/<quantity>.py``, which serves that quantity in every scope.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict             # the configuration's file
    traffic_name: str
    traffic: dict            # the traffic mix's file
    end_to_end: list         # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_module(path: pathlib.Path, name: str):
    """Import one file by path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    if name in sys.modules:
        return sys.modules[name]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict | None = None,
              root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``name``; KeyError when ``BENCHMARK.json`` lacks it."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def generator(config: dict):
    """The configuration's input generator module."""
    g = config["generator"]
    return load_module(BENCH / "gen" / f"{g}.py", f"bench_gen_{g}")


def reference(config: dict):
    """The configuration's plain reference module."""
    r = config["reference"]
    return load_module(BENCH / "reference" / f"{r}.py", f"bench_ref_{r}")


def driver(traffic: dict):
    """The traffic mix's driver module."""
    d = traffic["driver"]
    return load_module(BENCH / "drivers" / f"{d}.py", f"bench_driver_{d}")


def metric_reader(name: str):
    """The reader of one metric: ``read(run)`` of ``metrics/<name>.py``,
    or of ``metrics/<quantity>.py`` for ``<quantity>.<scope>``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        name = name.split(".")[0]
        path = BENCH / "metrics" / f"{name}.py"
    mod = load_module(path, "bench_metric_" + name.replace(".", "_")
                      .replace("-", "_"))
    return mod.read
