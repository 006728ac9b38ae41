"""Cells cut to a size that a CPU test run can hold."""

from __future__ import annotations

import time

from bench.harness import runner, spec

#: the configurations' sizes for CPU tests
SMALL_CONFIG = {
    "collab": {"graphs": 120, "mean_vertices": 24, "min_vertices": 8,
               "max_vertices": 40, "mean_edges": 90, "max_edges": 400},
}
SMALL_TRAFFIC = {
    "batch": {"slice": 16, "warm_graphs": 4},
}
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


def cell(name: str) -> spec.Cell:
    """The cell at the small sizes."""
    c = spec.load_cell(name)
    c.config["params"].update(SMALL_CONFIG[c.config["generator"]])
    c.traffic["params"].update(SMALL_TRAFFIC[c.traffic["driver"]])
    return c


def run(name: str, seed: int = 2**31 + 7, seconds: float = 1.0,
        traced: bool = False) -> dict:
    """One run of the small cell on the CPU; the result line as a dict."""
    return runner.run_cell(name, seed, seconds, traced,
                           t_start=time.perf_counter(), device="cpu",
                           cell=cell(name), require_chips=False,
                           log=lambda msg: None)
