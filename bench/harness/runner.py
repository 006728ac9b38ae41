"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

The order is the contract's: everything before the window counts as
set-up; the window runs the cell's traffic for ``--seconds``; then the
device's memory peak is read, the program's state is freed, and only then
does the reference run, so that it neither sets the peak nor counts in
``setup_s``.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time
import traceback

import torch

from bench.harness import compare, spec, trace

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class NoChip(RuntimeError):
    """The machine lacks the cards that the cell asks for."""


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


@dataclasses.dataclass
class Run:
    """What one run knows: its cell and arguments, and what it recorded."""

    cell: spec.Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    tracer: trace.Tracer
    setup_s: float = math.nan
    window_s: float = math.nan          # start to the end of the last step
    records: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: dict | None = None           # trace.device_summary
    compared: dict = dataclasses.field(default_factory=dict)
    log: object = print

    def error(self, what: str) -> None:
        """Record a failed step and print its traceback (the first few)."""
        errors = self.records.setdefault("errors", [])
        errors.append(what)
        if len(errors) <= 3:
            self.log(f"[bench] step failed:\n{traceback.format_exc()}")

    @property
    def params(self) -> dict:
        """The traffic mix's parameters."""
        return self.cell.traffic.get("params", {})


def check_chips(chips: int) -> None:
    """Raise :class:`NoChip` unless ``chips`` cards are visible."""
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} visible")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device="cuda", cell: spec.Cell | None = None,
             require_chips: bool = True, log=None) -> dict:
    """Run one cell once and return its result line as a dict.

    ``t_start`` is the host clock at the start of the process; set-up is
    counted from there.  Tests pass ``device="cpu"``, a ``cell`` cut to a
    small size and ``require_chips=False``.
    """
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.load_cell(name) if cell is None else cell
    if require_chips:
        check_chips(cell.chips)
    dev = torch.device(device)
    run = Run(cell=cell, seed=int(seed) % (1 << 63), seconds=float(seconds),
              traced=bool(traced), device=dev,
              tracer=trace.Tracer(bool(traced), dev), log=log)
    drv = spec.driver(cell.traffic)

    state = drv.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.setup_s = time.perf_counter() - t_start
    log(f"[bench] {name}: set-up {run.setup_s:.3f} s; window "
        f"{run.seconds} s, trace {int(run.traced)}")

    run.tracer.start()
    drv.window(run, state)
    run.tracer.stop()
    log(f"[bench] {name}: window {run.window_s:.3f} s, "
        f"{run.attempted} attempted, {run.failed} failed")

    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    run.trace = trace.device_summary(run.tracer)
    outputs = drv.finish(run, state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    run.compared = drv.check(run, outputs)
    log(f"[bench] {name}: reference check {time.perf_counter() - t_ref:.3f}"
        f" s")
    del outputs

    metrics = {}
    for m in (cell.per_layer if run.traced else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    correct = (run.failed == 0 and bool(run.compared) and all(
        compare.holds(c) for c in run.compared.values()))
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        device_info = {"platform": "gpu", "kind": kind,
                       "count": cell.chips}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    device_info["memory_peak_bytes"] = run.memory_peak_bytes
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if run.traced and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    if dev.type == "cuda":
        result["card"] = power_limit()

    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in this process: {', '.join(found)}")
    result["compared"] = run.compared
    return result
