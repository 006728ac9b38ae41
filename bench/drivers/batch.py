"""Batch scoring of a collection of small graphs through the engine.

Closed loop, one client.  The client calls ``TrussEngine.map`` on
consecutive slices of ``slice`` graphs, taken in the seed's order from the
collection (wrapping around), with the engine's defaults, so that its
``max_pending`` auto-flushes inside each slice.  Every graph returned is
checked.

Parameters: ``slice`` (graphs per ``map`` call), ``warm_graphs`` (graphs
mapped once in set-up).
"""

from __future__ import annotations

import types


from bench.harness import compare, spec
from bench.harness.loops import closed_loop

#: engine counters read at the window's edges
STATS = ("graph_seconds", "graphs_done", "batches", "flushes")


def setup(run):
    """Make the collection, build the engine and map a few graphs."""
    from repro_torch.serve.truss_engine import TrussEngine

    data = spec.generator(run.cell.config).make(run.cell.config["params"],
                                                run.seed)
    graphs = data["graphs"]
    engine = TrussEngine(device=run.device)
    warm = int(run.params["warm_graphs"])
    with run.tracer.span("warm_up"):
        engine.map(graphs[:warm])
    return types.SimpleNamespace(graphs=graphs, engine=engine,
                                 next=warm % len(graphs), returned=[])


def window(run, state) -> None:
    """Map slices back to back for ``run.seconds``."""
    size = int(run.params["slice"])
    g = len(state.graphs)
    eng = state.engine
    before = {k: eng.stats[k] for k in STATS}

    def step(i):
        idx = [(state.next + j) % g for j in range(size)]
        state.next = (state.next + size) % g
        try:
            with run.tracer.span("engine.map"):
                out = eng.map([state.graphs[k] for k in idx])
        except Exception as e:                  # noqa: BLE001 — counted
            run.error(repr(e))
            state.returned.extend((k, None) for k in idx)
            return False
        state.returned.extend(zip(idx, out))
        return True

    closed_loop(run, step)
    run.records["engine"] = {k: eng.stats[k] - before[k] for k in STATS}
    run.records["graphs_returned"] = sum(
        1 for _, out in state.returned if out is not None)


def finish(run, state):
    """The graphs and every answer; the engine is dropped."""
    state.engine = None
    return {"graphs": state.graphs, "returned": state.returned}


def check(run, outputs) -> dict:
    """Every graph returned against the plain reference, each distinct
    graph decided once."""
    graphs, returned = outputs["graphs"], outputs["returned"]
    distinct = sorted({k for k, _ in returned})
    ref = spec.reference(run.cell.config)
    truths = dict(zip(distinct, ref.decompose_many(
        [graphs[k] for k in distinct], run.device)))
    tally = compare.Tally()
    for k, out in returned:
        tally.rows(out, truths[k])
    return tally.compared()
