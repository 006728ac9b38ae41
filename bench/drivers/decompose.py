"""One-shot decomposition of one large graph, whole, from its edge rows.

Closed loop, one client.  Each step calls ``truss_pkt`` on the whole graph
with its default arguments (the kernel executors, the coreness reorder,
the default compaction) and gets the trussness of every row back, aligned
to that step's rows.  The rows come in one of ``orders`` seeded orders,
made in set-up and taken in turn, so nothing keyed on the input carries
over from one step to the next.  Every step is a bench span
``decompose.step``.  A step that raises ends the run with its error: every
step decomposes the same graph, so the next would raise alike (a program
that refuses the graph fails at once).

Set-up makes the graph and warms up with one ``truss_pkt`` of a graph of
``warm_scale`` from the same generator.  The check decides the graph once
with the plain reference, after the window, and compares every step's
answer with it row for row through that step's order.

Parameters: ``orders`` (row orders cycled), ``warm_scale`` (the warm-up
graph's scale).
"""

from __future__ import annotations

import types

import numpy as np

from bench.harness import compare, spec
from bench.harness.loops import closed_loop


def setup(run):
    """Make the graph and its row orders; decompose a smaller graph once."""
    from repro_torch.core.pkt import truss_pkt

    params = run.cell.config["params"]
    gen = spec.generator(run.cell.config)
    data = gen.make(params, run.seed)
    rows = data["rows"]
    rng = np.random.default_rng([run.seed, 1])
    orders = [rng.permutation(rows.shape[0])
              for _ in range(int(run.params["orders"]))]
    warm = gen.make(dict(params, scale=int(run.params["warm_scale"])),
                    run.seed)["rows"]
    with run.tracer.span("warm_up"):
        truss_pkt(warm, device=run.device)
    return types.SimpleNamespace(
        edges=data["graphs"][0], orders=orders,
        inputs=[rows[o] for o in orders], returned=[])


def window(run, state) -> None:
    """Decompose the whole graph back to back for ``run.seconds``."""
    from repro_torch.core.pkt import truss_pkt

    def step(i):
        k = i % len(state.inputs)
        with run.tracer.span("decompose.step"):
            out = truss_pkt(state.inputs[k], device=run.device)
        state.returned.append((k, out))
        return True

    closed_loop(run, step)
    run.records["graphs_returned"] = len(state.returned)
    steps = [round(d, 3) for d in run.tracer.durations("decompose.step")]
    run.log(f"[bench] steps: {steps} s")


def finish(run, state):
    """The graph, the row orders and every answer."""
    return {"edges": state.edges, "orders": state.orders,
            "returned": state.returned}


def check(run, outputs) -> dict:
    """Every answer against the plain reference's trussness of the graph,
    row for row through its step's order."""
    ref = spec.reference(run.cell.config)
    truth = ref.decompose(outputs["edges"], run.device)
    run.log(f"[bench] graph: {truth.m} edges, "
            f"{int(np.unique(outputs['edges']).size)} vertices with an edge,"
            f" {truth.triangles} triangles, max trussness "
            f"{int(truth.trussness.max(initial=0))}")
    tally = compare.Tally()
    for k, out in outputs["returned"]:
        tally.rows(out, truth.trussness[outputs["orders"][k]])
    return tally.compared()
