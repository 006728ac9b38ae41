"""A live graph under edge toggles: one open handle, batches of its edges
deleted and put back, every trussness read after every batch.

Closed loop, one client.  Set-up makes the graph, opens it once as a live
handle (``TrussEngine.open(rows, insert_mode=..., local_frac=...)``, the
engine's other options its defaults), draws ``pools + 1`` disjoint seeded
pools of ``batch_edges`` edges each, uniform over the graph's edges, and
toggles the last pool once (delete, then insert back) on the same handle
as the warm-up.  In the window, step 2j deletes pool ``j mod pools`` and
step 2j + 1 inserts it back; each step is ``engine.update`` followed by
reading ``handle.trussness``, inside one bench span ``toggle.step``.  A
step that raises ends the window: it counts as failed and its answer as
missing.  One graph returned is one updated graph whose every trussness
came back.

The check decides ``pools + 1`` states with the plain reference after the
window (the graph, and the graph less each pool) and compares every
step's answer row for row with its state's truth: the handle's rows are
the state's edges in key order, as the generator lists them.  Answers are
kept as uint8 (asserted to fit), and one byte-equal to the last kept for
its state is kept as that one; every step still counts as an answer.

Parameters: ``batch_edges``, ``pools``, ``insert_mode``, ``local_frac``.
"""

from __future__ import annotations

import time
import types

import numpy as np

from bench.harness import compare, spec


def setup(run):
    """Make the graph and the pools, open the handle, toggle one pool."""
    from repro_torch.serve.truss_engine import TrussEngine

    data = spec.generator(run.cell.config).make(run.cell.config["params"],
                                                run.seed)
    E, rows = data["graphs"][0], data["rows"]
    p = run.params
    size, pools = int(p["batch_edges"]), int(p["pools"])
    rng = np.random.default_rng([run.seed, 2])
    picks = rng.choice(E.shape[0], size * (pools + 1), replace=False)
    picks = picks.reshape(pools + 1, size)
    engine = TrussEngine(device=run.device)
    with run.tracer.span("warm_up"):
        handle = engine.open(rows, insert_mode=p["insert_mode"],
                             local_frac=float(p["local_frac"]))
        warm = E[picks[-1]]
        engine.update(handle, remove_edges=warm)
        engine.update(handle, add_edges=warm)
        handle.trussness
    return types.SimpleNamespace(
        edges=E, picks=picks[:-1], engine=engine, handle=handle,
        kept={}, returned=[])


def _keep(state, k: int, t) -> None:
    """Keep step answer ``t`` of state ``k`` (uint8; a byte-equal answer
    as the last one kept for ``k``)."""
    if t is None:
        state.returned.append((k, None))
        return
    t = np.asarray(t)
    if t.size and (int(t.min()) < 0 or int(t.max()) > 255):
        raise ValueError("trussness past uint8: keep answers wider")
    t = t.astype(np.uint8)
    last = state.kept.get(k)
    if last is not None and np.array_equal(last, t):
        t = last
    state.kept[k] = t
    state.returned.append((k, t))


def window(run, state) -> None:
    """Toggle the pools back to back for ``run.seconds``; a step that
    raises ends the window."""
    eng, h = state.engine, state.handle
    n_pools = state.picks.shape[0]
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        j = (i // 2) % n_pools
        # state k: 0 the whole graph, j + 1 the graph less pool j
        k, batch = ((j + 1, dict(remove_edges=state.edges[state.picks[j]]))
                    if i % 2 == 0
                    else (0, dict(add_edges=state.edges[state.picks[j]])))
        run.attempted += 1
        i += 1
        try:
            with run.tracer.span("toggle.step"):
                eng.update(h, **batch)
                t = h.trussness
        except Exception as e:                  # noqa: BLE001 — counted
            run.error(repr(e))
            run.failed += 1
            _keep(state, k, None)
            break
        _keep(state, k, t)
    run.window_s = time.perf_counter() - t0
    run.records["graphs_returned"] = sum(
        1 for _, t in state.returned if t is not None)
    steps = [round(d, 3) for d in run.tracer.durations("toggle.step")]
    run.log(f"[bench] steps: {steps} s")


def finish(run, state):
    """The graph, the pools and every answer; the handle is closed."""
    state.engine.close(state.handle)
    state.engine = state.handle = None
    return {"edges": state.edges, "picks": state.picks,
            "returned": state.returned}


def check(run, outputs) -> dict:
    """Every answer against the plain reference's trussness of its
    state, row for row."""
    ref = spec.reference(run.cell.config)
    E, picks = outputs["edges"], outputs["picks"]
    states = sorted({k for k, _ in outputs["returned"]})
    truths = {}
    for k in states:
        keep = np.ones(E.shape[0], bool)
        if k:
            keep[picks[k - 1]] = False
        truth = ref.decompose(E[keep], run.device)
        truths[k] = truth.trussness
        run.log(f"[bench] state {k}: {truth.m} edges, {truth.triangles} "
                f"triangles, max trussness "
                f"{int(truth.trussness.max(initial=0))}")
    tally = compare.Tally()
    for k, t in outputs["returned"]:
        tally.rows(t, truths[k])
    return tally.compared()
