"""Seconds of engine dispatch per graph: ``TrussEngine.stats``'s
``graph_seconds`` over ``graphs_done``, over the window (each flush's
bucket dispatches, from preprocessing's end to the results' alignment)."""


def read(run):
    """Host clock (the engine's own counters), seconds per graph."""
    eng = run.records.get("engine")
    if not eng or not eng.get("graphs_done"):
        return None
    return eng["graph_seconds"] / eng["graphs_done"]
