"""Peel sub-levels per graph dispatched: the ``sublevels`` of every
``engine.dispatch`` span over their ``graphs`` (a disjoint union's
sub-levels serve every graph in it)."""

from bench.harness.spans import program_spans, total


def read(run):
    """Program span attributes, sub-levels per graph."""
    spans = program_spans(run)
    if not spans:
        return None
    graphs = total(spans, "engine.dispatch", "graphs")
    if not graphs:
        return None
    return total(spans, "engine.dispatch", "sublevels") / graphs
