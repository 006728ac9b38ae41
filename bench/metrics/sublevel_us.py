"""Microseconds of wall time per peel sub-level: the ``pkt.loop`` spans'
length over their ``sublevels`` (a sub-level's two launches and its
blocking read of the frontier count, with each level's start)."""

from bench.harness.spans import named, program_spans, total


def read(run):
    """Program spans and their attributes, microseconds per sub-level."""
    spans = program_spans(run)
    if not spans:
        return None
    subs = total(spans, "pkt.loop", "sublevels")
    if not subs:
        return None
    loop_ns = sum(sp.duration_ns for sp in named(spans, "pkt.loop"))
    return loop_ns / subs / 1e3
