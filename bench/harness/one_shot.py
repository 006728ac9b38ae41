"""Seconds per one-shot decomposition from the program's spans.

A ``truss_pkt`` call is one ``pkt.one_shot`` span; its layers are spans
inside it (``pkt.preprocess``, ``pkt.support``, ``pkt.loop``,
``pkt.compact``, ...).  A program without ``pkt.one_shot`` spans has
nothing to read.
"""

from __future__ import annotations

from bench.harness.spans import named, program_spans


def seconds_per_call(run, name: str) -> float | None:
    """Seconds of the spans called ``name`` inside ``pkt.one_shot`` spans,
    per ``pkt.one_shot`` span in the traced window; ``None`` when there is
    none."""
    spans = program_spans(run) or []
    calls = named(spans, "pkt.one_shot")
    if not calls:
        return None
    parent = {sp.id: sp.parent for sp in spans}
    roots = {sp.id for sp in calls}

    def inside(sp) -> bool:
        p = sp.parent
        while p is not None and p not in roots:
            p = parent.get(p)
        return p is not None

    ns = sum(sp.duration_ns for sp in named(spans, name) if inside(sp))
    return ns / len(calls) / 1e9
