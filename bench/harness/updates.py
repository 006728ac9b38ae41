"""Readings of a live handle's updates from the program's spans.

Each ``engine.update`` on a handle is one ``inc.update`` span (``mode``,
``affected``, ...); its steps are spans inside it (``inc.search``,
``inc.region_peel``, ``inc.csr``, ``inc.rebuild``, ...).  A program
without ``inc.update`` spans has nothing to read.
"""

from __future__ import annotations

from bench.harness.spans import named, program_spans


def updates(run) -> tuple[list, list]:
    """The program's spans in the traced window and its ``inc.update``
    spans among them (both empty when there are none)."""
    spans = program_spans(run) or []
    return spans, named(spans, "inc.update")


def seconds_per_update(run, name: str) -> float | None:
    """Seconds of the spans called ``name`` inside ``inc.update`` spans,
    per ``inc.update`` span in the traced window; ``None`` when there is
    none."""
    spans, calls = updates(run)
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


def share(run, attr: str, value) -> float | None:
    """Percent of the ``inc.update`` spans whose ``attr`` is ``value``."""
    _, calls = updates(run)
    if not calls:
        return None
    return 100.0 * sum(sp.attrs.get(attr) == value for sp in calls) / len(
        calls)


def mean(run, attr: str) -> float | None:
    """The mean of attribute ``attr`` over the ``inc.update`` spans."""
    _, calls = updates(run)
    if not calls:
        return None
    return sum(sp.attrs.get(attr, 0) for sp in calls) / len(calls)
