"""The program's own spans (``repro_torch.trace``) inside a traced window.

While the profiler records, the port records its spans on the profiler's
clock, so those of a traced run are the window's; they are kept to the
interval that the run's bench spans cover, so that earlier runs in the
same process do not count.  A program without ``repro_torch.trace`` has no
spans: then every reader of them reads nothing.
"""

from __future__ import annotations


def program_spans(run) -> list | None:
    """The program's finished spans inside the run's traced window, or
    ``None`` when there are none.  Read once a run; the first read prints
    how many there were and how many the program's buffer dropped."""
    if "program_spans" not in run.records:
        run.records["program_spans"] = _read(run)
    return run.records["program_spans"]


def _read(run) -> list | None:
    events = run.tracer.events
    if events is None or not events["spans"]:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    lo = min(s for _, s, _ in events["spans"])
    hi = max(e for _, _, e in events["spans"])
    spans = [sp for sp in trace.spans()
             if lo <= sp.start_ns and sp.end_ns <= hi]
    run.log(f"[bench] program spans in the window: {len(spans)}, dropped "
            f"{trace.dropped()}")
    return spans or None


def named(spans, name: str) -> list:
    """The spans called ``name``."""
    return [sp for sp in spans if sp.name == name]


def total(spans, name: str, attr: str) -> int:
    """The sum of attribute ``attr`` over the spans called ``name``."""
    return sum(sp.attrs.get(attr, 0) for sp in named(spans, name))
