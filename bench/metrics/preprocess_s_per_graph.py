"""Seconds of host preprocessing per graph submitted: each
``engine.submit`` span (canonicalize, k-core order, relabel, CSR build,
size class) less the ``engine.flush`` it ran as its auto-flush, over the
number of ``engine.submit`` spans in the window."""

from bench.harness.spans import named, program_spans


def read(run):
    """Program spans, seconds per graph."""
    spans = program_spans(run)
    submits = named(spans or [], "engine.submit")
    if not submits:
        return None
    ids = {sp.id for sp in submits}
    flush_ns = sum(sp.duration_ns for sp in named(spans, "engine.flush")
                   if sp.parent in ids)
    own_ns = sum(sp.duration_ns for sp in submits) - flush_ns
    return own_ns / len(submits) / 1e9
