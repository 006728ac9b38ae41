"""Blocking host reads of the device's counts per peel sub-level: the
``host_reads`` of every ``pkt.loop`` span over their ``sublevels``.  One a
sub-level where the host drives the loop, one a segment where the device
runs it; nothing to read where the spans carry no ``host_reads``."""

from bench.harness.spans import named, program_spans, total


def read(run):
    """Program span attributes, reads per sub-level."""
    loops = named(program_spans(run) or [], "pkt.loop")
    if not any("host_reads" in sp.attrs for sp in loops):
        return None
    subs = total(loops, "pkt.loop", "sublevels")
    if not subs:
        return None
    return total(loops, "pkt.loop", "host_reads") / subs
