"""Seconds of ``inc.rebuild`` spans (a full rebuild, where an update
falls back to one) per update of a live handle: their sum inside
``inc.update`` spans over the number of ``inc.update`` spans in the
window."""

from bench.harness.updates import seconds_per_update


def read(run):
    """Program spans, seconds per update."""
    return seconds_per_update(run, "inc.rebuild")
