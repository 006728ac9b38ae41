"""Seconds of ``inc.search`` spans (the search for the edges an
insertion can raise) per update of a live handle: their sum inside
``inc.update`` spans over the number of ``inc.update`` spans in the
window."""

from bench.harness.updates import seconds_per_update


def read(run):
    """Program spans, seconds per update."""
    return seconds_per_update(run, "inc.search")
