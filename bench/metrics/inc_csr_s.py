"""Seconds of ``inc.csr`` spans (a batch's edge-key algebra, its CSR
builds and the recount) per update of a live handle: their sum inside
``inc.update`` spans over the number of ``inc.update`` spans in the
window."""

from bench.harness.updates import seconds_per_update


def read(run):
    """Program spans, seconds per update."""
    return seconds_per_update(run, "inc.csr")
