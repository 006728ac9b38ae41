"""Edges a live handle's update re-peeled or re-descended: the mean of
``affected`` over the ``inc.update`` spans in the window."""

from bench.harness.updates import mean


def read(run):
    """Program spans, edges per update."""
    return mean(run, "affected")
