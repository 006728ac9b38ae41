"""The share of a live handle's updates repaired locally: ``inc.update``
spans with ``mode`` "local" over all ``inc.update`` spans in the window
(the rest rebuilt from scratch)."""

from bench.harness.updates import share


def read(run):
    """Program spans, percent."""
    return share(run, "mode", "local")
