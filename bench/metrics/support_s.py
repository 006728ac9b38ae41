"""Seconds of ``pkt.support`` spans (the support phase: K1 on the card) per
one-shot decomposition: their sum inside ``pkt.one_shot`` spans over the
number of ``pkt.one_shot`` spans in the window."""

from bench.harness.one_shot import seconds_per_call


def read(run):
    """Program spans, seconds per decomposition."""
    return seconds_per_call(run, "pkt.support")
