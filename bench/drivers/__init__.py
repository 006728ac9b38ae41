"""Traffic drivers: each plays the traffic mixes that name it.

A driver module has ``setup(run) -> state``, ``window(run, state)``,
``finish(run, state) -> outputs`` and ``check(run, outputs) -> compared``.
"""
