"""The closed loop that most drivers share."""

from __future__ import annotations

import time


def closed_loop(run, step) -> None:
    """Call ``step(i)`` back to back while the window is open.

    A step that is still running when ``run.seconds`` have passed is
    finished and counted: ``run.window_s`` runs from the window's start to
    the end of the last step.  ``step`` returns whether it succeeded.
    """
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        run.attempted += 1
        if not step(i):
            run.failed += 1
        i += 1
    run.window_s = time.perf_counter() - t0
