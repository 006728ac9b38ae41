"""The share of the traced window in which nothing ran on the device:
one minus the union of the device's activity intervals over the window.
It reads every ``device_idle.<scope>`` metric that has no file of its
own."""


def read(run):
    """Percent, from the profiler's trace."""
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
