"""The share of the traced window in which the device idled inside the
pkt loop: each ``pkt.loop`` span's length less the device's busy time
within it (``trace.busy_ns`` of the span's bounds), summed, over the
window.  At most ``device_idle``: the loops are disjoint parts of the
window."""

import numpy as np

from bench.harness.spans import named, program_spans


def busy_in(union, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``trace.busy_ns(union, lo[i], hi[i])`` for every i at once: the
    union is sorted and disjoint, so each bound is one binary search."""
    if not union:
        return np.zeros(len(lo), np.int64)
    s, e = (np.array(c, np.int64) for c in zip(*union))
    done = np.concatenate([[0], np.cumsum(e - s)])
    a = np.searchsorted(e, lo, side="right")    # first interval ending past lo
    b = np.searchsorted(s, hi, side="left")     # past the last starting < hi
    a_c = np.minimum(a, len(s) - 1)
    b_c = np.maximum(b - 1, 0)
    busy = (done[b] - done[np.minimum(a, b)]
            - np.clip(lo - s[a_c], 0, None) - np.clip(e[b_c] - hi, 0, None))
    return np.where(a < b, busy, 0)


def read(run):
    """Percent, from the device trace and the program's spans."""
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    loops = named(program_spans(run) or [], "pkt.loop")
    if not loops:
        return None
    lo = np.array([sp.start_ns for sp in loops], np.int64)
    hi = np.array([sp.end_ns for sp in loops], np.int64)
    idle_ns = int((hi - lo).sum() - busy_in(t["union"], lo, hi).sum())
    return 100.0 * idle_ns / (t["window_s"] * 1e9)
