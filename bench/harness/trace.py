"""Spans placed by the benchmark around calls into the program, and the
reader of the device trace.

A span is a host-clock interval with a name, kept in memory.  In a traced
run (``--trace 1``) each span also enters the profiler's trace as a user
annotation (``bench::<name>``), so that device time can be placed inside
it; the whole measured window is profiled.  The device side follows
``chip_smoke.py: profile_run`` (kernels by name, the busy share), with the
busy time taken as the union of the device's activity intervals.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

PREFIX = "bench::"


class Tracer:
    """Spans of one run, and the profiler over its window when traced."""

    def __init__(self, traced: bool, device: torch.device):
        self.traced = traced
        self.device = device
        self.spans: list[tuple[str, float, float]] = []
        self._prof = None
        self.window = None          # (start, stop) host clock when traced
        self.events = None          # read from the trace once it stops

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block on the host clock (and annotate the trace)."""
        t0 = time.perf_counter()
        if self._prof is not None:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list[float]:
        """Seconds of every span called ``name``, in order."""
        return [b - a for n, a, b in self.spans if n == name]

    def start(self) -> None:
        """Start profiling (traced runs only)."""
        if not self.traced:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.window = [time.perf_counter(), None]

    def stop(self) -> None:
        """Stop profiling and read the trace (traced runs only)."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window[1] = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.events = read_events(self._prof)
        self._prof = None


def read_events(prof) -> dict:
    """Device intervals and bench annotations, in ns of the trace's clock.

    Returns ``{"device": [(name, start, end)], "spans": [(name, start,
    end)]}``.
    """
    from torch.autograd import DeviceType
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(PREFIX):
            # a bench annotation; its copy on the device's timeline (a user
            # annotation, not device work) is left out
            if ev.device_type() != DeviceType.CUDA:
                s = ev.start_ns()
                spans.append((name[len(PREFIX):], s, s + ev.duration_ns()))
        elif (ev.device_type() == DeviceType.CUDA
              and not ev.is_user_annotation()):
            s = ev.start_ns()
            device.append((name, s, s + ev.duration_ns()))
    return {"device": device, "spans": spans}


def merged(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(union, lo=None, hi=None) -> int:
    """Nanoseconds of ``union`` inside [lo, hi] (everything by default)."""
    total = 0
    for s, e in union:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            total += e - s
    return total


def device_summary(tracer: Tracer) -> dict | None:
    """``busy_s``, ``window_s``, the top device operations and the idle
    gaps by the bench span the host was in; ``None`` when not traced."""
    if tracer.events is None:
        return None
    ev = tracer.events
    window_s = tracer.window[1] - tracer.window[0]
    union = merged((s, e) for _, s, e in ev["device"])
    by_name: dict[str, float] = {}
    for name, s, e in ev["device"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps: dict[str, float] = {}
    if len(union) > 1:
        ends = np.array([e for _, e in union[:-1]], dtype=np.int64)
        starts = np.array([s for s, _ in union[1:]], dtype=np.int64)
        mids = (ends + starts) // 2            # sorted, as the union is
        label = np.full(mids.size, -1, np.int64)
        names = [name for name, _, _ in ev["spans"]]
        # longest spans first, so that the innermost span holding a gap's
        # middle labels it
        for i in sorted(range(len(names)),
                        key=lambda i: ev["spans"][i][1] - ev["spans"][i][2]):
            _, s, e = ev["spans"][i]
            label[np.searchsorted(mids, s):
                  np.searchsorted(mids, e, side="right")] = i
        secs = (starts - ends) / 1e9
        for i in np.unique(label):
            key = names[i] if i >= 0 else "outside spans"
            gaps[key] = gaps.get(key, 0.0) + float(secs[label == i].sum())
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_ns(union) / 1e9, window_s=window_s,
                union=union, device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in idle])
