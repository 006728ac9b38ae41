"""Spans and counts of the port's layers, on the profiler's clock.

A span is a named host interval: an id, the id of the span that encloses
it on the same thread (its parent), the thread, start and end in ns of
``time.time_ns()`` — the clock on which ``torch.profiler`` places the host
and device events of its trace — and a dict of attributes: counts, and a
request's id where there is one::

    from repro_torch import trace

    with trace.span("engine.submit", ticket=t):
        ...
        trace.set(m=m)          # on the innermost open span of this thread

Recording is on after ``enable()`` (until ``disable()``) and while
``torch.profiler`` records, so that a profiled run gets the port's spans
for exactly its window with no flag of its own.  While the profiler
records, each span also enters its trace as
``record_function("repro::<name>")``, so an exported timeline shows the
port's layers.  Otherwise ``span`` returns a shared no-op context manager
after one flag test.

``spans()`` returns a snapshot of the finished spans and ``clear()``
empties the buffer; it holds at most ``LIMIT`` spans and counts the ones
past it in ``dropped()``.  ``collect()`` hands the calling thread's spans
inside a block to a list of its own, recorded whether or not recording is
on: ``pkt(..., phase_timings=True)`` reads its phases from it.

The spans the port places, and what reads them (PERF.md, section 3):
``engine.submit`` (``ticket``, ``m``), ``engine.flush``,
``engine.dispatch`` (``graphs``, ``levels``, ``sublevels``, ``launches``),
``engine.union``, ``engine.align``; ``csr.canonical``, ``csr.order``,
``csr.relabel``, ``csr.build`` (``m``); ``pkt.one_shot`` (``rows``, ``n``,
``m``), ``pkt.preprocess`` (``on``: "host" or the device's type;
``core_sublevels``: the device k-core's sub-levels, 0 on the host),
``prep.canonical``, ``prep.order``, ``prep.build`` (``m``; the device
path's steps), ``pkt.align``; ``pkt.support``, ``pkt.peel_csr``
(``pkt.tables`` for the torch executors), ``pkt.loop`` (``levels``,
``sublevels``; for the kernel executor ``host_reads``, its blocking reads
of the device's counts — one a segment on the card, one a sub-level on
the CPU — and ``wait_ns``, host ns blocked in them), ``pkt.readback``,
``pkt.compact``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "repro::"
#: spans the default recorder keeps; later ones are counted as dropped
LIMIT = 1 << 20


def profiling() -> bool:
    """Whether ``torch.profiler`` is recording, on any thread."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One finished (or still open) span."""

    __slots__ = ("id", "parent", "name", "thread", "start_ns", "end_ns",
                 "attrs")

    def __init__(self, id_, parent, name, thread, attrs):
        self.id = id_
        self.parent = parent
        self.name = name
        self.thread = thread
        self.attrs = attrs
        self.start_ns = self.end_ns = 0

    @property
    def duration_ns(self) -> int:
        """``end_ns - start_ns``."""
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.duration_ns} ns, {self.attrs})")


class _Noop:
    """The context manager of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    """The context manager of one recorded span; yields its :class:`Span`."""

    __slots__ = ("_rec", "_span", "_stack", "_rf", "_to_buffer")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self._stack = rec._stack()
        parent = self._stack[-1].id if self._stack else None
        self._span = Span(next(rec._ids), parent, name,
                          threading.get_ident(), attrs)
        self._rf = None
        self._to_buffer = False

    def __enter__(self) -> Span:
        sp = self._span
        self._stack.append(sp)
        prof = profiling()
        self._to_buffer = self._rec.enabled or prof
        sp.start_ns = time.time_ns()
        if prof:
            self._rf = torch.profiler.record_function(PREFIX + sp.name)
            self._rf.__enter__()
        return sp

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        sp = self._span
        sp.end_ns = time.time_ns()
        self._stack.pop()
        self._rec._finish(sp, self._to_buffer)
        return False


class Recorder:
    """A bounded buffer of spans, with the thread-local state that places
    them.  The module's functions use one default recorder; tests make
    their own."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.enabled = False
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._buf: list[Span] = []
        self._dropped = 0
        self._tls = threading.local()
        self._collecting: set[int] = set()   # threads in ``collect`` blocks

    def _stack(self) -> list:
        return self._tls.__dict__.setdefault("stack", [])

    def _sinks(self) -> list:
        return self._tls.__dict__.setdefault("sinks", [])

    def span(self, name: str, **attrs):
        """A context manager that records the block as a span ``name``
        when recording is on; it yields the :class:`Span`, or ``None``
        when the span is not recorded."""
        # ``profiling()`` inlined: these tests are all a span costs when off
        if (self.enabled or _autograd_profiler._is_profiler_enabled
                or self._collecting):
            return _Open(self, name, attrs)
        return _NOOP

    def set(self, **attrs) -> None:
        """Put ``attrs`` on the calling thread's innermost open span (none
        is open while recording is off)."""
        stack = self._tls.__dict__.get("stack")
        if stack:
            stack[-1].attrs.update(attrs)

    def _finish(self, sp: Span, to_buffer: bool) -> None:
        for sink in self._tls.__dict__.get("sinks", ()):
            sink.append(sp)
        if to_buffer:
            with self._lock:
                if len(self._buf) < self.limit:
                    self._buf.append(sp)
                else:
                    self._dropped += 1

    @contextlib.contextmanager
    def collect(self):
        """Record the calling thread's spans inside the block, whether or
        not recording is on, and yield the list they are appended to as
        they finish."""
        sink: list[Span] = []
        sinks = self._sinks()
        sinks.append(sink)
        self._collecting.add(threading.get_ident())
        try:
            yield sink
        finally:
            sinks.pop()             # blocks on one thread nest
            if not sinks:
                self._collecting.discard(threading.get_ident())

    def spans(self) -> list[Span]:
        """A snapshot of the finished spans in the buffer, in the order
        they finished."""
        with self._lock:
            return list(self._buf)

    def dropped(self) -> int:
        """Spans that finished while the buffer was full."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        """Empty the buffer and the dropped count."""
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def enable(self) -> None:
        """Record from now on, profiler or not."""
        self.enabled = True

    def disable(self) -> None:
        """Record only while the profiler does (or inside ``collect``)."""
        self.enabled = False


def seconds(spans, names) -> float:
    """Seconds of the spans called one of ``names``; a span whose parent is
    one of them is counted with its parent only."""
    ids = {sp.id for sp in spans if sp.name in names}
    return sum(sp.duration_ns for sp in spans
               if sp.id in ids and sp.parent not in ids) / 1e9


RECORDER = Recorder()
span = RECORDER.span
set = RECORDER.set           # noqa: A001 — shadows the builtin here only
collect = RECORDER.collect
spans = RECORDER.spans
dropped = RECORDER.dropped
clear = RECORDER.clear
enable = RECORDER.enable
disable = RECORDER.disable
