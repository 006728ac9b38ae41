"""Async continuous-batching truss serving — the event-loop scheduler.

The port's copy of the JAX package's ``serve/scheduler.py``, over the
port's :class:`~repro_torch.serve.truss_engine.TrussEngine`; only the
executor names of the degradation ladders differ (``kernel``/``torch``
where the JAX package says ``pallas``/``jnp``).

``TrussEngine`` is a synchronous ticket queue: ``submit``/``open``/
``update``/``hierarchy`` all execute on the caller's thread, and nothing
coalesces mixed traffic into device dispatches.  This module puts the
LLM-serving shape on top of it (DESIGN.md §12): requests are admitted
asynchronously and return ``concurrent.futures.Future``s immediately, a
single scheduler thread runs a continuous-batching tick loop, and
compatible work coalesces per tick —

  * **decompositions** (``submit_async``) of one pow2 size class merge into
    one disjoint-union ``pkt`` dispatch (the engine's bucket machinery:
    one K1 launch and one peel-loop launch per peel segment for the
    bucket),
    released either when the bucket reaches ``max_batch`` or when its
    oldest request has waited ``max_delay_ms`` — the classic
    latency-vs-batch-fullness policy;
  * **handle updates** (``update_async``) queued against one handle merge
    set-wise into a single
    :class:`~repro_torch.core.truss_inc.IncrementalTruss` repair (``compose_update_batches``: n churn batches, one
    affected-region re-peel), bitwise-identical to applying them one at a
    time;
  * **queries** (``query_async``/``communities_async``) serve from the
    handle's maintained trussness and cached hierarchy index, ordered FIFO
    per handle against that handle's updates, so every query observes
    exactly the prefix of updates admitted before it.

Admission control sheds load with a typed :class:`Overloaded` error (never
by silent queueing): a global queue-depth bound (``max_queue``) plus a
per-tenant in-flight cap (``max_inflight``); the error carries a
``retry_after_ms`` hint derived from the current depth and the measured
per-request service time.  Per-stage timing — queue wait, operand build,
device dispatch, result readback, repair, query, heal — is accumulated
and exposed via :meth:`TrussScheduler.stats`.

On top of the engine's exception safety sits the resilience layer
(DESIGN.md §15, ``serve/resilience.py``): every expensive dispatch runs
under bounded retry with deterministic backoff and a per-site executor
degradation ladder (demote to a bitwise-identical slower rung on repeated
failure, probe and re-promote on recovery); requests can carry deadlines
(typed :class:`DeadlineExceeded`); integrity violations in incremental
state quarantine the handle and rebuild it from its retained CSR while
queued requests wait (:class:`~repro_torch.core.truss_inc.IntegrityError` →
heal); and an optional watchdog fails outstanding futures with a typed
:class:`Wedged` (plus the stuck thread's stack) when the tick loop stops
making progress.

Parity: the scheduler adds *no* numeric path of its own.  Async results
are bitwise-equal to the synchronous engine's because every dispatch is an
engine call (``submit``+``flush``+``result``, ``update_many``, handle
queries) and the only reordering it ever performs is across independent
requests — per-handle order is FIFO and update coalescing composes
set-wise exactly (DESIGN.md §12 gives the argument).  Degradation-ladder
rungs are drawn from the repo's parity-gated executor axes, so retries and
demotions never change any completed result (``tests/test_torch_chaos.py``
holds the port's scheduler against the JAX package's under the same
injected faults).

Threads: the engine runs on the scheduler thread, not the caller's.
Torch's per-thread state — grad mode, the current CUDA device and stream —
does not follow the work there, so the engine names its device on every
tensor and kernel launch and relies on no context the caller opened.
Every dispatch returns host numpy after the card has finished (the
engine's ``flush`` ends in ``align_to_input``), so stage times and deadline
checks cover the device work.  Kernel launch counts
(``repro_torch.kernels.count_launches``) are per thread: a block on the
caller's thread does not see the launches of the engine's dispatches, and
the engine's own counts (``stats["bucket_launches"]``, the
``engine.dispatch`` span's ``launches``) see only them.

Usage::

    from repro_torch.serve import TrussScheduler

    with TrussScheduler(max_batch=16, max_delay_ms=2.0) as sched:
        f1 = sched.submit_async(edges_a)          # Future[np.ndarray]
        f2 = sched.open_async(edges_b)            # Future[TrussHandle]
        h = f2.result()
        f3 = sched.update_async(h, add_edges=new_rows)
        f4 = sched.query_async(h, some_rows, deadline_ms=250.0)
        print(f1.result(), f3.result().mode, f4.result())
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from repro_torch.core.truss_inc import IntegrityError
from repro_torch.serve.resilience import (DeadlineExceeded, Ladder,
                                          RetryPolicy, Wedged,
                                          override_attrs,
                                          run_with_resilience)
from repro_torch.serve.truss_engine import TrussEngine, TrussHandle

_KINDS = ("submit", "open", "update", "query", "communities")

#: degradation-ladder attribute overrides for the region re-peel site
#: (applied to the handle's ``IncrementalTruss`` for one dispatch)
_REGION_OVERRIDES = {
    "default": {},
    "chunked": {"mode": "chunked"},
    "host": {"host_peel_max": 1 << 62},
}

#: ladder overrides for the support-build site (open / full rebuild)
_SUPPORT_OVERRIDES = {
    "default": {},
    "torch": {"support_mode": "torch"},
    "numpy": {"support_mode": "torch", "table_mode": "numpy"},
}


class Overloaded(RuntimeError):
    """Request shed by admission control.

    Raised synchronously by the ``*_async`` entry points when the global
    queue depth reaches ``max_queue`` or the calling tenant already has
    ``max_inflight`` requests in flight.  Shedding at admission (instead of
    queueing unboundedly) keeps tail latency bounded under overload; the
    caller owns the retry policy, and ``retry_after_ms`` informs it: the
    estimated time for the current backlog to drain, computed from the
    queue depth and the measured mean per-request service time in
    ``stats()["stages"]`` (clamped to ``[max_delay_ms, 60000]``; the
    dispatch-delay bound is the floor before any request has completed).
    """

    def __init__(self, message: str, *, retry_after_ms: float | None = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class Cancelled(RuntimeError):
    """Request cancelled by ``close(drain=False)`` before dispatch.

    Set as the future's exception (so ``result()`` raises it — typed,
    never a bare ``RuntimeError``), carrying the request ``kind`` and the
    request's ``position`` in the cancelled queue snapshot (admission
    order: position 0 was next in line).
    """

    def __init__(self, kind: str, position: int):
        super().__init__(
            f"{kind} request cancelled by close(drain=False) at queue "
            f"position {position}")
        self.kind = kind
        self.position = position


@dataclasses.dataclass(eq=False)
class _Request:
    """One admitted request, queued between admission and completion."""

    kind: str                      # one of _KINDS
    tenant: str
    future: Future
    t_enq: float                   # perf_counter at admission
    edges: np.ndarray | None = None        # submit/open/query payload
    handle: TrussHandle | None = None      # update/query/communities target
    add: np.ndarray | None = None          # update payload
    remove: np.ndarray | None = None
    k: int = 0                             # communities level
    local_frac: float = 0.25               # open policy
    t_deadline: float | None = None        # absolute perf_counter deadline


class TrussScheduler:
    """Event-loop continuous-batching scheduler over a :class:`TrussEngine`.

    One background thread owns the engine; callers interact only through
    the ``*_async`` methods, each returning a ``concurrent.futures.Future``
    (engine errors — validation, oversized graphs, closed handles —
    surface as that future's exception; admission errors raise
    :class:`Overloaded` synchronously).

    Args:
        engine: the engine to serve; ``None`` builds one from
            ``engine_kwargs`` (with ``max_pending`` raised so the engine's
            own auto-flush never preempts the dispatch policy).  Once
            wrapped, the engine must not be driven concurrently from other
            threads.
        max_batch: dispatch a decomposition bucket as soon as it holds this
            many requests.
        max_delay_ms: dispatch a non-empty bucket once its oldest request
            has waited this long, even if not full (the latency bound; 0
            dispatches every tick).
        max_queue: global admitted-but-unfinished request bound; beyond it
            admissions shed with :class:`Overloaded`.
        max_inflight: per-tenant in-flight bound (same shedding).
        deadline_ms: default per-request deadline (``None``: no deadline);
            each ``*_async`` call may override.  Expired requests fail with
            a typed :class:`DeadlineExceeded` — before dispatch for every
            kind, and additionally at delivery for read-only kinds
            (submit/query/communities); committed updates and opens always
            deliver, so deadline pressure never tears state.
        retry: :class:`RetryPolicy` for transient dispatch failures
            (``None``: the default policy — 2 retries, exponential backoff
            from 2ms with deterministic jitter).
        ladder: optional dict of :class:`Ladder` keyword overrides
            (``demote_after``/``probe_after``/``promote_after``) applied to
            every dispatch site's degradation ladder.
        invariant_sample: edges sampled by the post-repair
            ``IncrementalTruss.check_invariants`` sweep (0 disables).
        watchdog_s: if set, a watchdog thread fails all outstanding
            futures with :class:`Wedged` (including the scheduler thread's
            stack as diagnostics) when the tick loop makes no progress for
            this long while work is queued.  ``None`` (default) disables;
            set it comfortably above the slowest dispatch.  On the card the
            first use of each CUDA kernel builds it with ``nvcc`` (seconds,
            under ``cuda_build``'s lock): call
            ``repro_torch.kernels.cuda_build.build_all()`` before starting
            a scheduler with a watchdog, so that no build runs on the
            scheduler thread.
        start: start the scheduler thread immediately; ``False`` leaves
            requests queued until :meth:`start` (tests use this to stage
            traffic deterministically).
        **engine_kwargs: forwarded to :class:`TrussEngine` when ``engine``
            is ``None`` (``mode``, ``support_mode``, ``table_mode``,
            ``device``, …); the engine runs on the card by default and
            raises without one — pass ``device="cpu"`` to serve from the
            plain PyTorch executors.

    Raises:
        ValueError: non-positive ``max_batch``/``max_queue``/
            ``max_inflight``, negative ``max_delay_ms``, or non-positive
            ``deadline_ms``/``watchdog_s``/``invariant_sample``.
    """

    def __init__(self, engine: TrussEngine | None = None, *,
                 max_batch: int = 16, max_delay_ms: float = 2.0,
                 max_queue: int = 256, max_inflight: int = 64,
                 deadline_ms: float | None = None,
                 retry: RetryPolicy | None = None,
                 ladder: dict | None = None,
                 invariant_sample: int = 64,
                 watchdog_s: float | None = None,
                 start: bool = True, **engine_kwargs):
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if max_queue < 1:
            raise ValueError("max_queue must be positive")
        if max_inflight < 1:
            raise ValueError("max_inflight must be positive")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive (or None)")
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError("watchdog_s must be positive (or None)")
        if invariant_sample < 0:
            raise ValueError("invariant_sample must be >= 0")
        if engine is None:
            engine_kwargs.setdefault("max_pending", 4 * max_batch + max_queue)
            engine = TrussEngine(**engine_kwargs)
        elif engine_kwargs:
            raise ValueError("pass engine_kwargs only without an engine")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_queue = int(max_queue)
        self.max_inflight = int(max_inflight)
        self.deadline_ms = deadline_ms
        self.retry = retry if retry is not None else RetryPolicy()
        self.invariant_sample = int(invariant_sample)
        self.watchdog_s = watchdog_s
        self._ladders = self._build_ladders(dict(ladder or {}))

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._inbox: deque[_Request] = deque()
        #: bucket key -> [(ticket, request)] awaiting batched dispatch
        self._buckets: dict[object, list[tuple[int, _Request]]] = {}
        #: handle id -> FIFO of update/query/communities requests
        self._hqueues: dict[int, deque[_Request]] = {}
        #: every admitted, unresolved request (the watchdog's fail set;
        #: authoritative for _finish bookkeeping)
        self._outstanding: set[_Request] = set()
        #: handle ids whose incremental state is suspect: healed (rebuilt
        #: from the retained CSR) before the next request is served
        self._quarantined: set[int] = set()
        self._depth = 0                    # admitted, not yet finished
        self._inflight: dict[str, int] = {}
        self._closed = False
        self._drain = True
        self._wedged: str | None = None    # watchdog diagnostics once tripped
        self._heartbeat = time.perf_counter()
        self._nchecks = 0                  # invariant-sweep seed counter
        self._counters = {k: 0 for k in _KINDS}
        self._counters.update(shed=0, done=0, errors=0, cancelled=0,
                              dispatches=0, coalesced_updates=0,
                              retries=0, deadline_exceeded=0, heals=0,
                              heal_failures=0, watchdog_trips=0)
        self._stages = {k: {"count": 0, "seconds": 0.0, "max_seconds": 0.0}
                        for k in ("queue_wait", "build", "dispatch",
                                  "readback", "open", "repair", "query",
                                  "heal")}
        self._thread: threading.Thread | None = None
        self._watchdog_thread: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        if start:
            self.start()

    def _build_ladders(self, opts: dict) -> dict[str, Ladder]:
        """Per-site degradation ladders from the engine's configured modes.

        Every rung pairing is one of the repo's parity-gated executor
        axes, so demotion changes latency, never results; rungs equal to
        the configured executor are deduplicated away.
        """
        e = self.engine
        flush = [f"{e.mode}+{e.support_mode}"]
        if (e.mode, e.support_mode) != ("chunked", "torch"):
            flush.append("chunked+torch")
        flush.append("host")
        region = ["default"]
        if e.mode != "chunked":
            region.append("chunked")
        region.append("host")
        support = ["default"]
        if e.support_mode != "torch":
            support.append("torch")
        if e.table_mode != "numpy":
            support.append("numpy")
        hier = ["default"]
        if e.hier_mode != "host":
            hier.append("host")
        return {site: Ladder(tuple(rungs), **opts)
                for site, rungs in (("flush", flush), ("region", region),
                                    ("support", support),
                                    ("hierarchy", hier))}

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> None:
        """Start the scheduler (and watchdog) threads (idempotent)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="truss-scheduler", daemon=True)
                self._thread.start()
            if self.watchdog_s is not None \
                    and self._watchdog_thread is None:
                self._watchdog_thread = threading.Thread(
                    target=self._watchdog, name="truss-watchdog", daemon=True)
                self._watchdog_thread.start()

    def close(self, *, drain: bool = True) -> None:
        """Stop the scheduler.

        Args:
            drain: ``True`` dispatches everything already admitted before
                stopping (their futures complete — a never-started
                scheduler with queued work is started just to drain it);
                ``False`` rejects queued requests with a typed
                :class:`Cancelled` (no future is ever left unresolved).
        """
        if drain:
            with self._lock:
                not_started = self._thread is None and not self._closed
                pending = bool(self._inbox or self._buckets or self._hqueues)
            if not_started and pending:
                self.start()    # someone must run the drain
        with self._work:
            if self._closed and self._thread is None \
                    and self._watchdog_thread is None:
                return
            self._closed = True
            self._drain = drain
            self._work.notify_all()
            t = self._thread
            wt = self._watchdog_thread
        if t is not None:
            t.join()
        else:
            # never-started scheduler: no loop will run _cancel_all, so
            # resolve everything queued inline
            with self._lock:
                batch = list(self._inbox)
                self._inbox.clear()
            self._cancel_all(batch)
        self._watchdog_stop.set()
        if wt is not None:
            wt.join()
        with self._lock:
            self._thread = None
            self._watchdog_thread = None

    def __enter__(self):
        """Context manager: returns self (thread already running)."""
        self.start()
        return self

    def __exit__(self, *exc):
        """Context manager exit: drain and stop the scheduler thread."""
        self.close(drain=True)
        return False

    # ------------------------------------------------------------ admission --
    def _retry_after_ms(self):  # trusslint: holds[_lock]
        """Backlog-drain estimate for the Overloaded hint (under the lock).

        Mean service seconds per completed request (all stages except
        queue wait) times the current depth, clamped to
        ``[max_delay_ms, 60s]``; before any completion the dispatch-delay
        bound is all we know.
        """
        done = max(1, self._counters["done"])
        busy = sum(s["seconds"] for k, s in self._stages.items()
                   if k != "queue_wait")
        per_req = busy / done
        hint = max(self.max_delay * 1e3, self._depth * per_req * 1e3)
        return min(60_000.0, max(1.0, hint))

    def _admit(self, req: _Request) -> Future:
        with self._work:
            if self._closed:
                if self._wedged is not None:
                    raise Wedged(self._wedged)
                raise RuntimeError("scheduler is closed")
            if self._depth >= self.max_queue:
                self._counters["shed"] += 1
                hint = self._retry_after_ms()
                raise Overloaded(
                    f"queue depth {self._depth} at max_queue="
                    f"{self.max_queue}: request shed; retry after "
                    f"~{hint:.0f}ms or raise max_queue",
                    retry_after_ms=hint)
            if self._inflight.get(req.tenant, 0) >= self.max_inflight:
                self._counters["shed"] += 1
                hint = self._retry_after_ms()
                raise Overloaded(
                    f"tenant {req.tenant!r} has "
                    f"{self._inflight[req.tenant]} requests in flight "
                    f"(max_inflight={self.max_inflight}): request shed; "
                    f"retry after ~{hint:.0f}ms",
                    retry_after_ms=hint)
            self._depth += 1
            self._inflight[req.tenant] = \
                self._inflight.get(req.tenant, 0) + 1
            self._counters[req.kind] += 1
            self._outstanding.add(req)
            self._inbox.append(req)
            self._work.notify()
        return req.future

    def _deadline_for(self, t_enq: float, deadline_ms) -> float | None:
        """Absolute deadline for a request admitted at ``t_enq``."""
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        if dl is None:
            return None
        dl = float(dl)
        if dl <= 0:
            raise ValueError("deadline_ms must be positive (or None)")
        return t_enq + dl / 1e3

    @staticmethod
    def _check_handle(handle) -> TrussHandle:
        if not isinstance(handle, TrussHandle):
            raise TypeError(
                f"expected a TrussHandle (from open_async), got "
                f"{type(handle).__name__}; the scheduler does not promote "
                f"tickets — open the graph instead")
        if handle.closed:
            raise ValueError(f"handle {handle.hid} is closed")
        return handle

    def submit_async(self, edges, *, tenant: str = "default",
                     deadline_ms: float | None = None) -> Future:
        """Queue one decomposition; the future resolves to its trussness.

        Args:
            edges: ``(k, 2)`` integer edge array (``TrussEngine.submit``
                validation applies — on failure the *future* carries the
                ValueError).
            tenant: admission-control accounting key.
            deadline_ms: per-request deadline override (``None``: the
                scheduler default).

        Returns:
            ``Future[np.ndarray]`` — trussness aligned to the input rows,
            bitwise-equal to ``TrussEngine.submit``/``result``.

        Raises:
            Overloaded: shed by queue-depth or per-tenant admission control.
            RuntimeError: the scheduler is closed.
        """
        t = time.perf_counter()
        return self._admit(_Request(
            kind="submit", tenant=tenant, future=Future(), t_enq=t,
            edges=np.asarray(edges),
            t_deadline=self._deadline_for(t, deadline_ms)))

    def open_async(self, edges, *, local_frac: float = 0.25,
                   tenant: str = "default",
                   deadline_ms: float | None = None) -> Future:
        """Queue a persistent-handle open (full decomposition).

        Args:
            edges: ``(k, 2)`` integer edge array.
            local_frac: the handle's local-repair fallback threshold.
            tenant: admission-control accounting key.
            deadline_ms: per-request deadline override (checked before the
                open dispatches; a handle that finished building is always
                delivered, never leaked).

        Returns:
            ``Future[TrussHandle]`` — pass the handle to ``update_async``/
            ``query_async``/``communities_async``.

        Raises:
            Overloaded: shed by admission control.
            RuntimeError: the scheduler is closed.
        """
        t = time.perf_counter()
        return self._admit(_Request(
            kind="open", tenant=tenant, future=Future(), t_enq=t,
            edges=np.asarray(edges), local_frac=local_frac,
            t_deadline=self._deadline_for(t, deadline_ms)))

    def update_async(self, handle: TrussHandle, *, add_edges=None,
                     remove_edges=None, tenant: str = "default",
                     deadline_ms: float | None = None) -> Future:
        """Queue one insert/delete batch against a handle.

        Consecutive updates queued against the same handle (with no query
        between them) coalesce into a single composed repair; each of their
        futures then carries the same :class:`UpdateStats` with
        ``coalesced`` set to the merge width.

        Args:
            handle: an open handle from ``open_async`` (or
                ``TrussEngine.open``).
            add_edges: edges to insert (``None`` for none).
            remove_edges: edges to delete.
            tenant: admission-control accounting key.
            deadline_ms: per-request deadline override (checked before the
                repair dispatches; a committed repair always resolves its
                futures — deadline pressure never tears state).

        Returns:
            ``Future[UpdateStats]`` for the (possibly coalesced) repair.

        Raises:
            Overloaded: shed by admission control.
            TypeError: ``handle`` is not a :class:`TrussHandle`.
            ValueError: the handle is already closed.
            RuntimeError: the scheduler is closed.
        """
        t = time.perf_counter()
        return self._admit(_Request(
            kind="update", tenant=tenant, future=Future(), t_enq=t,
            handle=self._check_handle(handle), add=add_edges,
            remove=remove_edges,
            t_deadline=self._deadline_for(t, deadline_ms)))

    def query_async(self, handle: TrussHandle, edges, *,
                    tenant: str = "default",
                    deadline_ms: float | None = None) -> Future:
        """Queue a trussness query; FIFO-ordered against the handle's updates.

        Args:
            handle: an open handle.
            edges: ``(k, 2)`` rows to look up (endpoint order/dupes OK).
            tenant: admission-control accounting key.
            deadline_ms: per-request deadline override.

        Returns:
            ``Future[np.ndarray]`` — per-row trussness, observing exactly
            the updates admitted on this handle before this query.

        Raises:
            Overloaded: shed by admission control.
            TypeError: ``handle`` is not a :class:`TrussHandle`.
            ValueError: the handle is already closed.
            RuntimeError: the scheduler is closed.
        """
        t = time.perf_counter()
        return self._admit(_Request(
            kind="query", tenant=tenant, future=Future(), t_enq=t,
            handle=self._check_handle(handle), edges=np.asarray(edges),
            t_deadline=self._deadline_for(t, deadline_ms)))

    def communities_async(self, handle: TrussHandle, k: int, *,
                          tenant: str = "default",
                          deadline_ms: float | None = None) -> Future:
        """Queue a k-truss community listing against the cached index.

        Args:
            handle: an open handle.
            k: community level (see ``TrussHandle.communities``).
            tenant: admission-control accounting key.
            deadline_ms: per-request deadline override.

        Returns:
            ``Future[list[np.ndarray]]`` — every level-``k`` community as a
            ``(c, 2)`` endpoint array, served from the handle's lazily
            built, update-surviving hierarchy index.

        Raises:
            Overloaded: shed by admission control.
            TypeError: ``handle`` is not a :class:`TrussHandle`.
            ValueError: the handle is already closed.
            RuntimeError: the scheduler is closed.
        """
        t = time.perf_counter()
        return self._admit(_Request(
            kind="communities", tenant=tenant, future=Future(), t_enq=t,
            handle=self._check_handle(handle), k=int(k),
            t_deadline=self._deadline_for(t, deadline_ms)))

    # ------------------------------------------------------------- the loop --
    def _loop(self) -> None:
        while True:
            self._heartbeat = time.perf_counter()
            with self._work:
                if self._wedged is not None:
                    return
                if not self._inbox and not self._closed:
                    due = self._seconds_to_deadline()
                    if due is None or due > 0:
                        self._work.wait(timeout=due)
                batch = list(self._inbox)
                self._inbox.clear()
                closing = self._closed
                drain = self._drain
            if closing and not drain:
                self._cancel_all(batch)
                return
            self._route(batch)
            self._service_handles()
            self._dispatch_buckets(force=closing)
            with self._lock:
                if (self._closed and not self._inbox and not self._buckets
                        and not self._hqueues):
                    return

    def _seconds_to_deadline(self):  # trusslint: holds[_lock]
        """Time until the next bucket must dispatch; None when no bucket waits.

        The deadline of a bucket is ``oldest.t_enq + max_delay``; a bucket
        at ``max_batch`` is due immediately.  Called under the lock.
        """
        if not self._buckets:
            return None
        now = time.perf_counter()
        due = None
        for entries in self._buckets.values():
            if len(entries) >= self.max_batch:
                return 0.0
            oldest = entries[0][1].t_enq
            d = max(0.0, oldest + self.max_delay - now)
            due = d if due is None else min(due, d)
        return due

    # ------------------------------------------------------------ watchdog --
    def _watchdog(self) -> None:
        period = max(0.01, self.watchdog_s / 4)
        while not self._watchdog_stop.wait(period):
            with self._lock:
                depth = self._depth
                closed = self._closed
            if closed or depth == 0:
                continue
            stalled = time.perf_counter() - self._heartbeat
            if stalled < self.watchdog_s:
                continue
            self._trip_watchdog(stalled)
            return

    def _trip_watchdog(self, stalled: float) -> None:
        """Fail fast: the tick loop is wedged with work queued.

        Captures the scheduler thread's stack, marks the scheduler wedged
        and closed, and fails every outstanding future with a typed
        :class:`Wedged` carrying the diagnostics.  The engine is *not*
        touched (it is owned by the stuck thread and is not thread-safe);
        its state is undefined after a wedge and the scheduler will not
        admit further work.
        """
        with self._lock:
            t = self._thread
        stack = "<scheduler thread stack unavailable>"
        if t is not None and t.ident is not None:
            frames = sys._current_frames()
            if t.ident in frames:
                stack = "".join(traceback.format_stack(frames[t.ident]))
        with self._work:
            diag = (
                f"scheduler tick loop wedged: no progress for "
                f"{stalled:.2f}s (watchdog_s={self.watchdog_s}, depth="
                f"{self._depth}); counters={dict(self._counters)}; "
                f"scheduler thread stack:\n{stack}")
            self._counters["watchdog_trips"] += 1
            self._wedged = diag
            self._closed = True
            outstanding = list(self._outstanding)
            self._outstanding.clear()
            self._depth = 0
            self._inflight.clear()
            self._buckets.clear()
            self._hqueues.clear()
            self._inbox.clear()
            self._work.notify_all()
        exc = Wedged(diag)
        for req in outstanding:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass    # resolved in the race window; either answer is fine

    # ----------------------------------------------------------- completion --
    def _finish(self, req: _Request, value=None, exc=None) -> None:
        with self._lock:
            if req not in self._outstanding:
                # already finalized (watchdog trip or cancellation) — the
                # bookkeeping is done; at most defensively resolve below
                pass
            else:
                self._outstanding.discard(req)
                self._depth -= 1
                left = self._inflight.get(req.tenant, 1) - 1
                if left <= 0:
                    self._inflight.pop(req.tenant, None)
                else:
                    self._inflight[req.tenant] = left
                self._counters["done"] += 1
                if exc is not None:
                    self._counters["errors"] += 1
                    if isinstance(exc, DeadlineExceeded):
                        self._counters["deadline_exceeded"] += 1
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(value)
        except InvalidStateError:
            pass    # the watchdog failed this future first; keep its answer

    def _cancel_all(self, batch) -> None:
        """close(drain=False): reject everything queued with typed Cancelled.

        The dispatch structures are guarded state (`stats()` can race this
        teardown from another thread), so they are snapshotted-and-swapped
        under the lock; the engine discards then run outside it.  Every
        future resolves — with :class:`Cancelled` carrying the request
        kind and queue position — so no caller is ever left hanging.
        """
        pending = list(batch)
        with self._lock:
            buckets, self._buckets = self._buckets, {}
            hqueues, self._hqueues = self._hqueues, {}
        for entries in buckets.values():
            for ticket, r in entries:
                self.engine.discard(ticket)
                pending.append(r)
        for q in hqueues.values():
            pending.extend(q)
        for pos, req in enumerate(pending):
            with self._lock:
                if req not in self._outstanding:
                    continue
                self._outstanding.discard(req)
                self._depth -= 1
                self._counters["cancelled"] += 1
            try:
                req.future.set_exception(Cancelled(req.kind, pos))
            except InvalidStateError:
                pass    # the watchdog beat us to this future
        with self._lock:
            self._inflight.clear()

    def _stage(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._stages[name]
            s["count"] += 1
            s["seconds"] += seconds
            s["max_seconds"] = max(s["max_seconds"], seconds)

    # ----------------------------------------------------------- resilience --
    def _count_retry(self) -> None:
        with self._lock:
            self._counters["retries"] += 1

    def _expired(self, req: _Request, now: float | None = None) -> bool:
        return req.t_deadline is not None and \
            (time.perf_counter() if now is None else now) >= req.t_deadline

    @staticmethod
    def _deadline_exc(req: _Request) -> DeadlineExceeded:
        over = (time.perf_counter() - req.t_deadline) * 1e3
        return DeadlineExceeded(
            f"{req.kind} request missed its deadline by {over:.1f}ms",
            kind=req.kind)

    def _ensure_healthy(self, handle: TrussHandle) -> None:
        """Heal a quarantined handle before serving it (§15).

        Quarantined handles are not served and not abandoned: the next
        request triggers another rebuild attempt, so queued requests wait
        for recovery rather than fail — they only fail when the rebuild
        itself keeps failing (the exception propagates to their futures).
        """
        with self._lock:
            suspect = handle.hid in self._quarantined
        if suspect:
            self._heal(handle, None)

    def _heal(self, handle: TrussHandle, batches):
        """Quarantine + rebuild from the retained CSR (+ re-apply updates).

        The recovery action for :class:`IntegrityError` (DESIGN.md §15):
        the handle is quarantined, its state rediscovered from scratch
        (``IncrementalTruss.rebuild`` — a full ``pkt`` over the retained
        edge list), the not-yet-committed update ``batches`` re-applied
        (``None`` when the violating repair already committed), and the
        invariant sweep re-run.  Two attempts; on repeated failure the
        handle *stays* quarantined and the error propagates to the
        requests' futures.  Returns the re-applied ``UpdateStats`` (or
        ``None``).
        """
        hid = handle.hid
        inc = handle._inc  # noqa: SLF001 — the scheduler owns its handles
        with self._lock:
            self._quarantined.add(hid)
            self._counters["heals"] += 1
        t0 = time.perf_counter()
        ladders = {k: self._ladders[k] for k in ("region", "support")}

        def attempt(rungs):
            ov = {**_REGION_OVERRIDES[rungs["region"]],
                  **_SUPPORT_OVERRIDES[rungs["support"]]}
            with override_attrs(inc, **ov):
                inc.rebuild()
                return self.engine.update_many(handle, batches) \
                    if batches else None

        for final in (False, True):
            try:
                st = run_with_resilience(
                    attempt, ladders=ladders, primary="support",
                    policy=self.retry, kind="update",
                    on_retry=self._count_retry)
                if self.invariant_sample:
                    self._nchecks += 1
                    inc.check_invariants(sample=self.invariant_sample,
                                         seed=self._nchecks)
            except Exception:           # noqa: BLE001 — one more try, then up
                if final:
                    with self._lock:
                        self._counters["heal_failures"] += 1
                    self._stage("heal", time.perf_counter() - t0)
                    raise
                continue
            with self._lock:
                self._quarantined.discard(hid)
            self._stage("heal", time.perf_counter() - t0)
            return st

    # ------------------------------------------------------------- routing --
    def _route(self, batch) -> None:
        """Admit a tick's inbox into the dispatch structures (build stage)."""
        for req in batch:
            now = time.perf_counter()
            self._stage("queue_wait", now - req.t_enq)
            if self._expired(req, now):
                self._finish(req, exc=self._deadline_exc(req))
                continue
            if req.kind == "submit":
                try:
                    t0 = time.perf_counter()
                    ticket = self.engine.submit(req.edges)
                    self._stage("build", time.perf_counter() - t0)
                    key = self.engine.bucket_of(ticket)
                except Exception as e:          # noqa: BLE001 — to future
                    self._finish(req, exc=e)
                    continue
                if key is None:
                    # resolved at submit (empty graph / engine auto-flush)
                    self._finish(req, value=self.engine.result(ticket))
                else:
                    with self._lock:
                        self._buckets.setdefault(key, []).append(
                            (ticket, req))
            elif req.kind == "open":
                try:
                    t0 = time.perf_counter()
                    h = self._resilient_open(req)
                    self._stage("open", time.perf_counter() - t0)
                except Exception as e:          # noqa: BLE001 — to future
                    self._finish(req, exc=e)
                    continue
                self._finish(req, value=h)
            else:                               # update / query / communities
                with self._lock:
                    self._hqueues.setdefault(
                        req.handle.hid, deque()).append(req)

    def _resilient_open(self, req: _Request) -> TrussHandle:
        """Open under the support-site ladder (engine attrs overridden).

        A demoted rung builds the handle with fallback support executors;
        the handle's own attributes are then reset to the engine defaults
        so it is not permanently demoted.
        """
        def call(rungs):
            ov = _SUPPORT_OVERRIDES[rungs["support"]]
            with override_attrs(self.engine, **ov):
                return self.engine.open(req.edges,
                                        local_frac=req.local_frac)
        h = run_with_resilience(
            call, ladders={"support": self._ladders["support"]},
            primary="support", policy=self.retry, deadline=req.t_deadline,
            kind="open", on_retry=self._count_retry)
        h._inc.support_mode = self.engine.support_mode  # noqa: SLF001
        h._inc.table_mode = self.engine.table_mode      # noqa: SLF001
        return h

    # ------------------------------------------------- handle-op servicing --
    def _service_handles(self) -> None:
        """Drain every handle queue FIFO, coalescing update runs (§12).

        Per handle, consecutive updates (up to the next query) compose into
        one ``engine.update_many`` repair; queries then run against exactly
        the state their admission order promises.
        """
        with self._lock:
            if not self._hqueues:
                return
            queues, self._hqueues = self._hqueues, {}
        for q in queues.values():
            while q:
                run = []
                while q and q[0].kind == "update":
                    run.append(q.popleft())
                if run:
                    self._run_update(run)
                if q:
                    self._run_query(q.popleft())

    def _run_update(self, run) -> None:
        handle = run[0].handle
        now = time.perf_counter()
        live = []
        for r in run:
            if self._expired(r, now):
                # not yet dispatched: excluded from the composed batch, so
                # the deadline rejection is exact (nothing half-applied)
                self._finish(r, exc=self._deadline_exc(r))
            else:
                live.append(r)
        if not live:
            return
        batches = [(r.add, r.remove) for r in live]
        deadlines = [r.t_deadline for r in live if r.t_deadline is not None]
        deadline = min(deadlines) if deadlines else None
        t0 = time.perf_counter()
        try:
            self._ensure_healthy(handle)
            try:
                st = self._resilient_update(handle, batches, deadline)
            except IntegrityError:
                # detected before commit: state untouched (batch-scoped
                # commit), so rebuild and re-apply the whole batch
                st = self._heal(handle, batches)
            else:
                if self.invariant_sample:
                    try:
                        self._nchecks += 1
                        handle._inc.check_invariants(  # noqa: SLF001
                            sample=self.invariant_sample, seed=self._nchecks)
                    except IntegrityError:
                        # committed state is suspect: rebuild in place (the
                        # batch is already in the edge list; not re-applied)
                        self._heal(handle, None)
        except Exception as e:                  # noqa: BLE001 — to futures
            for r in live:
                self._finish(r, exc=e)
            return
        self._stage("repair", time.perf_counter() - t0)
        with self._lock:
            self._counters["dispatches"] += 1
            self._counters["coalesced_updates"] += len(live) - 1
        for r in live:
            self._finish(r, value=st)

    def _resilient_update(self, handle, batches, deadline):
        """One composed repair under the region+support ladders."""
        inc = handle._inc  # noqa: SLF001 — the scheduler owns its handles

        def call(rungs):
            ov = {**_REGION_OVERRIDES[rungs["region"]],
                  **_SUPPORT_OVERRIDES[rungs["support"]]}
            with override_attrs(inc, **ov):
                return self.engine.update_many(handle, batches)
        return run_with_resilience(
            call,
            ladders={k: self._ladders[k] for k in ("region", "support")},
            primary="region", policy=self.retry, deadline=deadline,
            kind="update", on_retry=self._count_retry)

    def _run_query(self, req: _Request) -> None:
        if self._expired(req):
            self._finish(req, exc=self._deadline_exc(req))
            return
        t0 = time.perf_counter()
        try:
            self._ensure_healthy(req.handle)
            if req.kind == "query":
                out = req.handle.query(req.edges)
            else:
                out = self._resilient_communities(req)
        except Exception as e:                  # noqa: BLE001 — to future
            self._finish(req, exc=e)
            return
        self._stage("query", time.perf_counter() - t0)
        if self._expired(req):
            # read-only: dropping the late result is safe and keeps the
            # deadline contract exact
            self._finish(req, exc=self._deadline_exc(req))
            return
        self._finish(req, value=out)

    def _resilient_communities(self, req: _Request):
        """Community listing under the hierarchy-site ladder."""
        def call(rungs):
            rung = rungs["hierarchy"]
            return req.handle.communities(
                req.k, hier_mode=None if rung == "default" else rung)
        return run_with_resilience(
            call, ladders={"hierarchy": self._ladders["hierarchy"]},
            primary="hierarchy", policy=self.retry,
            deadline=req.t_deadline, kind="communities",
            on_retry=self._count_retry)

    # ------------------------------------------------------ bucket dispatch --
    def _dispatch_buckets(self, *, force: bool = False) -> None:
        """Flush every due bucket: full, past deadline, or forced (drain).

        Each bucket flush runs under the flush-site ladder: retries stay
        on the engine's configured executors, demotion falls back to the
        ``chunked+torch`` pair and finally to the host-numpy reference —
        all bitwise-identical.  Requests already past their deadline are
        rejected before the dispatch (and their tickets discarded);
        read-only submits are deadline-checked again at delivery.
        """
        now = time.perf_counter()
        with self._lock:
            due = []
            for key in list(self._buckets):
                entries = self._buckets[key]
                oldest = entries[0][1].t_enq
                if (force or len(entries) >= self.max_batch
                        or now - oldest >= self.max_delay):
                    due.append((key, entries))
                    del self._buckets[key]
        for key, entries in due:
            now = time.perf_counter()
            live = []
            for ticket, r in entries:
                if self._expired(r, now):
                    self.engine.discard(ticket)
                    self._finish(r, exc=self._deadline_exc(r))
                else:
                    live.append((ticket, r))
            if not live:
                continue
            t0 = time.perf_counter()

            def flush(rungs, key=key):
                rung = rungs["flush"]
                if rung == "host":
                    self.engine.flush_host(only=[key])
                else:
                    m, sm = rung.split("+")
                    self.engine.flush(only=[key], mode=m, support_mode=sm)
            try:
                run_with_resilience(
                    flush, ladders={"flush": self._ladders["flush"]},
                    primary="flush", policy=self.retry, kind="submit",
                    on_retry=self._count_retry)
            except Exception as e:              # noqa: BLE001 — to futures
                for ticket, r in live:
                    self.engine.discard(ticket)
                    self._finish(r, exc=e)
                continue
            self._stage("dispatch", time.perf_counter() - t0)
            with self._lock:
                self._counters["dispatches"] += 1
            for ticket, req in live:
                t1 = time.perf_counter()
                try:
                    out = self.engine.result(ticket)
                except Exception as e:          # noqa: BLE001 — to future
                    self._finish(req, exc=e)
                    continue
                self._stage("readback", time.perf_counter() - t1)
                if self._expired(req):
                    # read-only: the late result is dropped, not delivered
                    self._finish(req, exc=self._deadline_exc(req))
                else:
                    self._finish(req, value=out)

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        """Snapshot of scheduler counters, stage timing, and resilience state.

        Returns:
            A JSON-serializable dict: request ``counters`` (per kind, plus
            ``shed``/``done``/``errors``/``cancelled``/``dispatches``/
            ``coalesced_updates``/``retries``/``deadline_exceeded``/
            ``heals``/``heal_failures``/``watchdog_trips``), current
            ``depth`` and per-tenant ``inflight``, ``buckets_waiting``,
            per-``stages`` timing (``count``/``seconds``/``max_seconds``
            for queue wait, operand build, device dispatch, readback,
            open, repair, query, heal), per-site ``resilience`` ladder
            state (current rung, failures, demotions, promotions, probes),
            ``quarantined`` handle ids, ``wedged`` (watchdog diagnostics
            or ``None``), and the engine's own counters under ``engine``.
        """
        with self._lock:
            snap = {
                "counters": dict(self._counters),
                "depth": self._depth,
                "inflight": dict(self._inflight),
                "buckets_waiting": {
                    str(tuple(k)): len(v) for k, v in self._buckets.items()},
                "stages": {k: dict(v) for k, v in self._stages.items()},
                "quarantined": sorted(self._quarantined),
                "wedged": self._wedged,
            }
        snap["resilience"] = {site: ladder.snapshot()
                              for site, ladder in self._ladders.items()}
        eng = {}
        for k, v in self.engine.stats.items():
            if isinstance(v, set):
                v = len(v)
            elif isinstance(v, dict):
                # per size class (``bucket_launches``): JSON-safe keys
                v = {str(tuple(key)): dict(c) for key, c in dict(v).items()}
            eng[k] = v
        snap["engine"] = eng
        return snap
