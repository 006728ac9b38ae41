"""Retry, deadline, and executor-degradation machinery (DESIGN.md §15).

The port's copy of the JAX package's ``serve/resilience.py``.  The
scheduler routes every expensive dispatch — engine flush, handle update
(region re-peel + support rebuild), open, community query — through
:func:`run_with_resilience`, which layers three recoveries on top of the
engine's existing exception safety:

- **bounded retry** with exponential backoff and deterministic jitter
  (:class:`RetryPolicy`) for *transient* failures (injected faults,
  runtime/dispatch errors).  Programming errors (``ValueError`` etc.),
  :class:`~repro_torch.core.truss_inc.IntegrityError`, and
  :class:`DeadlineExceeded` are never retried;
- a per-site **degradation ladder** (:class:`Ladder`): consecutive
  failures demote the site to a slower but bitwise-identical executor
  rung (CUDA kernels → torch ops → host numpy); after enough consecutive
  successes at a demoted rung the ladder *probes* the faster rung on live
  traffic — probe failures fall back silently without charging the
  request — and re-promotes after consecutive probe successes;
- **deadline enforcement**: an absolute deadline aborts the retry loop
  (and any pending backoff sleep) with a typed :class:`DeadlineExceeded`.

Every rung pairing in the ladders is one of the repo's parity-gated
executor axes, so degradation never changes results — only latency.

Every exception that is not in :data:`PERMANENT_ERRORS` (or a deadline)
counts as transient, as in the JAX package, with one addition of the port:
a device fault (:data:`DEVICE_ERRORS`) is permanent.  A kernel that does
not build, load or launch raises
:class:`~repro_torch.kernels.cuda_build.KernelError`, and a CUDA error that
a later call reports (an illegal memory access poisons the context) raises
``torch.AcceleratorError``.  Neither is retried, demoted past or swallowed
by a probe: the error reaches the request's future, so no request whose
tensors are on the card is answered by the plain versions or the host
because a kernel failed.  Injected faults stay transient and walk the
ladder exactly as in the JAX package.

An out-of-memory error stays transient, as in the JAX package: it is
retried, then demoted.  Demotion does not cure it on the card: the torch
executors build the wedge tables that the kernel path never builds (at
Graph500 scale 17, 2^29-row tables of about 8 GiB each), so the
``chunked+torch`` rung needs more device memory, not less, and the ladder
ends at the host rung, which needs no device.
"""

from __future__ import annotations

import contextlib
import time
import zlib
from dataclasses import dataclass

import torch

from repro_torch.core.truss_inc import IntegrityError
from repro_torch.kernels.cuda_build import KernelError

#: device faults: a kernel that did not build, load or launch, and a CUDA
#: error reported by a later call (torch 2.8 and newer type it)
DEVICE_ERRORS = (KernelError,) + tuple(
    t for t in (getattr(torch, "AcceleratorError", None),) if t is not None)

#: exception types never retried: caller bugs, integrity violations
#: (healed at a higher layer), device faults, and deadline aborts
PERMANENT_ERRORS = (ValueError, TypeError, KeyError, IntegrityError,
                    *DEVICE_ERRORS)


class DeadlineExceeded(RuntimeError):
    """A request missed its deadline before (or while) being served.

    Attributes ``kind`` (request kind, when known) and ``deadline_ms``
    (the budget that was exceeded) support caller-side triage.
    """

    def __init__(self, message: str, *, kind: str | None = None, deadline_ms: float | None = None):
        super().__init__(message)
        self.kind = kind
        self.deadline_ms = deadline_ms


class Wedged(RuntimeError):
    """The scheduler tick loop stopped making progress (watchdog trip).

    The message carries diagnostics: the stalled duration, a snapshot of
    the scheduler counters, and the scheduler thread's current stack.
    """


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``backoff(site, attempt)`` returns ``base_delay_s * 2**(attempt-1)``
    scaled by a jitter factor in ``[1, 2)`` derived from
    ``crc32(seed:site:attempt)`` — deterministic across runs, decorrelated
    across sites — and clamped to ``max_delay_s``.
    """

    max_retries: int = 2
    base_delay_s: float = 0.002
    max_delay_s: float = 0.050
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 <= base_delay_s <= max_delay_s")

    def backoff(self, site: str, attempt: int) -> float:
        """Backoff delay in seconds before retry number ``attempt`` (1-based)."""
        frac = zlib.crc32(f"{self.seed}:{site}:{attempt}".encode()) / 2**32
        return min(self.max_delay_s, self.base_delay_s * 2 ** (attempt - 1) * (1.0 + frac))


class Ladder:
    """Health-scored executor degradation ladder for one dispatch site.

    ``rungs`` is ordered fastest-first; position 0 is the configured
    executor.  ``demote_after`` consecutive failures move one rung down.
    After ``probe_after`` consecutive successes at a demoted rung the
    ladder requests a *probe*: the next dispatch runs one rung up.  After
    ``promote_after`` consecutive probe successes the ladder moves back
    up; a probe failure resets the probe streak and stays demoted.
    """

    def __init__(
        self,
        rungs: tuple,
        *,
        demote_after: int = 2,
        probe_after: int = 3,
        promote_after: int = 2,
    ):
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        if min(demote_after, probe_after, promote_after) < 1:
            raise ValueError("demote_after/probe_after/promote_after must be >= 1")
        self.rungs = tuple(rungs)
        self.pos = 0
        self.demote_after = demote_after
        self.probe_after = probe_after
        self.promote_after = promote_after
        self._fails = 0  # consecutive failures at the current rung
        self._streak = 0  # consecutive successes at the current rung
        self._probe_streak = 0  # consecutive successful probes of the rung above
        self.failures = 0
        self.demotions = 0
        self.promotions = 0
        self.probes = 0
        self.probe_failures = 0

    def current(self):
        """The rung dispatches should run at (ignoring probes)."""
        return self.rungs[self.pos]

    def should_probe(self) -> bool:
        """True when the next dispatch should try the rung above."""
        return self.pos > 0 and self._streak >= self.probe_after

    def probe_rung(self):
        """The rung a probe dispatch runs at (one above current)."""
        return self.rungs[self.pos - 1]

    def record_success(self) -> None:
        """A dispatch at the current rung completed."""
        self._fails = 0
        self._streak += 1

    def record_failure(self) -> None:
        """A dispatch at the current rung failed; demote when unhealthy."""
        self.failures += 1
        self._streak = 0
        self._fails += 1
        if self._fails >= self.demote_after and self.pos < len(self.rungs) - 1:
            self.pos += 1
            self.demotions += 1
            self._fails = 0
            self._probe_streak = 0

    def record_probe_success(self) -> None:
        """A probe of the rung above succeeded; promote on a full streak."""
        self.probes += 1
        self._probe_streak += 1
        if self._probe_streak >= self.promote_after:
            self.pos -= 1
            self.promotions += 1
            self._fails = 0
            self._streak = 0
            self._probe_streak = 0

    def record_probe_failure(self) -> None:
        """A probe of the rung above failed; stay demoted, reset streaks."""
        self.probes += 1
        self.probe_failures += 1
        self._probe_streak = 0
        self._streak = 0

    def snapshot(self) -> dict:
        """Counters + current rung, for ``TrussScheduler.stats()``."""
        return {
            "rung": self.rungs[self.pos],
            "rungs": list(self.rungs),
            "failures": self.failures,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "probes": self.probes,
            "probe_failures": self.probe_failures,
        }


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying (possibly at a lower rung)."""
    return not isinstance(exc, PERMANENT_ERRORS) and not isinstance(exc, DeadlineExceeded)


@contextlib.contextmanager
def override_attrs(obj, **attrs):
    """Temporarily set attributes on ``obj``, restoring on exit.

    The mechanism by which ladder rungs are applied: executor-mode
    attributes (``mode``, ``support_mode``, ``table_mode``,
    ``host_peel_max``) are overridden for the duration of one dispatch.
    """
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield obj
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


def run_with_resilience(
    call,
    *,
    ladders: dict,
    primary: str,
    policy: RetryPolicy,
    deadline: float | None = None,
    kind: str | None = None,
    on_retry=None,
):
    """Run ``call(rungs)`` under retry + ladder + deadline policy.

    ``call`` receives ``{site: rung}`` built from each ladder's current
    (or probe) rung and must dispatch accordingly.  Transient failures
    are charged to the ladder named by the exception's ``site`` attribute
    (falling back to ``primary``), retried up to ``policy.max_retries``
    times with backoff; probe failures retry immediately at the safe rung
    without consuming the request's retry budget, except a device fault
    (:data:`DEVICE_ERRORS`), which is raised from a probe too.
    ``deadline`` is an absolute ``time.perf_counter()`` timestamp;
    crossing it — including via a pending backoff sleep — raises
    :class:`DeadlineExceeded`.
    ``on_retry`` is called once per charged retry (scheduler counters).
    """
    attempt = 0
    while True:
        if deadline is not None and time.perf_counter() >= deadline:
            raise DeadlineExceeded(f"deadline exceeded before {primary} dispatch", kind=kind)
        probe_site = None
        rungs = {}
        for site, ladder in ladders.items():
            if probe_site is None and ladder.should_probe():
                probe_site = site
                rungs[site] = ladder.probe_rung()
            else:
                rungs[site] = ladder.current()
        try:
            out = call(rungs)
        except Exception as e:
            if probe_site is not None:
                # probes ride live traffic but must not fail it: fall back
                # to the demoted rung immediately, uncharged -- unless the
                # kernels themselves failed
                ladders[probe_site].record_probe_failure()
                if not isinstance(e, DEVICE_ERRORS):
                    continue
            if not is_transient(e):
                raise
            site = getattr(e, "site", None)
            ladders.get(site, ladders[primary]).record_failure()
            attempt += 1
            if attempt > policy.max_retries:
                raise
            if on_retry is not None:
                on_retry()
            delay = policy.backoff(site or primary, attempt)
            if deadline is not None and time.perf_counter() + delay >= deadline:
                raise DeadlineExceeded(
                    f"deadline exceeded during {primary} retry backoff", kind=kind
                ) from e
            time.sleep(delay)
            continue
        for site, ladder in ladders.items():
            if site == probe_site:
                ladder.record_probe_success()
            else:
                ladder.record_success()
        return out
