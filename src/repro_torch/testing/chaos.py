"""Deterministic fault injection for the serving stack (DESIGN.md §15).

The port's copy of the JAX package's ``testing/chaos.py`` (pure Python; the
port imports nothing of ``repro``).  Every expensive dispatch site in the
serving path — engine flush, region re-peel, support build, hierarchy
flood — calls :func:`fault_point` just before it commits to real work.
When no :class:`FaultPlan` is active the call is a single
global-load-and-compare and injects nothing, so the hooks are safe to
leave in production code.  When a plan *is* active (via the plan's context
manager, or :func:`activate` for long-lived processes), each hook consults
the plan's seeded rules and may:

- ``raise``   — throw a typed, transient :class:`InjectedFault`;
- ``delay``   — sleep for a configured duration before proceeding;
- ``corrupt`` — return the string ``"corrupt"``, instructing the call
  site to deterministically perturb its own intermediate state in a way
  the existing integrity checks are guaranteed to detect.

Rules fire either a fixed number of times (``times=N``, fully
deterministic — the backbone of the test matrix) or at a seeded
Bernoulli ``rate`` (the chaos bench's swept fault rates).  All decisions
derive from ``random.Random(seed)`` and the arrival order of hook calls,
so a single-threaded scheduler replays identically under a fixed seed.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

# the dispatch sites wrapped by fault_point hooks, in serving-path order
DISPATCH_SITES = ("flush", "region", "support", "hierarchy")

_MODES = ("raise", "delay", "corrupt")


class InjectedFault(RuntimeError):
    """Transient fault thrown by a ``raise``-mode rule at a dispatch site.

    Carries the ``site`` and ``rung`` it fired at so the resilience layer
    can attribute the failure to the right degradation ladder.
    """

    def __init__(self, site: str, rung: str | None):
        super().__init__(f"injected fault at dispatch site {site!r} (rung {rung!r})")
        self.site = site
        self.rung = rung


@dataclass
class _Rule:
    site: str
    mode: str = "raise"
    times: int | None = None  # fire the first N matching calls; None = use rate
    rate: float = 0.0  # Bernoulli fire probability when times is None
    delay_s: float = 0.0  # sleep duration for mode="delay"
    rung: str | None = None  # only fire when the site runs on this executor rung
    fired: int = 0


@dataclass
class FaultPlan:
    """A seeded, ordered set of fault rules, activated as a context manager.

    >>> plan = FaultPlan(seed=7)
    >>> plan.add("flush", mode="raise", times=1)      # doctest: +SKIP
    >>> with plan:                                    # doctest: +SKIP
    ...     ...  # first engine flush raises InjectedFault, rest run clean
    """

    seed: int = 0
    _rules: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _rng: random.Random = field(default=None, repr=False)
    calls: dict = field(default_factory=dict)
    injected: dict = field(default_factory=dict)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def add(
        self,
        site: str,
        *,
        mode: str = "raise",
        times: int | None = None,
        rate: float = 0.0,
        delay_s: float = 0.0,
        rung: str | None = None,
    ) -> "FaultPlan":
        """Register a rule at ``site``; returns self for chaining."""
        if site not in DISPATCH_SITES:
            raise ValueError(f"unknown dispatch site {site!r}; expected one of {DISPATCH_SITES}")
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; expected one of {_MODES}")
        if times is None and not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if times is not None and times < 0:
            raise ValueError(f"times must be >= 0, got {times}")
        rule = _Rule(site=site, mode=mode, times=times, rate=rate, delay_s=delay_s, rung=rung)
        self._rules.setdefault(site, []).append(rule)
        return self

    @classmethod
    def uniform(
        cls,
        rate: float,
        *,
        sites: tuple = DISPATCH_SITES,
        seed: int = 0,
        mode: str = "raise",
        delay_s: float = 0.0,
    ) -> "FaultPlan":
        """A plan injecting ``mode`` faults at ``rate`` across ``sites``."""
        plan = cls(seed=seed)
        for site in sites:
            plan.add(site, mode=mode, rate=rate, delay_s=delay_s)
        return plan

    # -- hook protocol -------------------------------------------------------

    def _hit(self, site: str, rung: str | None) -> str | None:
        delay = None
        outcome = None
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            for rule in self._rules.get(site, ()):
                if rule.rung is not None and rule.rung != rung:
                    continue
                if rule.times is not None:
                    fire = rule.fired < rule.times
                else:
                    fire = rule.rate > 0.0 and self._rng.random() < rule.rate
                if not fire:
                    continue
                rule.fired += 1
                self.injected[site] = self.injected.get(site, 0) + 1
                if rule.mode == "raise":
                    raise InjectedFault(site, rung)
                if rule.mode == "delay":
                    delay = rule.delay_s
                else:  # corrupt
                    outcome = "corrupt"
                break
        if delay:
            time.sleep(delay)  # outside the lock: other hook calls must not block
        return outcome

    def stats(self) -> dict:
        """Per-site hook-call and injection counts (snapshot)."""
        with self._lock:
            return {"calls": dict(self.calls), "injected": dict(self.injected)}

    # -- activation ----------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        activate(self)
        return self

    def __exit__(self, *exc) -> None:
        deactivate(self)


_active: FaultPlan | None = None


def activate(plan: FaultPlan) -> None:
    """Install ``plan`` as the process-global fault plan."""
    global _active
    if _active is not None and _active is not plan:
        raise RuntimeError("a FaultPlan is already active; deactivate it first")
    _active = plan


def deactivate(plan: FaultPlan | None = None) -> None:
    """Remove the active fault plan (no-op if ``plan`` is not the active one)."""
    global _active
    if plan is None or _active is plan:
        _active = None


def fault_point(site: str, rung: str | None = None) -> str | None:
    """Dispatch-site hook: no-op unless a plan is active.

    Returns ``"corrupt"`` when a corrupt-mode rule fires (the call site
    applies its own detectable perturbation), else ``None``.  Raises
    :class:`InjectedFault` for raise-mode rules; sleeps for delay-mode.
    """
    plan = _active
    if plan is None:
        return None
    return plan._hit(site, rung)
