"""Port parity: chaos hardening — fault injection, retry and ladder, heal,
deadlines, watchdog (``repro_torch.serve.resilience``, ``scheduler``,
``testing/chaos.py``).

The first tests mirror ``tests/test_chaos.py`` on the port's scheduler over
a CPU engine (``device="cpu"``), with expected results from the JAX
package; the port's rungs are named ``kernel``/``torch`` where the JAX
package says ``pallas``/``jnp``.  The last one drives the same seeded
traffic under the same fault plan through the JAX package's scheduler and
the port's, and holds results, counters and ladders equal.
"""

import dataclasses
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.pkt import truss_pkt as ref_truss_pkt
from repro.serve import TrussEngine as RefEngine

from repro_torch.core.truss_inc import IntegrityError
from repro_torch.kernels import cuda_build
from repro_torch.kernels import peel as peel_kernel
from repro_torch.kernels import support as support_kernel
from repro_torch.kernels.cuda_build import KernelError
from repro_torch.serve import (Cancelled, DeadlineExceeded, Ladder,
                               Overloaded, RetryPolicy, TrussEngine,
                               TrussScheduler, Wedged)
from repro_torch.serve.resilience import is_transient, run_with_resilience
from repro_torch.testing.chaos import (DISPATCH_SITES, FaultPlan,
                                       InjectedFault, fault_point)


def _er_edges(n, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(mask, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def _expected(edges):
    """The JAX package's trussness of ``edges``, aligned to its rows."""
    e = np.asarray(edges, np.int64)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    n = int(e.max()) + 1
    uniq = np.unique(lo * n + hi)
    E = np.stack([uniq // n, uniq % n], axis=1)
    t = ref_truss_pkt(E)
    return t[np.searchsorted(uniq, lo * n + hi)]


def _sched(**kw):
    """A port scheduler over a CPU engine."""
    return TrussScheduler(device="cpu", **kw)


_FAST = RetryPolicy(max_retries=2, base_delay_s=0.001, max_delay_s=0.002)


# ------------------------------------------------------- fault-plan harness --


def test_fault_plan_times_rules_fire_exactly_n_times():
    plan = FaultPlan().add("flush", times=2)
    with plan:
        for _ in range(2):
            with pytest.raises(InjectedFault) as ei:
                fault_point("flush", rung="kernel")
            assert ei.value.site == "flush" and ei.value.rung == "kernel"
        assert fault_point("flush") is None
    st = plan.stats()
    assert st["calls"]["flush"] == 3 and st["injected"]["flush"] == 2


def test_fault_plan_rate_rules_are_seed_deterministic():
    def fire_pattern(seed):
        plan = FaultPlan.uniform(0.3, sites=("region",), seed=seed)
        hits = []
        with plan:
            for _ in range(50):
                try:
                    fault_point("region")
                    hits.append(0)
                except InjectedFault:
                    hits.append(1)
        return hits
    assert fire_pattern(7) == fire_pattern(7)
    assert fire_pattern(7) != fire_pattern(8)
    assert 0 < sum(fire_pattern(7)) < 50


def test_fault_plan_rung_filter_and_modes():
    plan = (FaultPlan()
            .add("flush", rung="kernel", times=5)
            .add("support", mode="corrupt", times=1)
            .add("region", mode="delay", delay_s=0.05, times=1))
    with plan:
        assert fault_point("flush", rung="chunked") is None
        with pytest.raises(InjectedFault):
            fault_point("flush", rung="kernel")
        assert fault_point("support") == "corrupt"
        t0 = time.perf_counter()
        assert fault_point("region") is None
        assert time.perf_counter() - t0 >= 0.04


def test_fault_plan_validation_and_exclusive_activation():
    with pytest.raises(ValueError, match="dispatch site"):
        FaultPlan().add("nonsense")
    with pytest.raises(ValueError, match="fault mode"):
        FaultPlan().add("flush", mode="explode")
    with pytest.raises(ValueError, match="rate"):
        FaultPlan().add("flush", rate=1.5)
    with FaultPlan():
        with pytest.raises(RuntimeError, match="already active"):
            FaultPlan().__enter__()
    assert fault_point("flush") is None


def test_fault_point_is_noop_without_a_plan():
    for site in DISPATCH_SITES:
        assert fault_point(site, rung="anything") is None


# --------------------------------------------------- resilience primitives --


def test_retry_policy_backoff_is_deterministic_and_bounded():
    from repro.serve import RetryPolicy as RefPolicy

    pol = RetryPolicy(max_retries=3, base_delay_s=0.002, max_delay_s=0.01)
    a = [pol.backoff("flush", i) for i in (1, 2, 3)]
    assert a == [pol.backoff("flush", i) for i in (1, 2, 3)]
    assert a[0] >= 0.002 and max(a) <= 0.01
    assert pol.backoff("flush", 1) != pol.backoff("region", 1)
    # the same crc32 jitter as the JAX package's policy
    ref = RefPolicy(max_retries=3, base_delay_s=0.002, max_delay_s=0.01)
    assert a == [ref.backoff("flush", i) for i in (1, 2, 3)]
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)


def test_ladder_demotes_probes_and_repromotes():
    lad = Ladder(("fast", "slow"), demote_after=2, probe_after=2,
                 promote_after=2)
    lad.record_failure()
    assert lad.current() == "fast"
    lad.record_failure()
    assert lad.current() == "slow" and lad.demotions == 1
    lad.record_success()
    assert not lad.should_probe()
    lad.record_success()
    assert lad.should_probe() and lad.probe_rung() == "fast"
    lad.record_probe_failure()
    assert lad.current() == "slow"
    lad.record_success(), lad.record_success()
    lad.record_probe_success()
    lad.record_probe_success()
    assert lad.current() == "fast" and lad.promotions == 1
    assert lad.snapshot()["probe_failures"] == 1


def test_run_with_resilience_retries_transient_only():
    lad = Ladder(("a", "b"))
    calls = []

    def flaky(rungs):
        calls.append(rungs["x"])
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"
    out = run_with_resilience(flaky, ladders={"x": lad}, primary="x",
                              policy=_FAST)
    assert out == "ok" and len(calls) == 3
    assert lad.failures == 2 and lad.demotions == 1
    assert calls == ["a", "a", "b"]

    def buggy(rungs):
        raise ValueError("permanent")
    with pytest.raises(ValueError):
        run_with_resilience(buggy, ladders={"x": Ladder(("a",))},
                            primary="x", policy=_FAST)

    def slow(rungs):
        time.sleep(0.02)
        raise RuntimeError("transient")
    with pytest.raises(DeadlineExceeded):
        run_with_resilience(slow, ladders={"x": Ladder(("a",))}, primary="x",
                            policy=_FAST,
                            deadline=time.perf_counter() + 0.03, kind="q")


# ----------------------------------------- invariant checks + self-healing --


def test_check_invariants_detects_corruption_and_rebuild_heals():
    e = _er_edges(16, 0.4, 9)
    h = TrussEngine(device="cpu").open(e)
    inc = h._inc
    assert inc.check_invariants(sample=1 << 20) == inc.m
    assert inc.check_invariants(sample=8, seed=3) == 8
    t_good = inc.T.copy()
    inc.T[0] += 1
    with pytest.raises(IntegrityError, match="invariant violation"):
        inc.check_invariants(sample=1 << 20)
    inc.rebuild()
    assert np.array_equal(inc.T, t_good)
    inc.S[2] += 3
    with pytest.raises(IntegrityError, match="support disagrees"):
        inc.check_invariants(sample=1 << 20)
    inc.rebuild()
    assert inc.verify()


# ------------------------------------------------- fault-injection matrix --


@pytest.mark.parametrize("times", [1, 2])
def test_flush_faults_are_retried_to_parity(times):
    e = _er_edges(14, 0.4, 20)
    want = _expected(e)
    with FaultPlan().add("flush", times=times):
        with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
            out = sched.submit_async(e).result(timeout=120)
            st = sched.stats()
    assert np.array_equal(out, want)
    assert st["counters"]["retries"] == times
    assert st["resilience"]["flush"]["failures"] == times
    assert st["resilience"]["flush"]["demotions"] == (1 if times >= 2 else 0)


@pytest.mark.parametrize("times", [1, 2])
def test_region_faults_are_retried_to_parity(times):
    e = _er_edges(16, 0.35, 21)
    add = np.array([[0, 9], [1, 10]], np.int64)
    full = np.concatenate([e, add])
    want = _expected(full)
    with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
        h = sched.open_async(e, local_frac=1.0).result(timeout=120)
        with FaultPlan().add("region", times=times):
            stats = sched.update_async(h, add_edges=add).result(timeout=120)
            st = sched.stats()
        q = sched.query_async(h, full).result(timeout=120)
    assert stats is not None
    assert np.array_equal(q, want)
    assert st["counters"]["retries"] == times
    assert st["resilience"]["region"]["failures"] == times


@pytest.mark.parametrize("times", [1, 2])
def test_support_faults_are_retried_to_parity(times):
    e = _er_edges(14, 0.4, 22)
    want = _expected(e)
    with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
        with FaultPlan().add("support", times=times):
            h = sched.open_async(e).result(timeout=120)
            st = sched.stats()
        # a demoted open hands back a handle on the engine's executors
        assert h._inc.support_mode == sched.engine.support_mode
        assert h._inc.table_mode == sched.engine.table_mode
        q = sched.query_async(h, e).result(timeout=120)
    assert np.array_equal(q, want)
    assert st["counters"]["retries"] == times
    assert st["resilience"]["support"]["failures"] == times


@pytest.mark.parametrize("times", [1, 2])
def test_hierarchy_faults_are_retried_to_parity(times):
    e = _er_edges(16, 0.4, 23)
    href = RefEngine().open(e)
    kmax = int(max(2, href.trussness.max()))
    want = href.communities(kmax)
    with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
        h = sched.open_async(e).result(timeout=120)
        with FaultPlan().add("hierarchy", times=times):
            got = sched.communities_async(h, kmax).result(timeout=120)
            st = sched.stats()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert st["counters"]["retries"] == times
    assert st["resilience"]["hierarchy"]["failures"] == times


def test_exhausted_retries_surface_the_typed_injected_fault():
    e = _er_edges(14, 0.4, 24)
    with FaultPlan().add("flush", times=50):
        with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
            f = sched.submit_async(e)
            with pytest.raises(InjectedFault) as ei:
                f.result(timeout=120)
            st = sched.stats()
    assert ei.value.site == "flush"
    assert st["counters"]["errors"] == 1
    assert st["resilience"]["flush"]["demotions"] >= 1


def test_delay_fault_past_deadline_is_a_typed_deadline_error():
    e = _er_edges(14, 0.4, 25)
    with FaultPlan().add("flush", mode="delay", delay_s=0.2, times=1):
        with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
            f = sched.submit_async(e, deadline_ms=60.0)
            with pytest.raises(DeadlineExceeded) as ei:
                f.result(timeout=120)
            st = sched.stats()
    assert ei.value.kind == "submit"
    assert st["counters"]["deadline_exceeded"] == 1


# --------------------------------------------- ladder demotion/re-promotion --


def test_kernel_failure_degrades_to_torch_then_repromotes():
    """Forced kernel-rung flush failures demote to the torch rung
    (``chunked+torch``) with identical outputs, then recovery probes
    re-promote to the kernels."""
    e = _er_edges(14, 0.4, 26)
    want = _expected(e)
    plan = FaultPlan().add("flush", rung="kernel", times=2)
    with plan:
        with _sched(mode="kernel", max_batch=1, max_delay_ms=0.0,
                    retry=_FAST,
                    ladder={"demote_after": 2, "probe_after": 1,
                            "promote_after": 1}) as sched:
            outs = [sched.submit_async(e).result(timeout=120)
                    for _ in range(3)]
            st = sched.stats()
    for out in outs:
        assert np.array_equal(out, want)
    flush = st["resilience"]["flush"]
    assert flush["rungs"] == ["kernel+kernel", "chunked+torch", "host"]
    assert flush["failures"] == 2
    assert flush["demotions"] == 1
    assert flush["probes"] == 1
    assert flush["promotions"] == 1
    assert flush["rung"] == "kernel+kernel"
    assert plan.stats()["injected"]["flush"] == 2


# ------------------------------------------------ device faults are permanent --


def _failing_launch(lib_name):
    """A stand-in for a kernel call whose launch returns a CUDA error."""
    lib = SimpleNamespace(**{f"{lib_name}_error_string":
                             lambda code: b"an illegal memory access"})

    def launch(*args, **kwargs):
        cuda_build.check_launch(lib, lib_name, 700)
    return launch


@pytest.mark.parametrize("site", ["flush", "support"])
def test_kernel_launch_failure_reaches_the_future(site, monkeypatch):
    """A kernel that fails to launch is not retried or demoted past: the
    torch and host rungs would answer without the kernel, so the error
    reaches the request's future and the ladder stays on its first rung."""
    e = _er_edges(14, 0.4, 28)
    if site == "flush":
        monkeypatch.setattr(peel_kernel, "peel_decrement_fold_ref",
                            _failing_launch("peel"))
    else:
        monkeypatch.setattr(support_kernel, "support_accumulate_ref",
                            _failing_launch("support"))
    with _sched(mode="kernel", max_batch=1, max_delay_ms=0.0,
                retry=_FAST) as sched:
        fut = sched.submit_async(e) if site == "flush" else \
            sched.open_async(e)
        with pytest.raises(KernelError, match="kernel launch failed"):
            fut.result(timeout=120)
        st = sched.stats()
    assert st["counters"]["retries"] == 0
    assert st["counters"]["errors"] == 1
    lad = st["resilience"][site]
    assert lad["failures"] == lad["demotions"] == 0
    assert lad["rung"] == lad["rungs"][0]


def test_device_faults_are_raised_from_probes():
    """A probe swallows an injected fault but not a kernel failure."""
    lad = Ladder(("kernel", "torch"), demote_after=1, probe_after=1)
    lad.record_failure()
    lad.record_success()
    assert lad.should_probe()
    calls = []

    def call(rungs):
        calls.append(rungs["x"])
        if rungs["x"] == "kernel":
            raise KernelError("support kernel launch failed")
        return "ok"
    with pytest.raises(KernelError):
        run_with_resilience(call, ladders={"x": lad}, primary="x",
                            policy=_FAST)
    assert calls == ["kernel"] and lad.probe_failures == 1
    assert lad.current() == "torch"

    def injected(rungs):
        calls.append(rungs["x"])
        if rungs["x"] == "kernel":
            raise InjectedFault("flush", "kernel")
        return "ok"
    lad.record_success()
    assert run_with_resilience(injected, ladders={"x": lad}, primary="x",
                               policy=_FAST) == "ok"
    assert calls[1:] == ["kernel", "torch"] and lad.probe_failures == 2


def test_kernel_build_failures_are_kernel_errors(tmp_path, monkeypatch):
    """No compiler, a failing compiler and a launch error all raise
    ``KernelError``, which the ladders treat as permanent."""
    find_nvcc = cuda_build.nvcc_path
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        find_nvcc()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: sys.executable)
    with pytest.raises(KernelError, match="nvcc failed for support"):
        cuda_build.build_all(("support",))
    with pytest.raises(KernelError, match="CUDA error 700"):
        _failing_launch("peel")()
    assert not is_transient(KernelError("x"))
    assert is_transient(InjectedFault("flush", "kernel"))


# ----------------------------------------------------- handle self-healing --


def test_corrupt_injection_heals_via_quarantine_and_rebuild():
    e = _er_edges(16, 0.35, 27)
    add = np.array([[0, 9], [1, 10]], np.int64)
    full = np.concatenate([e, add])
    want = _expected(full)
    with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
        h = sched.open_async(e, local_frac=1.0).result(timeout=120)
        with FaultPlan().add("region", mode="corrupt", times=1):
            stats = sched.update_async(h, add_edges=add).result(timeout=120)
        q = sched.query_async(h, full).result(timeout=120)
        st = sched.stats()
    assert stats is not None
    assert np.array_equal(q, want)
    assert st["counters"]["heals"] == 1
    assert st["counters"]["heal_failures"] == 0
    assert st["quarantined"] == []
    assert h._inc.verify()


def test_repeated_heal_failure_quarantines_then_next_request_recovers():
    e = _er_edges(16, 0.35, 28)
    a1 = np.array([[0, 9]], np.int64)
    a2 = np.array([[1, 10]], np.int64)
    with _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST) as sched:
        h = sched.open_async(e, local_frac=1.0).result(timeout=120)
        with FaultPlan().add("region", mode="corrupt", times=50):
            f = sched.update_async(h, add_edges=a1)
            with pytest.raises(IntegrityError):
                f.result(timeout=120)
            st = sched.stats()
            assert st["counters"]["heal_failures"] >= 1
            assert st["quarantined"] == [h.hid]
        stats = sched.update_async(h, add_edges=a2).result(timeout=120)
        st = sched.stats()
    assert stats is not None
    assert st["quarantined"] == []
    assert st["counters"]["heals"] >= 2
    full = np.concatenate([e, a2])
    assert np.array_equal(h.query(full), _expected(full))
    assert h._inc.verify()


# ------------------------------------------------------------- watchdog --


def test_watchdog_fails_outstanding_futures_with_wedged():
    e = _er_edges(12, 0.4, 29)
    with FaultPlan().add("flush", mode="delay", delay_s=1.5, times=1):
        sched = _sched(max_batch=1, max_delay_ms=0.0, watchdog_s=0.2,
                       retry=_FAST)
        f = sched.submit_async(e)
        with pytest.raises(Wedged, match="wedged"):
            f.result(timeout=30)
        with pytest.raises(Wedged):
            sched.submit_async(e)
        st = sched.stats()
        sched.close()
    assert st["counters"]["watchdog_trips"] == 1
    assert st["wedged"] is not None and "stack" in st["wedged"]
    assert st["depth"] == 0


# ----------------------------------------------------- typed cancellation --


def test_close_never_started_drains_or_cancels_typed():
    e = _er_edges(12, 0.4, 30)
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    f = sched.submit_async(e)
    sched.close(drain=True)
    assert np.array_equal(f.result(timeout=0), _expected(e))

    sched2 = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    f2 = sched2.submit_async(e)
    sched2.close(drain=False)
    assert f2.done() and not f2.cancelled()
    with pytest.raises(Cancelled) as ei:
        f2.result(timeout=0)
    assert ei.value.kind == "submit" and ei.value.position == 0


def test_close_with_inflight_repair_leaves_no_future_unresolved():
    e = _er_edges(16, 0.35, 31)
    add = np.array([[0, 9], [1, 10]], np.int64)
    sched = _sched(max_batch=4, max_delay_ms=1.0, retry=_FAST)
    h = sched.open_async(e, local_frac=1.0).result(timeout=120)
    with FaultPlan().add("region", mode="delay", delay_s=0.4, times=1):
        fu = sched.update_async(h, add_edges=add)
        time.sleep(0.1)
        fq = sched.query_async(h, e[:3])
        sched.close(drain=False)
    assert fu.result(timeout=120) is not None
    assert fq.done()
    with pytest.raises(Cancelled):
        fq.result(timeout=0)
    assert sched.engine._pending == []
    assert sched.stats()["depth"] == 0


# -------------------------------------------------- admission + deadlines --


def test_overloaded_carries_retry_after_hint():
    sched = _sched(start=False, max_batch=4, max_delay_ms=2.0, max_queue=1)
    e = _er_edges(12, 0.4, 32)
    f = sched.submit_async(e)
    with pytest.raises(Overloaded) as ei:
        sched.submit_async(e)
    assert ei.value.retry_after_ms is not None
    assert ei.value.retry_after_ms >= 2.0
    assert "retry after" in str(ei.value)
    sched.close(drain=False)
    assert f.done()


def test_deadline_rejects_pre_dispatch_with_typed_error():
    e = _er_edges(12, 0.4, 33)
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0,
                   deadline_ms=5.0)
    h = sched.engine.open(e)
    m0 = h.m
    fs = sched.submit_async(e)
    fu = sched.update_async(h, add_edges=np.array([[0, 9]], np.int64),
                            deadline_ms=5.0)
    fq = sched.query_async(h, e[:2], deadline_ms=60_000.0)
    time.sleep(0.05)
    sched.start()
    for f, kind in ((fs, "submit"), (fu, "update")):
        with pytest.raises(DeadlineExceeded) as ei:
            f.result(timeout=120)
        assert ei.value.kind == kind
    assert h.m == m0
    assert np.array_equal(fq.result(timeout=120), _expected(e)[:2])
    st = sched.stats()
    sched.close()
    assert st["counters"]["deadline_exceeded"] == 2


def test_resilience_argument_validation():
    with pytest.raises(ValueError):
        _sched(deadline_ms=0.0, start=False)
    with pytest.raises(ValueError):
        _sched(watchdog_s=-1.0, start=False)
    with pytest.raises(ValueError):
        _sched(invariant_sample=-1, start=False)
    sched = _sched(start=False)
    with pytest.raises(ValueError):
        sched.submit_async(np.array([[0, 1]], np.int64), deadline_ms=-5.0)
    sched.close(drain=False)


def test_stats_expose_resilience_state_json_safely():
    with _sched(max_batch=2, max_delay_ms=1.0) as sched:
        sched.submit_async(_er_edges(12, 0.4, 34)).result(timeout=120)
        st = sched.stats()
    json.dumps(st)
    assert set(st["resilience"]) == set(DISPATCH_SITES)
    for site in DISPATCH_SITES:
        snap = st["resilience"][site]
        assert {"rung", "rungs", "failures", "demotions", "promotions",
                "probes", "probe_failures"} <= set(snap)
        assert snap["rung"] == snap["rungs"][0]
    assert st["quarantined"] == [] and st["wedged"] is None
    for c in ("retries", "deadline_exceeded", "heals", "heal_failures",
              "watchdog_trips"):
        assert st["counters"][c] == 0
    assert "heal" in st["stages"]


# ------------------------------------------- lockstep with the JAX package --


def _lockstep_run(Sched, Plan, Policy, engine_kw):
    """One staged tick of mixed traffic under seeded faults; returns every
    request's outcome, the counters, the ladders, the plan's hook counts
    and the handle's final trussness."""
    base = _er_edges(16, 0.35, 40)
    sub_a = _er_edges(14, 0.4, 41)
    sub_b = _er_edges(12, 0.4, 42)
    plan = Plan(seed=4).add("region", mode="corrupt", times=1)
    for site in ("flush", "region", "support", "hierarchy"):
        plan.add(site, rate=0.3)
    sched = Sched(start=False, max_batch=4, max_delay_ms=0.0,
                  retry=Policy(max_retries=2, base_delay_s=0.001,
                               max_delay_s=0.002),
                  ladder={"demote_after": 1, "probe_after": 1,
                          "promote_after": 1},
                  **engine_kw)
    h = sched.engine.open(base, local_frac=1.0)
    kmax = int(h.trussness.max())
    # one tick: every request is admitted before the loop starts, and
    # max_delay_ms=0 dispatches every bucket in that tick, so the hooks
    # fire in the same order in both schedulers
    reqs = []
    for i, (add, rem) in enumerate([([[0, 17], [1, 18]], None),
                                    ([[2, 19]], [[0, 17]]),
                                    ([[3, 20], [4, 21]], None),
                                    (None, [[1, 18]]),
                                    ([[5, 22]], [[2, 19]]),
                                    ([[6, 23], [7, 24]], [[3, 20]])]):
        reqs.append(("update", sched.update_async(
            h, add_edges=None if add is None else np.array(add, np.int64),
            remove_edges=None if rem is None else np.array(rem, np.int64))))
        if i % 2:
            reqs.append(("query", sched.query_async(h, base[:6])))
            reqs.append(("communities",
                         sched.communities_async(h, kmax - i // 2)))
    for e in (sub_a, sub_b, sub_a[::-1].copy(), sub_b, sub_a):
        reqs.append(("submit", sched.submit_async(e)))
    reqs.append(("open", sched.open_async(sub_b)))
    reqs.append(("open", sched.open_async(sub_a)))
    with plan:
        sched.start()
        outcomes = []
        for kind, f in reqs:
            try:
                outcomes.append((kind, "ok", f.result(timeout=300)))
            except Exception as exc:  # noqa: BLE001 — compared by type
                outcomes.append((kind, "failed", type(exc).__name__))
        sched.close()
    st = sched.stats()
    return outcomes, st, plan.stats(), h.trussness


def _same_value(kind, a, b) -> bool:
    if kind in ("submit", "query"):
        return np.array_equal(a, b)
    if kind == "communities":
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    if kind == "open":
        return np.array_equal(a.trussness, b.trussness)
    fields = [f.name for f in dataclasses.fields(a)
              if f.name not in ("seconds", "handle")]
    return all(getattr(a, f) == getattr(b, f) for f in fields)


def test_lockstep_with_reference_scheduler_under_faults():
    """The JAX package's scheduler (its default ``chunked``/``jnp``
    executors) and the port's (``chunked``/``torch``, the same rungs) take
    the same staged traffic — six updates on one handle, queries and
    community listings between them, five submissions of two size classes,
    an open — under the same seeded plan (a corrupt region fault, then
    faults at every site at rate 0.3) and the same retry policy.  Every
    outcome, the counters, each ladder's history and the plan's hook counts
    are equal.  The seed fires faults at every site, so every ladder
    demotes, and the flush and support ladders probe and re-promote —
    with the flush back on the torch rung, whose hook sequence holds the
    port's batched flush to the reference's (one "flush" consult, no
    "support" one)."""
    from repro.serve import RetryPolicy as RefPolicy
    from repro.serve import TrussScheduler as RefScheduler
    from repro.testing.chaos import FaultPlan as RefPlan

    ref = _lockstep_run(RefScheduler, RefPlan, RefPolicy, {})
    port = _lockstep_run(TrussScheduler, FaultPlan, RetryPolicy,
                         dict(mode="chunked", support_mode="torch",
                              device="cpu"))
    (r_out, r_st, r_plan, r_T), (p_out, p_st, p_plan, p_T) = ref, port
    assert [o[:2] for o in p_out] == [o[:2] for o in r_out]
    for (kind, status, a), (_, _, b) in zip(p_out, r_out):
        if status == "ok":
            assert _same_value(kind, a, b), kind
        else:
            assert a == b
    assert np.array_equal(p_T, r_T)
    assert p_plan == r_plan
    assert sum(p_plan["injected"].values()) >= 8
    for c in ("retries", "heals", "heal_failures", "dispatches",
              "coalesced_updates", "errors", "done"):
        assert p_st["counters"][c] == r_st["counters"][c], c
    assert p_st["counters"]["retries"] > 0 and p_st["counters"]["errors"]
    names = {"chunked+jnp": "chunked+torch", "jnp": "torch"}
    for site in DISPATCH_SITES:
        a, b = p_st["resilience"][site], r_st["resilience"][site]
        assert a["rungs"] == [names.get(r, r) for r in b["rungs"]], site
        for k in ("rung", "failures", "demotions", "promotions", "probes",
                  "probe_failures"):
            want = names.get(b[k], b[k]) if k == "rung" else b[k]
            assert a[k] == want, (site, k)
        assert a["demotions"] >= 1, site
    for site in ("flush", "support"):
        assert p_st["resilience"][site]["promotions"] >= 1, site
