"""Port parity: the async scheduler (``repro_torch.serve.scheduler``).

Each test mirrors one of ``tests/test_scheduler.py`` — parity, coalescing,
dispatch policy, admission control, error typing — on the port's scheduler
over a CPU engine (``device="cpu"``: the plain versions of the kernels);
expected trussness comes from the JAX package's ``truss_pkt``.
"""

import json
import time

import numpy as np
import pytest

from repro.core.pkt import truss_pkt as ref_truss_pkt

from repro_torch.serve import Cancelled, TrussEngine
from repro_torch.serve.scheduler import Overloaded, TrussScheduler


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


# ------------------------------------------------------------------ parity --


def test_submit_async_parity_mixed_sizes():
    """Async trussness is bitwise-equal to the JAX package's."""
    fleet = [_er_edges(12, 0.4, 0), _er_edges(30, 0.25, 1),
             _er_edges(12, 0.4, 2), np.array([[0, 1], [1, 2]], np.int64)]
    with _sched(max_batch=4, max_delay_ms=1.0) as sched:
        futs = [sched.submit_async(e) for e in fleet]
        for e, f in zip(fleet, futs):
            assert np.array_equal(f.result(timeout=120), _expected(e))


def test_open_query_communities_async():
    e = _er_edges(16, 0.4, 3)
    with _sched(max_batch=4, max_delay_ms=1.0) as sched:
        h = sched.open_async(e).result(timeout=120)
        q = sched.query_async(h, e[:5]).result(timeout=120)
        assert np.array_equal(q, _expected(e)[:5])
        kmax = int(max(2, q.max()))
        comms = sched.communities_async(h, kmax).result(timeout=120)
        direct = h.communities(kmax)
        assert len(comms) == len(direct)
        for got, want in zip(comms, direct):
            assert np.array_equal(got, want)


# -------------------------------------------------------- update coalescing --


def test_update_coalescing_same_handle():
    """Consecutive updates on one handle merge into one composed repair."""
    e = _er_edges(16, 0.35, 4)
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    h = sched.engine.open(e)
    a1 = np.array([[0, 9], [1, 10]], np.int64)
    a2 = np.array([[2, 11]], np.int64)
    f1 = sched.update_async(h, add_edges=a1)
    f2 = sched.update_async(h, add_edges=a2)
    fq = sched.query_async(h, e[:4])
    sched.start()
    st1, st2 = f1.result(timeout=120), f2.result(timeout=120)
    q = fq.result(timeout=120)
    sched.close()
    assert st1 is st2
    assert st1.coalesced == 2
    full = np.concatenate([e, a1, a2])
    assert np.array_equal(h.query(e[:4]), _expected(full)[:4])
    assert np.array_equal(q, _expected(full)[:4])
    assert sched.stats()["counters"]["coalesced_updates"] == 1


def test_coalesced_insert_then_delete_not_resurrected():
    """An edge inserted in one queued batch and deleted in a later one does
    not survive the composed repair (nor come back through the batched
    insertion region seed, §13)."""
    e = _er_edges(16, 0.35, 21)
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    h = sched.engine.open(e)
    ghost = np.array([[0, 17]], np.int64)
    k1 = np.array([[1, 18]], np.int64)
    k2 = np.array([[2, 19]], np.int64)
    f1 = sched.update_async(h, add_edges=np.concatenate([ghost, k1]))
    f2 = sched.update_async(h, add_edges=k2, remove_edges=ghost)
    sched.start()
    st1, st2 = f1.result(timeout=120), f2.result(timeout=120)
    sched.close()
    assert st1 is st2 and st1.coalesced == 2
    assert st1.insert_mode == "batched"
    cur = {(int(u), int(v)) for u, v in h.edges}
    assert (0, 17) not in cur
    assert {(1, 18), (2, 19)} <= cur
    assert np.array_equal(h.trussness, ref_truss_pkt(h.edges))


def test_query_is_barrier_between_updates():
    """A query splits the update run: it observes exactly its FIFO prefix."""
    e = _er_edges(16, 0.35, 5)
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    h = sched.engine.open(e)
    a1 = np.array([[0, 9]], np.int64)
    a2 = np.array([[1, 10]], np.int64)
    f1 = sched.update_async(h, add_edges=a1)
    fq = sched.query_async(h, e[:4])
    f2 = sched.update_async(h, add_edges=a2)
    sched.start()
    st1, st2 = f1.result(timeout=120), f2.result(timeout=120)
    q = fq.result(timeout=120)
    sched.close()
    assert st1 is not st2
    assert st1.coalesced == 1 and st2.coalesced == 1
    assert np.array_equal(q, _expected(np.concatenate([e, a1]))[:4])
    assert np.array_equal(h.query(e[:4]),
                          _expected(np.concatenate([e, a1, a2]))[:4])


# --------------------------------------------------------- dispatch policy --


def test_full_bucket_dispatches_before_deadline():
    """max_batch requests of one size class release without the delay.

    The two submissions are one graph in two row orders, so they share a
    size class for certain (two random graphs may not, and would then
    wait out the minute-long delay one by one)."""
    e1 = _er_edges(14, 0.4, 6)
    e2 = e1[::-1].copy()
    with _sched(max_batch=2, max_delay_ms=60_000.0) as sched:
        t0 = time.perf_counter()
        f1, f2 = sched.submit_async(e1), sched.submit_async(e2)
        assert np.array_equal(f1.result(timeout=120), _expected(e1))
        assert np.array_equal(f2.result(timeout=120), _expected(e2))
        assert time.perf_counter() - t0 < 30.0
        assert sched.stats()["counters"]["dispatches"] == 1


def test_deadline_dispatches_partial_bucket():
    """A non-full bucket still dispatches once its oldest hits max_delay."""
    with _sched(max_batch=64, max_delay_ms=30.0) as sched:
        fleet = [_er_edges(14, 0.4, s) for s in (8, 9, 10)]
        futs = [sched.submit_async(e) for e in fleet]
        for e, f in zip(fleet, futs):
            assert np.array_equal(f.result(timeout=120), _expected(e))
        st = sched.stats()
        assert st["counters"]["dispatches"] >= 1
        assert st["buckets_waiting"] == {}


# ------------------------------------------------------- admission control --


def test_queue_depth_shedding():
    """Admissions beyond max_queue shed with Overloaded, typed and counted."""
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0, max_queue=2)
    e = _er_edges(12, 0.4, 11)
    f1, f2 = sched.submit_async(e), sched.submit_async(e)
    with pytest.raises(Overloaded, match="queue depth"):
        sched.submit_async(e)
    assert sched.stats()["counters"]["shed"] == 1
    sched.start()
    want = _expected(e)
    assert np.array_equal(f1.result(timeout=120), want)
    assert np.array_equal(f2.result(timeout=120), want)
    f3 = sched.submit_async(e)
    assert np.array_equal(f3.result(timeout=120), want)
    sched.close()


def test_per_tenant_inflight_shedding():
    """One tenant at max_inflight sheds; other tenants still admit."""
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0,
                   max_inflight=1)
    e = _er_edges(12, 0.4, 12)
    f1 = sched.submit_async(e, tenant="a")
    with pytest.raises(Overloaded, match="tenant 'a'"):
        sched.submit_async(e, tenant="a")
    f2 = sched.submit_async(e, tenant="b")
    sched.start()
    want = _expected(e)
    assert np.array_equal(f1.result(timeout=120), want)
    assert np.array_equal(f2.result(timeout=120), want)
    sched.close()
    assert sched.stats()["inflight"] == {}


# ------------------------------------------------------------ error typing --


def test_handle_type_and_closed_errors():
    """Non-handle targets TypeError; closed handles ValueError, synchronously."""
    sched = _sched(start=False, max_batch=4, max_delay_ms=1.0)
    e = _er_edges(12, 0.4, 13)
    h = sched.engine.open(e)
    with pytest.raises(TypeError, match="TrussHandle"):
        sched.query_async(7, e[:2])
    sched.engine.close(h)
    with pytest.raises(ValueError, match="closed"):
        sched.update_async(h, add_edges=np.array([[0, 9]], np.int64))
    with pytest.raises(ValueError, match="closed"):
        sched.communities_async(h, 3)
    sched.start()
    sched.close()


def test_engine_validation_error_lands_on_future():
    """Bad payloads admit, then the engine's ValueError rides the future."""
    with _sched(max_batch=4, max_delay_ms=1.0) as sched:
        f = sched.submit_async(np.array([[-1, 2]], np.int64))
        with pytest.raises(ValueError):
            f.result(timeout=120)
        assert sched.stats()["counters"]["errors"] == 1


def test_closed_scheduler_rejects_and_close_is_idempotent():
    sched = _sched(max_batch=4, max_delay_ms=1.0)
    sched.close()
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit_async(np.array([[0, 1]], np.int64))


def test_close_without_drain_cancels_queued():
    """close(drain=False) rejects waiting work with typed Cancelled."""
    sched = _sched(max_batch=64, max_delay_ms=60_000.0)
    e = _er_edges(14, 0.4, 14)
    f1, f2 = sched.submit_async(e), sched.submit_async(e)
    deadline = time.perf_counter() + 30
    while (sched.stats()["buckets_waiting"] == {}
           and time.perf_counter() < deadline):
        time.sleep(0.005)
    sched.close(drain=False)
    for f in (f1, f2):
        assert f.done() and not f.cancelled()
        with pytest.raises(Cancelled):
            f.result(timeout=0)
    exc = f1.exception(timeout=0)
    assert exc.kind == "submit" and isinstance(exc.position, int)
    st = sched.stats()
    assert st["counters"]["cancelled"] == 2
    assert st["depth"] == 0
    assert sched.engine._pending == []


def test_bad_constructor_args():
    with pytest.raises(ValueError):
        _sched(max_batch=0)
    with pytest.raises(ValueError):
        _sched(max_delay_ms=-1.0)
    with pytest.raises(ValueError):
        _sched(max_queue=0)
    with pytest.raises(ValueError):
        _sched(max_inflight=0)
    with pytest.raises(ValueError):
        TrussScheduler(TrussEngine(device="cpu"), mode="dense")


def test_stats_shape():
    """stats() is JSON-safe and carries every stage and counter — the
    engine's per-size-class launch counts included."""
    with _sched(max_batch=2, max_delay_ms=1.0) as sched:
        e = _er_edges(12, 0.4, 15)
        sched.submit_async(e).result(timeout=120)
        st = sched.stats()
    json.dumps(st)
    for stage in ("queue_wait", "build", "dispatch", "readback",
                  "open", "repair", "query"):
        assert {"count", "seconds", "max_seconds"} <= set(st["stages"][stage])
    assert st["counters"]["submit"] == 1
    assert st["counters"]["done"] == 1
    assert "engine" in st
    (launches,) = st["engine"]["bucket_launches"].values()
    assert launches["plain"] >= 2       # K1's and K2's plain versions ran
