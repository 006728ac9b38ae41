"""Port parity: incremental truss maintenance (``core/truss_inc.py``).

Seeded update scripts go through the JAX package's ``IncrementalTruss`` and
the port's (``device="cpu"``, where every "kernel" executor runs its plain
version) in lockstep; after every step the edges, trussness, support, the
triangle list (order included) and the ``UpdateStats`` (all but
``seconds``) must be equal.  Tolerance: exact equality everywhere.  The
reference has no "klevel" insert mode: the port's is held to a from-scratch
decomposition and to its own "sequential" mode instead.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import truss_inc as ref_inc
from repro.graphs.csr import build_csr as ref_build_csr
from repro.graphs.datasets import named_graph
from repro.graphs.gen import ring_of_cliques_edges
from repro.testing import chaos as ref_chaos

from repro_torch.core import truss_inc as port_inc
from repro_torch.core.pkt import PEEL_MODES, truss_pkt
from repro_torch.core.support import compute_support
from repro_torch.graphs.csr import build_csr as port_build_csr
from repro_torch.graphs.gen import rmat_edges
from repro_torch.kernels import peel as kpeel
from repro_torch.testing import chaos as port_chaos

CPU = "cpu"
NAMED = ["fig1", "karate_like", "cliques-tiny", "rmat-tiny", "ba-tiny"]

#: region-size regimes × insert modes the lockstep scripts run under:
#: host-mirror regions, the device rung (``peel_live_subset`` with the
#: boundary pinned; K2's plain version here), and the forced fallback
AXES = {
    "host-region": dict(local_frac=1.0),
    "device-region": dict(local_frac=1.0, host_peel_max=0),
    "compacting": dict(local_frac=1.0, host_peel_max=0, compact_frac=0.9,
                       compact_min=1),
    "forced-fallback": dict(local_frac=0.0),
}


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(mask, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def _pair(E, **kw):
    """A reference handle and a port handle on the CPU, same options."""
    return (ref_inc.IncrementalTruss(E, **kw),
            port_inc.IncrementalTruss(E, device=CPU, **kw))


def _stats(st):
    d = dataclasses.asdict(st)
    d.pop("seconds")
    d.pop("handle")
    return d


def _assert_same_state(ref, port, ctx=None):
    assert ref.n == port.n, ctx
    assert np.array_equal(ref.edges, port.edges), ctx
    assert np.array_equal(ref.trussness, port.trussness), ctx
    assert np.array_equal(ref.support, port.support), ctx
    assert ref.triangles.shape == port.triangles.shape, ctx
    assert np.array_equal(ref.triangles, port.triangles), ctx   # order too


def _batches(n, script, seed, edges_of):
    """The update batches of one script, drawn against the current state."""
    rng = np.random.default_rng(seed + 1)
    for n_add, n_rm in script:
        cur = edges_of()
        m = cur.shape[0]
        rm = cur[rng.choice(m, size=min(n_rm, m), replace=False)] \
            if m else np.zeros((0, 2), np.int64)
        add = np.stack([rng.integers(0, n + 2, n_add),
                        rng.integers(0, n + 2, n_add)], axis=1)
        yield add[add[:, 0] != add[:, 1]], rm


def _lockstep(ref, port, n, script, seed):
    for add, rm in _batches(n, script, seed, lambda: ref.edges):
        s1 = ref.update(add_edges=add, remove_edges=rm)
        s2 = port.update(add_edges=add, remove_edges=rm)
        assert _stats(s1) == _stats(s2), (add, rm)
        _assert_same_state(ref, port, (add, rm, s1.mode))


@st.composite
def update_scripts(draw):
    """An initial graph plus a script of insert/delete batches."""
    n = draw(st.integers(20, 40))
    density = draw(st.floats(0.1, 0.4))
    seed = draw(st.integers(0, 2**31 - 1))
    script = [(draw(st.integers(0, 6)), draw(st.integers(0, 6)))
              for _ in range(draw(st.integers(1, 3)))]
    return n, _er(n, density, seed), script, seed


@pytest.mark.parametrize("insert_mode", ref_inc.INSERT_MODES)
@pytest.mark.parametrize("axis", sorted(AXES))
@given(script=update_scripts())
@settings(max_examples=3, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_property_lockstep_parity(axis, insert_mode, script):
    """Any insert/delete script: port ≡ reference after every step, in both
    insert modes, on both region rungs and through the full fallback."""
    n, E, batches, seed = script
    if E.shape[0] == 0:
        return
    ref, port = _pair(E, insert_mode=insert_mode, **AXES[axis])
    _assert_same_state(ref, port, "open")
    _lockstep(ref, port, n, batches, seed)


FIXED = {
    "k4-completion": (np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3]]),
                      [(np.array([[2, 3]]), None)]),
    "k4-break": (np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]),
                 [(None, np.array([[2, 3]]))]),
    "empty-and-growth": (np.array([[0, 1], [0, 2], [1, 2]]),
                         [(None, np.array([[0, 1], [0, 2], [1, 2]])),
                          (np.array([[5, 9], [9, 11], [5, 11]]), None)]),
    "noop-and-setwise": (np.array([[0, 1], [0, 2], [1, 2]]),
                         [(np.array([[1, 0]]), np.array([[5, 6]])),
                          (np.array([[1, 2], [0, 3]]), np.array([[1, 2]]))]),
    "overlapping-cascades": (
        np.array([[i, j] for i in range(5) for j in range(i + 1, 5)
                  if (i, j) not in [(0, 1), (3, 4)]]),
        [(np.array([[0, 1], [3, 4]]), None)]),
    "kmax-raise": (
        np.array([[i, j] for i in range(6) for j in range(i + 1, 6)]
                 + [[0, 6], [0, 7], [6, 7]]),
        [(np.array([[6, k] for k in range(1, 6)]), None)]),
    "ring-insert-delete": (
        ring_of_cliques_edges(4, 5),
        [(np.array([[0, 7], [1, 11], [2, 16]]), ring_of_cliques_edges(4, 5)[:3])]),
}


@pytest.mark.parametrize("insert_mode", ref_inc.INSERT_MODES)
@pytest.mark.parametrize("case", sorted(FIXED))
def test_fixed_scripts_match_reference(case, insert_mode):
    """The reference tests' fixed cascades, lockstep with the reference."""
    E, batches = FIXED[case]
    ref, port = _pair(np.asarray(E, np.int64), insert_mode=insert_mode,
                      local_frac=1.0)
    for add, rm in batches:
        s1 = ref.update(add_edges=add, remove_edges=rm)
        s2 = port.update(add_edges=add, remove_edges=rm)
        assert _stats(s1) == _stats(s2)
        _assert_same_state(ref, port, case)
    assert port.verify()


@pytest.mark.parametrize("mode", PEEL_MODES)
def test_device_region_every_peel_executor(mode):
    """The pinned-boundary device re-peel agrees with the reference across
    the port's three peel executors; on the kernel executor it runs K2
    (its plain version on the CPU) with the boundary pinned."""
    E = ring_of_cliques_edges(4, 5)
    add = np.array([[0, 7], [1, 11], [2, 16]], np.int64)
    ref = ref_inc.IncrementalTruss(E, local_frac=1.0, host_peel_max=0)
    port = port_inc.IncrementalTruss(E, mode=mode, local_frac=1.0,
                                     host_peel_max=0, device=CPU)
    plain0 = kpeel.COUNTS.plain
    s1 = ref.update(add_edges=add, remove_edges=E[:3])
    s2 = port.update(add_edges=add, remove_edges=E[:3])
    assert _stats(s1) == _stats(s2)
    _assert_same_state(ref, port, mode)
    assert port.region_peels["device"] >= 1 and s2.boundary > 0
    assert (kpeel.COUNTS.plain > plain0) == (mode == "kernel")


def test_both_rungs_same_script():
    """One script with every region on the host and with every region on
    the device rung: equal to each other and to the reference."""
    E = ring_of_cliques_edges(4, 5)
    ref = ref_inc.IncrementalTruss(E, local_frac=1.0)
    host = port_inc.IncrementalTruss(E, local_frac=1.0, host_peel_max=10**9,
                                     device=CPU)
    dev = port_inc.IncrementalTruss(E, local_frac=1.0, host_peel_max=0,
                                    device=CPU)
    script = [(4, 2), (3, 3), (5, 0)]
    for add, rm in _batches(20, script, 17, lambda: ref.edges):
        s0 = ref.update(add_edges=add, remove_edges=rm)
        s1 = host.update(add_edges=add, remove_edges=rm)
        s2 = dev.update(add_edges=add, remove_edges=rm)
        assert _stats(s0) == _stats(s1) == _stats(s2)
        _assert_same_state(ref, host)
        _assert_same_state(ref, dev)
    assert host.region_peels["device"] == 0 and host.region_peels["host"]
    assert dev.region_peels["host"] == 0 and dev.region_peels["device"]


@given(script=update_scripts())
@settings(max_examples=4, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_property_update_many_matches_reference(script):
    """``update_many`` composes the batches exactly as the reference does,
    and ends equal to the same batches applied one at a time."""
    n, E, batches, seed = script
    if E.shape[0] == 0:
        return
    ref, port = _pair(E, local_frac=1.0)
    one = port_inc.IncrementalTruss(E, local_frac=1.0, device=CPU)
    blist = list(_batches(n, batches, seed, lambda: one.edges))
    for add, rm in blist:
        one.update(add_edges=add, remove_edges=rm)
    s1 = ref.update_many(blist)
    s2 = port.update_many(blist)
    assert _stats(s1) == _stats(s2) and s2.coalesced == len(blist)
    _assert_same_state(ref, port)
    assert np.array_equal(port.trussness, one.trussness)


def test_compose_update_batches_matches_reference():
    b1 = (np.array([[0, 1], [2, 3]], np.int64), None)
    b2 = (np.array([[4, 5]], np.int64), np.array([[0, 1]], np.int64))
    b3 = (np.array([[0, 1]], np.int64), np.array([[8, 9]], np.int64))
    for batches in ([b1, b2, b3], [], [b3, b1]):
        a1, r1 = ref_inc.compose_update_batches(batches)
        a2, r2 = port_inc.compose_update_batches(batches)
        assert np.array_equal(a1, a2) and np.array_equal(r1, r2)
        assert a2.dtype == np.int64 and r2.dtype == np.int64
    with pytest.raises(ValueError):
        port_inc.compose_update_batches([(np.array([[1, 1]]), None)])


def test_validation_and_queries():
    E = np.array([[0, 1], [0, 2], [1, 2]], np.int64)
    port = port_inc.IncrementalTruss(E, device=CPU)
    with pytest.raises(ValueError, match="self-loop"):
        port.update(add_edges=np.array([[3, 3]]))
    with pytest.raises(ValueError, match="negative"):
        port.update(remove_edges=np.array([[-1, 2]]))
    with pytest.raises(ValueError, match="insert_mode"):
        port.update(add_edges=np.array([[0, 3]]), insert_mode="bogus")
    for kw in (dict(local_frac=1.5), dict(insert_mode="bogus"),
               dict(hier_mode="nope"), dict(mode="pallas"),
               dict(support_mode="jnp")):
        with pytest.raises(ValueError):
            port_inc.IncrementalTruss(E, device=CPU, **kw)
    assert list(port.query(np.array([[2, 0], [1, 0], [0, 1]]))) == [3, 3, 3]
    with pytest.raises(ValueError, match="not present"):
        port.query(np.array([[0, 9]]))
    assert port.mode == "kernel" and port.support_mode == "kernel"


# ------------------------------------------------------- building blocks ----

@pytest.mark.parametrize("name", NAMED + ["er-45"])
def test_triangle_list_and_through_match_reference(name):
    """The device-enumerated list comes in the reference's exact order;
    ``triangles_through`` and ``wedge_subtable`` equal the reference's."""
    E = _er(45, 0.3, 8) if name == "er-45" else named_graph(name)
    gr, gp = ref_build_csr(E), port_build_csr(E)
    want = ref_inc.triangle_list(gr)
    got = port_inc.triangle_list(gp, device=CPU)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    anchors = np.unique(np.array([0, gp.m // 3, gp.m // 2, gp.m - 1]))
    for a, b in zip(ref_inc.triangles_through(gr, anchors),
                    port_inc.triangles_through(gp, anchors)):
        assert np.array_equal(a, b)
    t1, t2 = ref_inc.wedge_subtable(gr, anchors), \
        port_inc.wedge_subtable(gp, anchors)
    for f in ("e1", "cand_slot", "lo", "hi", "off"):
        assert np.array_equal(getattr(t1, f), getattr(t2, f)), f


def test_incidence_and_host_peel_match_reference():
    E = _er(30, 0.35, 9)
    g = ref_build_csr(E)
    tri = ref_inc.triangle_list(g)
    a = ref_inc._Incidence(tri, g.m)
    b = port_inc._Incidence(torch.from_numpy(tri), g.m)
    assert np.array_equal(a.off, b.off.numpy())
    assert np.array_equal(a.idx, b.idx.numpy())
    edges = np.array([0, 3, g.m - 1])
    assert np.array_equal(a.rows_of(edges),
                          b.rows_of(torch.from_numpy(edges)).numpy())
    S = np.bincount(tri.ravel(), minlength=g.m)
    T = ref_inc.IncrementalTruss(E).trussness
    work = np.arange(g.m)
    assert np.array_equal(
        ref_inc._h_values(a, T, work),
        port_inc._h_values(b, torch.from_numpy(T),
                           torch.from_numpy(work)).numpy())
    allowed = S >= 3
    seeds = np.array([0, g.m // 2])
    assert np.array_equal(
        ref_inc._tri_bfs(a, np.zeros((0, 3), np.int64), seeds, allowed),
        port_inc._tri_bfs(b, torch.zeros((0, 3), dtype=torch.int64),
                          torch.from_numpy(seeds),
                          torch.from_numpy(allowed)).numpy())
    pinned = np.zeros(g.m, bool)
    pinned[::5] = True
    S0 = np.where(pinned, T - 2, S)
    assert np.array_equal(
        ref_inc._host_peel(g.m, tri, S0, np.ones(g.m, bool), pinned),
        port_inc._host_peel(g.m, tri, S0, np.ones(g.m, bool), pinned))


def test_check_invariants_rebuild_verify():
    E = _er(30, 0.3, 5)
    ref, port = _pair(E)
    assert port.check_invariants(sample=10**6) == ref.check_invariants(
        sample=10**6)
    assert port.check_invariants(sample=8, seed=3) == ref.check_invariants(
        sample=8, seed=3)
    assert port.verify() and ref.verify()
    # one corrupt trussness: both packages detect it, rebuild heals it
    e = int(np.argmax(port.T))
    ref.T[e] += 1
    port.T[e] += 1
    with pytest.raises(ref_inc.IntegrityError):
        ref.check_invariants(sample=10**6)
    with pytest.raises(port_inc.IntegrityError):
        port.check_invariants(sample=10**6)
    assert not port.verify()
    ref.rebuild()
    port.rebuild()
    _assert_same_state(ref, port)
    assert port.verify()


@pytest.mark.parametrize("host_peel_max", [0, 4096])
def test_corrupt_fault_raises_and_keeps_state(host_peel_max):
    """A seeded "corrupt" fault at the region site trips the replay
    invariant on either rung — as in the reference — and the committed
    state stays as it was; the same batch then lands cleanly."""
    E = ring_of_cliques_edges(4, 5)
    ref, port = _pair(E, local_frac=1.0, host_peel_max=host_peel_max)
    add = np.array([[0, 7], [1, 11], [2, 16]], np.int64)
    rm = E[:2]
    snap = (port.edges, port.trussness, port.support, port.triangles)
    with ref_chaos.FaultPlan(seed=0).add("region", mode="corrupt", times=1):
        with pytest.raises(ref_inc.IntegrityError):
            ref.update(add_edges=add, remove_edges=rm)
    plan = port_chaos.FaultPlan(seed=0).add("region", mode="corrupt",
                                            times=1)
    with plan:
        with pytest.raises(port_inc.IntegrityError):
            port.update(add_edges=add, remove_edges=rm)
    assert plan.stats()["injected"] == {"region": 1}
    for a, b in zip(snap, (port.edges, port.trussness, port.support,
                           port.triangles)):
        assert np.array_equal(a, b)
    s1 = ref.update(add_edges=add, remove_edges=rm)
    s2 = port.update(add_edges=add, remove_edges=rm)
    assert _stats(s1) == _stats(s2)
    _assert_same_state(ref, port)


@pytest.mark.parametrize("insert_mode", ["sequential", "klevel"])
def test_no_half_applied_batch(monkeypatch, insert_mode):
    """A region peel raising mid-batch leaves the handle untouched."""
    E = ring_of_cliques_edges(4, 5)
    port = port_inc.IncrementalTruss(E, insert_mode=insert_mode,
                                     local_frac=1.0, device=CPU)
    snap = (port.edges, port.trussness, port.support, port.triangles,
            dict(port.stats))
    orig = port_inc.IncrementalTruss._region_peel
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected mid-batch")
        return orig(self, *a, **k)

    monkeypatch.setattr(port_inc.IncrementalTruss, "_region_peel", flaky)
    add = np.array([[0, 7], [1, 11], [2, 16]], np.int64)
    with pytest.raises(RuntimeError, match="injected"):
        port.update(add_edges=add, remove_edges=E[:2])
    for a, b in zip(snap[:4], (port.edges, port.trussness, port.support,
                               port.triangles)):
        assert np.array_equal(a, b)
    assert port.stats["updates"] == snap[4]["updates"]
    monkeypatch.setattr(port_inc.IncrementalTruss, "_region_peel", orig)
    assert port.update(add_edges=add, remove_edges=E[:2]).mode == "local"
    assert port.verify()


def test_batched_single_region_dispatch(monkeypatch):
    """Three K5 completions in one batch re-peel once (batched) and three
    times (sequential), as in the reference."""
    calls = {"n": 0}
    orig = port_inc.IncrementalTruss._region_peel

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(port_inc.IncrementalTruss, "_region_peel", counting)
    rows, missing = [], []
    for c in range(3):
        vs = range(5 * c, 5 * c + 5)
        allp = [(i, j) for i in vs for j in vs if i < j]
        missing.append(allp.pop(c))
        rows += allp
    E, add = np.array(rows, np.int64), np.array(missing, np.int64)
    for imode, n_calls in (("batched", 1), ("sequential", 3)):
        port = port_inc.IncrementalTruss(E, insert_mode=imode,
                                         local_frac=1.0, device=CPU)
        calls["n"] = 0
        st_ = port.update(add_edges=add)
        assert st_.mode == "local" and calls["n"] == n_calls
        assert (port.trussness == 5).all()


@pytest.mark.parametrize("name", ["karate_like", "ba-tiny"])
def test_state_carried_across_from_reference(name):
    """A port handle started from the reference handle's arrays takes the
    same batches to the same states, without decomposing at all."""
    E = named_graph(name)
    ref = ref_inc.IncrementalTruss(E, local_frac=1.0)
    port = port_inc.IncrementalTruss.from_state(
        ref.edges, ref.trussness, ref.support, ref.triangles, n=ref.n,
        local_frac=1.0, device=CPU)
    assert port.open_phases == {}
    _assert_same_state(ref, port)
    n = int(E.max()) + 1
    _lockstep(ref, port, n, [(5, 5), (8, 3), (0, 6)], seed=3)
    assert port.verify()


def test_from_state_validation():
    E = np.array([[0, 1], [0, 2], [1, 2]], np.int64)
    T, S, tri = np.full(3, 3), np.ones(3, np.int32), np.array([[0, 1, 2]])
    with pytest.raises(ValueError, match="canonical"):
        port_inc.IncrementalTruss.from_state(E[::-1], T, S, tri, device=CPU)
    with pytest.raises(ValueError, match="trussness and support"):
        port_inc.IncrementalTruss.from_state(E, T[:2], S, tri, device=CPU)
    with pytest.raises(ValueError, match="beyond"):
        port_inc.IncrementalTruss.from_state(E, T, S, tri + 1, device=CPU)
    inc = port_inc.IncrementalTruss.from_state(E, T, S, tri, device=CPU)
    assert inc.verify() and inc.m == 3


# ------------------------------------------------------------ "klevel" ----

def _assert_scratch(inc, ctx=None):
    """``inc``'s state equals a from-scratch decomposition of its edges:
    trussness, support, and the triangle list as a set of rows; the
    incidence and device copies it carries to its next batch equal fresh
    ones."""
    carried = inc._incidence()
    fresh = port_inc._Incidence(inc.tri, inc.m)
    assert torch.equal(carried.off, fresh.off), ctx
    assert torch.equal(carried.idx, fresh.idx), ctx
    T_dev, S_dev = inc._device_state()
    assert np.array_equal(T_dev.numpy(), inc.trussness), ctx
    assert np.array_equal(S_dev.numpy(), inc.support), ctx
    E = inc.edges
    if E.shape[0] == 0:
        assert inc.triangles.shape[0] == 0, ctx
        return
    assert np.array_equal(inc.trussness, truss_pkt(E, device=CPU)), ctx
    g = port_build_csr(E, inc.n)
    assert np.array_equal(inc.support, compute_support(g, device=CPU)), ctx
    want = port_inc.triangle_list(g, device=CPU)
    assert np.array_equal(np.unique(inc.triangles, axis=0),
                          np.unique(want, axis=0)), ctx


def _klevel_against_sequential(E, batches, **kw):
    """Run ``batches`` through a "klevel" and a "sequential" handle: after
    every step both equal a from-scratch decomposition, and each other in
    trussness, support and triangle rows (order included) while neither
    has rebuilt from scratch."""
    seq = port_inc.IncrementalTruss(E, insert_mode="sequential", device=CPU,
                                    **kw)
    kl = port_inc.IncrementalTruss(E, insert_mode="klevel", device=CPU, **kw)
    rebuilt = False
    for add, rm in batches:
        s1 = seq.update(add_edges=add, remove_edges=rm)
        s2 = kl.update(add_edges=add, remove_edges=rm)
        rebuilt |= "full" in (s1.mode, s2.mode)
        assert s2.mode in ("local", "full", "noop")
        assert (s1.inserted, s1.deleted, s1.changed) == \
            (s2.inserted, s2.deleted, s2.changed)
        assert np.array_equal(seq.trussness, kl.trussness), (add, rm)
        assert np.array_equal(seq.support, kl.support), (add, rm)
        if not rebuilt:
            assert np.array_equal(seq.triangles, kl.triangles), (add, rm)
        _assert_scratch(kl, (add, rm, s2))
    return seq, kl


@pytest.mark.parametrize("axis", sorted(AXES))
@given(script=update_scripts())
@settings(max_examples=4, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_property_klevel_matches_sequential_and_scratch(axis, script):
    """Any insert/delete script under "klevel": after every step equal to a
    from-scratch decomposition and to "sequential", on both region rungs
    and through the full fallback."""
    n, E, batches, seed = script
    if E.shape[0] == 0:
        return
    seq = port_inc.IncrementalTruss(E, device=CPU)
    blist = list(_batches(n, batches, seed, lambda: seq.edges))
    for add, rm in blist:
        seq.update(add_edges=add, remove_edges=rm)
    _klevel_against_sequential(E, blist, **AXES[axis])


@pytest.mark.parametrize("case", sorted(FIXED))
def test_fixed_scripts_klevel(case):
    """The fixed cascades under "klevel", rebuilding from scratch no more
    often than "sequential" (on these small graphs a batch's regions can
    add up past every edge)."""
    E, batches = FIXED[case]
    seq, kl = _klevel_against_sequential(np.asarray(E, np.int64), batches,
                                         local_frac=1.0)
    assert kl.stats["full"] <= seq.stats["full"] and kl.verify()


def test_klevel_multi_level_rise_in_one_batch():
    """Two insertions into a K6 with pendant triangles: edges rise at two
    levels, some by two in one batch (one insertion raises a trussness by
    at most one, so the batch is applied one insertion at a time)."""
    miss = np.array([[0, 5], [1, 5]], np.int64)
    E = np.array([[i, j] for i in range(6) for j in range(i + 1, 6)
                  if [i, j] not in miss.tolist()]
                 + [[6, 0], [6, 1], [6, 2], [7, 0], [7, 6]], np.int64)
    kl = port_inc.IncrementalTruss(E, insert_mode="klevel", local_frac=1.0,
                                   device=CPU)
    before = kl.query(E)
    st_ = kl.update(add_edges=miss)
    rise = kl.query(E) - before
    assert st_.mode == "local" and st_.insert_mode == "klevel"
    assert rise.max() == 2 and set(before[rise > 0]) == {4, 5}
    _assert_scratch(kl)
    _klevel_against_sequential(E, [(miss, None)], local_frac=1.0)


def _single_insertion_state(E, e_new, n):
    """The "klevel" search's inputs for inserting ``e_new`` into ``E``:
    the new graph, its static incidence (triangles without the new edge),
    the new edge's rows, its id, and T (old values, -1 on the new edge) and
    UB as ``_insert_klevel`` sets them."""
    E2 = np.unique(np.concatenate([E, e_new[None]]), axis=0)
    g2 = port_build_csr(E2, n)
    e0 = int(np.nonzero((g2.El == e_new).all(axis=1))[0][0])
    tri = torch.from_numpy(port_inc.triangle_list(g2, device=CPU))
    has = (tri == e0).any(dim=1)
    T = torch.full((g2.m,), -1, dtype=torch.int64)
    old = np.ones(g2.m, bool)
    old[e0] = False
    T[torch.from_numpy(old)] = torch.from_numpy(truss_pkt(E2[old],
                                                          device=CPU))
    S = torch.bincount(tri.reshape(-1), minlength=g2.m)
    UB = torch.where(T >= 0, torch.minimum(S + 2, T + 1), S + 2)
    inc = port_inc._Incidence(tri[~has], g2.m)
    UB[e0] = port_inc._h_values(port_inc._Incidence(tri[has], g2.m), UB,
                                torch.tensor([e0]))[0]
    return E2, inc, tri[has], e0, T, UB


@pytest.mark.parametrize("seed", range(8))
def test_klevel_region_holds_every_riser(seed):
    """The search's pruning is sound: on random graphs and single
    insertions, every edge whose trussness rises lies in the region (so
    the pinned re-peel of the region is exact); below the graph's top
    level, which the search takes whole, the region holds only edges whose
    bound lets them rise."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(14, 26))
    E = _er(n, float(rng.uniform(0.25, 0.5)), seed)
    absent = [(i, j) for i in range(n) for j in range(i + 1, n)
              if not ((E[:, 0] == i) & (E[:, 1] == j)).any()]
    for pick in rng.choice(len(absent), size=min(6, len(absent)),
                           replace=False):
        e_new = np.array(absent[pick], np.int64)
        E2, inc, side, e0, T, UB = _single_insertion_state(E, e_new, n)
        totals = {"passes": 0}
        A = port_inc._klevel_region(inc, side, e0, T, UB, totals,
                                    float("inf"))
        after = torch.from_numpy(truss_pkt(E2, device=CPU))
        risers = torch.nonzero((after != T) & (T >= 0)).view(-1)
        assert bool(torch.isin(risers, A).all()), (seed, e_new)
        assert e0 in A.tolist()
        others = A[(A != e0) & (T[A] < T.max())]
        assert bool((UB[others] >= T[others] + 1).all())


def test_rmat_dense_core_klevel_stays_local_where_batched_falls_back():
    """An R-MAT graph with a dense core, 8 of its edges deleted and put
    back: "batched" (the batch bound ``T + b`` walks through the core)
    falls back at ``local_frac`` 0.25, while "klevel" stays local with a
    region strictly smaller than the batched one's, and exact."""
    E = rmat_edges(10, 8, seed=1)
    pool = E[np.random.default_rng(1).choice(len(E), 8, replace=False)]
    stats = {}
    for imode, frac in (("batched", 0.25), ("batched", 1.0),
                        ("klevel", 0.25)):
        inc = port_inc.IncrementalTruss(E, insert_mode=imode,
                                        local_frac=frac, device=CPU)
        assert inc.update(remove_edges=pool).mode == "local"
        stats[imode, frac] = inc.update(add_edges=pool)
    assert stats["batched", 0.25].mode == "full"
    assert stats["batched", 1.0].mode == "local"
    assert stats["klevel", 0.25].mode == "local"
    assert (stats["klevel", 0.25].affected
            < stats["batched", 1.0].affected)
    assert np.array_equal(inc.trussness, truss_pkt(inc.edges, device=CPU))


@pytest.mark.parametrize("name", NAMED + ["er-45"])
def test_edge_triangles_equal_triangles_through(name):
    """``edge_triangles`` (one edge, by intersecting adjacency rows) gives
    each edge's triangles as ``triangles_through`` does, in its order: by
    the third vertex, each row's two other edges as a set."""
    E = _er(45, 0.3, 8) if name == "er-45" else named_graph(name)
    g = port_build_csr(E)
    for e in range(g.m):
        _, b, c = port_inc.triangles_through(g, np.array([e]))
        p2, p3 = port_inc.edge_triangles(g, e)
        assert np.array_equal(np.sort(np.stack([p2, p3], 1), axis=1),
                              np.sort(np.stack([b, c], 1), axis=1))
        assert p2.dtype == p3.dtype == np.int64


@pytest.mark.parametrize("name", ["karate_like", "er-45"])
def test_triangles_enumerate_the_same_in_slices(name, monkeypatch):
    """The triangle list enumerated one small slice of the support table
    at a time equals the list from one slice, row for row."""
    import importlib

    from repro_torch.kernels import wedge_common

    # ``repro_torch.core`` re-exports a function under the module's name
    triangle_list = importlib.import_module("repro_torch.core.triangle_list")

    E = _er(45, 0.3, 8) if name == "er-45" else named_graph(name)
    g = port_build_csr(E)
    whole = triangle_list._triangles_dev(g, torch.device(CPU))
    monkeypatch.setattr(wedge_common, "SLICE_ROWS", 7)
    sliced = triangle_list._triangles_dev(g, torch.device(CPU))
    assert whole.shape[0] > 7 and torch.equal(whole, sliced)


def test_klevel_regions_peeled_from_the_device_copies(monkeypatch):
    """Regions above ``host_peel_max`` re-peeled from the handle's device
    copies (``pkt.peel_rows_device``, here on the CPU with
    ``prep.compacts_on_device`` patched to choose it) give "klevel" the
    same states as "sequential" and a from-scratch decomposition."""
    from repro_torch.core import prep

    monkeypatch.setattr(prep, "compacts_on_device", lambda rows, dev: True)
    E = ring_of_cliques_edges(4, 6)
    rng = np.random.default_rng(3)
    pools = [E[rng.choice(len(E), 5, replace=False)] for _ in range(3)]
    batches = [b for pool in pools for b in ((None, pool), (pool, None))]
    batches.append((np.array([[0, 7], [1, 13], [2, 19]]), E[:3]))
    _, kl = _klevel_against_sequential(E, batches, local_frac=1.0,
                                       host_peel_max=0)
    assert kl.region_peels["device"] > 0 and kl.region_peels["host"] == 0


@pytest.mark.parametrize("name", ["rmat-tiny", "ba-tiny"])
def test_open_canonicalizes_on_the_device_as_on_the_host(name, monkeypatch):
    """A handle whose rows are canonicalized and its graph built by the
    device path (``prep.canonical``, ``prep.csr_graph``, ``prep.prepare``;
    here on the CPU, ``prep.on_device`` patched to choose it) opens in the
    host path's state, from rows in any order, either way round and
    repeated."""
    from repro_torch.core import prep

    E = named_graph(name)
    rng = np.random.default_rng(1)
    rows = np.concatenate([E, E[: len(E) // 3, ::-1]])[
        rng.permutation(len(E) + len(E) // 3)]
    host = port_inc.IncrementalTruss(rows, device=CPU)
    assert prep.canonical(rows, torch.device(CPU))[1] == host.n
    monkeypatch.setattr(prep, "on_device", lambda rows, device: True)
    E_dev, n_dev = prep.canonical(rows, torch.device(CPU))
    assert np.array_equal(E_dev, host.edges) and n_dev == host.n
    dev = port_inc.IncrementalTruss(rows, device=CPU)
    for f in ("edges", "trussness", "support", "triangles"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f
    with pytest.raises(ValueError, match="self-loop"):
        prep.canonical(np.array([[1, 2], [3, 3]]), torch.device(CPU))


@pytest.mark.parametrize("host_peel_max", [0, 4096])
def test_klevel_toggles_on_a_skewed_graph_equal_scratch(host_peel_max):
    """Edges of an R-MAT graph deleted and put back under "klevel", every
    region re-peeled by the host mirror or by ``peel_live_subset`` (which
    peels every triangle among the region's local edges, those the region
    search left out included): after each batch the trussness equals a
    from-scratch decomposition."""
    E = rmat_edges(10, 16, seed=1)
    rng = np.random.default_rng(1)
    pools = E[rng.choice(len(E), 24, replace=False)].reshape(3, 8, 2)
    kl = port_inc.IncrementalTruss(E, insert_mode="klevel",
                                   host_peel_max=host_peel_max, device=CPU)
    for pool in pools:
        for batch in (dict(remove_edges=pool), dict(add_edges=pool)):
            assert kl.update(**batch).mode == "local"
            assert np.array_equal(kl.trussness,
                                  truss_pkt(kl.edges, device=CPU)), batch
    assert kl.region_peels["device" if host_peel_max == 0 else "host"] > 0


def test_klevel_ceiling_keeps_an_edge_put_back_local():
    """An edge of the graph's top level deleted and put back: under the
    ceiling (the decomposition at open) its re-insertion searches only the
    edges its deletion lowered, where without one the search takes the
    whole top level and the batch falls back."""
    E = rmat_edges(10, 16, seed=1)
    kl = port_inc.IncrementalTruss(E, insert_mode="klevel", device=CPU)
    T = kl.trussness
    top = np.nonzero(T == T.max())[0]
    assert top.size > 1000
    for e in top[:3]:
        edge = kl.edges[e][None]
        gone = kl.update(remove_edges=edge)
        back = kl.update(add_edges=edge)
        assert back.mode == "local" and back.affected <= gone.affected + 1
        _assert_scratch(kl)
        kl.update(remove_edges=edge)
        kl._ceiling = None
        back = kl.update(add_edges=edge)
        assert back.mode == "full" or back.affected > top.size
        assert np.array_equal(kl.trussness, T)


def test_klevel_ceiling_follows_the_graph_out():
    """Deletions keep the ceiling; an inserted edge it lacks makes the new
    graph the ceiling; and a script that puts edges back, in other groups
    and beside new edges, equals "sequential" and a from-scratch
    decomposition after every batch."""
    E = rmat_edges(9, 8, seed=2)
    rng = np.random.default_rng(2)
    pools = E[rng.choice(len(E), 18, replace=False)].reshape(3, 6, 2)
    have = {tuple(r) for r in E.tolist()}
    new = np.array([r for r in ((i, j) for i in range(40)
                                for j in range(i + 1, 40))
                    if r not in have][:4], np.int64)
    kl = port_inc.IncrementalTruss(E, insert_mode="klevel", device=CPU)
    keys = kl._ceiling[1].clone()
    kl.update(remove_edges=np.concatenate(pools))
    assert torch.equal(kl._ceiling[1], keys)
    kl.update(add_edges=pools[0])
    assert torch.equal(kl._ceiling[1], keys)
    kl.update(add_edges=new[:1])
    n, keys, T = kl._ceiling
    want = torch.from_numpy(kl.edges[:, 0] * n + kl.edges[:, 1])
    assert torch.equal(keys, want)
    assert np.array_equal(T.numpy(), kl.trussness)
    batches = [(None, np.concatenate(pools[:2])), (pools[0], None),
               (None, pools[2][:3]), (np.concatenate([pools[1], pools[2]]),
                                      None),
               (None, pools[1]), (np.concatenate([new[2:], pools[1][:3]]),
                                  pools[0][:2]),
               (np.concatenate([pools[0][:2], pools[1][3:]]), None)]
    _klevel_against_sequential(E, batches, local_frac=1.0)
    # grown past its ceiling, a K5 with three edges to a sixth vertex
    # becomes a K6: the edge put back rises above where it stood (a path
    # beside it keeps the batches local)
    K6 = np.array([[i, j] for i in range(6) for j in range(i + 1, 6)],
                  np.int64)
    grown = (K6[:, 1] == 5) & (K6[:, 0] >= 3)
    path = np.stack([np.arange(6, 60), np.arange(7, 61)], 1)
    seq, kl = _klevel_against_sequential(
        np.concatenate([K6[~grown], path]),
        [(None, K6[:1]), (K6[grown], None), (K6[:1], None)], local_frac=1.0)
    assert kl.stats["full"] == 0 and (kl.query(K6) == 6).all()
