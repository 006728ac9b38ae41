"""Port parity: the engine's handle API (``serve/truss_engine.py``).

``TrussEngine.open / update / update_many / close``, ticket promotion and
``TrussHandle``'s community queries on the port (``device="cpu"``) against
the JAX package's engine on the same graphs and batches.  Tolerance: exact
equality.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.pkt import truss_pkt as ref_truss_pkt
from repro.graphs.gen import ring_of_cliques_edges
from repro.serve.truss_engine import TrussEngine as RefEngine

from repro_torch.core.pkt import truss_pkt
from repro_torch.serve.truss_engine import TrussEngine, TrussHandle

CPU = "cpu"


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(mask, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def _stats(st):
    d = dataclasses.asdict(st)
    for k in ("seconds", "handle"):
        d.pop(k)
    return d


def _same(hr, hp):
    assert np.array_equal(hr.edges, hp.edges)
    assert np.array_equal(hr.trussness, hp.trussness)
    assert np.array_equal(hr._inc.support, hp._inc.support)
    assert np.array_equal(hr._inc.triangles, hp._inc.triangles)


def test_open_update_close():
    ref, eng = RefEngine(), TrussEngine(device=CPU)
    E = ring_of_cliques_edges(3, 5)
    hr, hp = ref.open(E), eng.open(E)
    assert isinstance(hp, TrussHandle) and hp.insert_mode == "batched"
    _same(hr, hp)
    assert np.array_equal(hp.trussness, truss_pkt(hp.edges, device=CPU))
    add, rm = np.array([[0, 2]]), np.array([[0, 1]])
    s1 = ref.update(hr, add_edges=add, remove_edges=rm)
    s2 = eng.update(hp, add_edges=add, remove_edges=rm)
    assert s2.handle is hp and _stats(s1) == _stats(s2)
    _same(hr, hp)
    for key in ("handles_opened", "updates", "updates_local",
                "updates_full"):
        assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["update_seconds"] > 0
    assert hp.n == hr.n and hp.m == hr.m and repr(hp).startswith("TrussHandle")
    eng.close(hp)
    assert hp.closed and repr(hp).endswith("closed)")
    with pytest.raises(ValueError, match="closed"):
        eng.update(hp, add_edges=np.array([[0, 3]]))
    eng.close(hp)  # idempotent


@pytest.mark.parametrize("local_frac", [1.0, 0.25])
def test_churned_handle_matches_reference(local_frac):
    """A churned handle stays equal to the reference handle, step by step,
    and to a from-scratch decomposition."""
    rng = np.random.default_rng(12)
    ref, eng = RefEngine(), TrussEngine(device=CPU)
    E = _er(22, 0.3, 50)
    hr = ref.open(E, local_frac=local_frac)
    hp = eng.open(E, local_frac=local_frac)
    for _ in range(3):
        cur = hp.edges
        rm = cur[rng.choice(cur.shape[0], size=2, replace=False)]
        add = np.stack([rng.integers(0, 24, 3), rng.integers(0, 24, 3)], 1)
        add = add[add[:, 0] != add[:, 1]]
        s1 = ref.update(hr, add_edges=add, remove_edges=rm)
        s2 = eng.update(hp, add_edges=add, remove_edges=rm)
        assert _stats(s1) == _stats(s2)
        _same(hr, hp)
        assert np.array_equal(hp.trussness, ref_truss_pkt(hp.edges))
    assert list(hp.query(hp.edges[:3])) == list(hr.query(hr.edges[:3]))


def test_ticket_promotion():
    """``update`` consumes a pending ticket and promotes it to a handle; a
    collected ticket cannot be promoted; a pending promotion does not
    disturb the bucket's other tickets."""
    eng = TrussEngine(device=CPU)
    E = _er(14, 0.35, 60)
    t = eng.submit(E)
    st = eng.update(t, add_edges=np.array([[0, 13]]))
    h = st.handle
    assert isinstance(h, TrussHandle)
    assert np.array_equal(h.trussness, ref_truss_pkt(h.edges))
    with pytest.raises(KeyError):
        eng.result(t)
    t2 = eng.submit(E)
    eng.result(t2)
    with pytest.raises(KeyError, match="cannot be promoted"):
        eng.update(t2)
    a, b = _er(14, 0.4, 35), _er(14, 0.4, 36)
    ta, tb = eng.submit(a), eng.submit(b)
    hb = eng.update(tb).handle
    assert np.array_equal(eng.result(ta), truss_pkt(a, device=CPU))
    assert np.array_equal(hb.trussness, truss_pkt(hb.edges, device=CPU))


def test_update_many_matches_sequential_and_reference():
    e = _er(16, 0.35, 37)
    b1 = (np.array([[0, 9], [1, 10]], np.int64), None)
    b2 = (np.array([[2, 11]], np.int64), np.array([[0, 9]], np.int64))
    b3 = (None, np.array([[1, 10]], np.int64))
    eng, ref = TrussEngine(device=CPU), RefEngine()
    h_seq = eng.open(e)
    for add, rem in (b1, b2, b3):
        eng.update(h_seq, add_edges=add, remove_edges=rem)
    h_one, h_ref = eng.open(e), ref.open(e)
    before = eng.stats["updates"]
    st = eng.update_many(h_one, [b1, b2, b3])
    st_ref = ref.update_many(h_ref, [b1, b2, b3])
    assert st.coalesced == 3 and st.handle is h_one
    assert _stats(st) == _stats(st_ref)
    assert eng.stats["updates"] == before + 1
    assert np.array_equal(h_one.edges, h_seq.edges)
    assert np.array_equal(h_one.trussness, h_seq.trussness)
    _same(h_ref, h_one)


@pytest.mark.parametrize("hier_mode", ["device", "host"])
def test_handle_communities_match_reference(hier_mode):
    """``communities``, edge and vertex ``community`` queries, and the
    ``hier_mode`` override, against the reference handle."""
    E = ring_of_cliques_edges(4, 6)
    ref = RefEngine(hier_mode=hier_mode)
    eng = TrussEngine(hier_mode=hier_mode, device=CPU)
    hr, hp = ref.open(E), eng.open(E)
    assert hp.hierarchy().mode == hier_mode
    assert hp.hierarchy() is hp.hierarchy()        # cached on the handle
    for k in (2, 3, 6, 7):
        c1, c2 = hr.communities(k), hp.communities(k)
        assert len(c1) == len(c2)
        assert all(np.array_equal(a, b) for a, b in zip(c1, c2))
        other = "host" if hier_mode == "device" else "device"
        c3 = hp.communities(k, hier_mode=other)
        assert all(np.array_equal(a, b) for a, b in zip(c1, c3))
        assert np.array_equal(hr.community((1, 0), k),
                              hp.community((1, 0), k))
        v1, v2 = hr.community(0, k), hp.community(0, k)
        assert len(v1) == len(v2)
        assert all(np.array_equal(a, b) for a, b in zip(v1, v2))
    assert [c.shape for c in hp.communities(6)] == [(15, 2)] * 4
    with pytest.raises(ValueError, match="not present"):
        hp.community((0, 9999), 3)


def test_engine_validation():
    with pytest.raises(ValueError, match="hier_mode"):
        TrussEngine(hier_mode="nope", device=CPU)
    with pytest.raises(ValueError, match="insert_mode"):
        TrussEngine(insert_mode="nope", device=CPU)
    eng = TrussEngine(insert_mode="sequential", device=CPU)
    h = eng.open(ring_of_cliques_edges(3, 4), insert_mode="batched")
    assert h.insert_mode == "batched"
    assert eng.open(ring_of_cliques_edges(3, 4)).insert_mode == "sequential"


def test_klevel_handle_toggles_through_the_engine():
    """The live-graph deployment's path: ``open(..., insert_mode="klevel")``
    then batches that delete edges and put them back through ``update``,
    each answer (``handle.trussness``) equal to a from-scratch
    decomposition of the handle's edges, every batch local; the community
    index carried across them agrees with a fresh one."""
    E = _er(80, 0.12, 11)
    eng = TrussEngine(device=CPU)
    h = eng.open(E, insert_mode="klevel")
    assert h.insert_mode == "klevel"
    rng = np.random.default_rng(11)
    pools = [E[rng.choice(len(E), 6, replace=False)] for _ in range(2)]
    h.communities(4)
    for pool in pools * 2:
        for batch in (dict(remove_edges=pool), dict(add_edges=pool)):
            st = eng.update(h, **batch)
            assert st.mode == "local" and st.handle is h
            assert np.array_equal(h.trussness,
                                  truss_pkt(h.edges, device=CPU))
            fresh = h.hierarchy(mode="host")
            assert [c.tolist() for c in h.communities(4)] == \
                [h.edges[ids].tolist() for ids in fresh.communities(4)]
    assert eng.stats["updates_local"] == 8
