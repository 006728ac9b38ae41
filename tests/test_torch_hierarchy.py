"""Port parity: the truss community index (``core/hierarchy.py``).

The port's ``TrussHierarchy`` (``device="cpu"``: the label flood runs as
torch ops on CPU tensors) against the JAX package's, on the same trussness
and triangle list: labels bitwise equal at every level in both modes,
equal ``stats``, and the same index carried across updates.  Tolerance:
exact equality.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import repro.core.hierarchy as ref_hier
from repro.core.truss_inc import IncrementalTruss as RefInc
from repro.graphs.csr import build_csr as ref_build_csr
from repro.graphs.datasets import named_graph
from repro.graphs.gen import ring_of_cliques_edges
from repro.serve.truss_engine import TrussEngine as RefEngine

import repro_torch.core.hierarchy as port_hier
from repro_torch.graphs.csr import build_csr as port_build_csr
from repro_torch.serve.truss_engine import TrussEngine as PortEngine

CPU = "cpu"


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(mask, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


GRAPHS = {
    "fig1": lambda: named_graph("fig1"),
    "karate_like": lambda: named_graph("karate_like"),
    "cliques-tiny": lambda: named_graph("cliques-tiny"),
    "rmat-tiny": lambda: named_graph("rmat-tiny"),
    "ba-tiny": lambda: named_graph("ba-tiny"),
    "er-24": lambda: _er(24, 0.3, 3),
    "er-50": lambda: _er(50, 0.25, 4),
    "ring": lambda: ring_of_cliques_edges(4, 5),
    "path": lambda: np.array([[i, i + 1] for i in range(6)], np.int64),
}


def _state(name):
    inc = RefInc(GRAPHS[name]())
    return inc.trussness, inc.triangles


def _assert_same(ref, port, levels=None):
    for k in (ref.levels if levels is None else levels):
        assert np.array_equal(ref.level_labels(k), port.level_labels(k)), k
    assert ref.stats == port.stats


@pytest.mark.parametrize("mode", port_hier.HIER_MODES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_all_matches_reference(name, mode):
    """The level sweep: labels at every level and the stats counters."""
    T, tri = _state(name)
    ref = ref_hier.TrussHierarchy(T, tri, mode=mode).build_all()
    port = port_hier.TrussHierarchy(T, tri, mode=mode,
                                    device=CPU).build_all()
    assert list(port.levels) == list(ref.levels) and port.k_max == ref.k_max
    _assert_same(ref, port)


@pytest.mark.parametrize("name", ["er-24", "er-50", "rmat-tiny"])
def test_forced_device_flood_matches_reference(name, monkeypatch):
    """With the host seeding cutoff at 0 every level with fresh rows takes
    the flood: same labels and stats as the reference's forced flood, and
    the port counts its rounds."""
    monkeypatch.setattr(ref_hier, "_SEED_ROWS_MAX", 0)
    monkeypatch.setattr(port_hier, "_SEED_ROWS_MAX", 0)
    T, tri = _state(name)
    ref = ref_hier.TrussHierarchy(T, tri).build_all()
    port = port_hier.TrussHierarchy(T, tri, device=CPU).build_all()
    _assert_same(ref, port)
    assert port.stats["device_levels"] > 0
    assert port.flood_rounds >= port.stats["device_levels"]


@pytest.mark.parametrize("name", ["er-24", "ring", "ba-tiny"])
def test_lazy_out_of_order_requests_match_reference(name):
    """Coldest-first lazy requests (no warm start) in device mode, and
    out-of-order requests in host mode (a fresh union-find above the
    shared frontier)."""
    T, tri = _state(name)
    for mode in port_hier.HIER_MODES:
        ref = ref_hier.TrussHierarchy(T, tri, mode=mode)
        port = port_hier.TrussHierarchy(T, tri, mode=mode, device=CPU)
        ks = sorted(ref.levels)
        order = ks if mode == "device" else ks[:1] + ks[::-1]
        for k in order:
            assert np.array_equal(ref.level_labels(k),
                                  port.level_labels(k)), (mode, k)
        assert ref.stats == port.stats


@pytest.mark.parametrize("name", ["karate_like", "er-50", "ring"])
def test_queries_match_reference(name):
    """``communities``, ``community_of`` and ``parents`` at every level."""
    T, tri = _state(name)
    ref = ref_hier.TrussHierarchy(T, tri)
    port = port_hier.TrussHierarchy(T, tri, device=CPU)
    for k in [1] + list(ref.levels) + [ref.k_max + 1]:
        c1, c2 = ref.communities(k), port.communities(k)
        assert len(c1) == len(c2)
        assert all(np.array_equal(a, b) for a, b in zip(c1, c2))
        for e in (0, T.shape[0] // 2, T.shape[0] + 3):
            assert np.array_equal(ref.community_of(e, k),
                                  port.community_of(e, k))
        if 2 <= k <= ref.k_max:
            for a, b in zip(ref.parents(k), port.parents(k)):
                assert np.array_equal(a, b)


def test_hierarchy_from_graph_and_validation():
    E = named_graph("fig1")
    inc = RefInc(E)
    ref = ref_hier.hierarchy_from_graph(ref_build_csr(E), inc.trussness)
    port = port_hier.hierarchy_from_graph(port_build_csr(E), inc.trussness,
                                          device=CPU)
    assert np.array_equal(port.tri, ref.tri)
    _assert_same(ref.build_all(), port.build_all())
    with pytest.raises(ValueError, match="mode must be one of"):
        port_hier.TrussHierarchy(np.zeros(0, np.int64),
                                 np.zeros((0, 3), np.int64), mode="gpu",
                                 device=CPU)
    with pytest.raises(ValueError, match="beyond"):
        port_hier.TrussHierarchy(np.array([2, 2]), np.array([[0, 1, 7]]),
                                 device=CPU)
    empty = port_hier.TrussHierarchy(np.zeros(0, np.int64),
                                     np.zeros((0, 3), np.int64), device=CPU)
    assert list(empty.levels) == [] and empty.communities(2) == []


def test_index_remapped_after_local_repair():
    """Deleting a trussness-2 bridge carries every level above it by id
    translation (``remapped``) in both packages; the carried index equals
    a fresh build and the reference's carried index."""
    E = ring_of_cliques_edges(4, 6)
    ref_eng, port_eng = RefEngine(), PortEngine(device=CPU)
    hr = ref_eng.open(E, local_frac=1.0)
    hp = port_eng.open(E, local_frac=1.0)
    hr.hierarchy().build_all()
    hp.hierarchy().build_all()
    bridge = hp.edges[int(np.argmin(hp.trussness))].reshape(1, 2)
    s1 = ref_eng.update(hr, remove_edges=bridge)
    s2 = port_eng.update(hp, remove_edges=bridge)
    assert s1.mode == s2.mode == "local"
    ref, port = hr.hierarchy(), hp.hierarchy()
    assert port.stats["remapped_levels"] >= port.k_max - 2
    _assert_same(ref, port)
    fresh = port_hier.TrussHierarchy(hp._inc.trussness, hp._inc.triangles,
                                     mode="host", device=CPU).build_all()
    for k in fresh.levels:
        assert np.array_equal(port.level_labels(k), fresh.level_labels(k))


@st.composite
def update_scripts(draw):
    n = draw(st.integers(8, 20))
    density = draw(st.floats(0.15, 0.5))
    seed = draw(st.integers(0, 2**31 - 1))
    script = [(draw(st.integers(0, 5)), draw(st.integers(0, 5)))
              for _ in range(draw(st.integers(1, 3)))]
    return n, _er(n, density, seed), script, seed


@pytest.mark.parametrize("local_frac", [1.0, 0.0])
@given(script=update_scripts(),
       insert_mode=st.sampled_from(["sequential", "batched"]))
@settings(max_examples=3, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_property_index_across_updates(local_frac, script, insert_mode):
    """Handles of both packages take one script with their index built
    before every batch: the carried (local repairs) or dropped (full
    fallback) index stays bitwise equal to the reference's, stats too."""
    n, E, batches, seed = script
    if E.shape[0] == 0:
        return
    ref_eng = RefEngine(insert_mode=insert_mode)
    port_eng = PortEngine(insert_mode=insert_mode, device=CPU)
    hr = ref_eng.open(E, local_frac=local_frac)
    hp = port_eng.open(E, local_frac=local_frac)
    rng = np.random.default_rng(seed + 1)
    for n_add, n_rm in batches:
        hr.hierarchy().build_all()
        hp.hierarchy().build_all()
        cur = hr.edges
        m = cur.shape[0]
        rm = cur[rng.choice(m, size=min(n_rm, m), replace=False)] \
            if m else np.zeros((0, 2), np.int64)
        add = np.stack([rng.integers(0, n + 2, n_add),
                        rng.integers(0, n + 2, n_add)], axis=1)
        add = add[add[:, 0] != add[:, 1]]
        ref_eng.update(hr, add_edges=add, remove_edges=rm)
        port_eng.update(hp, add_edges=add, remove_edges=rm)
        if hr.m == 0:
            continue
        ref, port = hr.hierarchy(), hp.hierarchy()
        assert ref.stats == port.stats
        _assert_same(ref.build_all(), port.build_all())
