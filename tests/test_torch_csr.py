"""Port parity: graph substrate and k-core of ``repro_torch`` vs ``repro``.

The same seeded numpy inputs go through both packages; every array must be
equal (exact: the graph layer is integer-only).
"""

import numpy as np
import pytest
import torch

import repro.core.kcore as ref_kcore
import repro.graphs.csr as ref_csr
import repro.graphs.datasets as ref_datasets
import repro.graphs.gen as ref_gen
import repro_torch.core.kcore as port_kcore
import repro_torch.core.prep as port_prep
import repro_torch.graphs.csr as port_csr
import repro_torch.graphs.datasets as port_datasets
import repro_torch.graphs.gen as port_gen


def _er_raw(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def _noisy_raw(seed):
    """Endpoint-swapped and duplicate rows (no self-loops)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 30, size=(120, 2))
    e = e[e[:, 0] != e[:, 1]]
    return np.concatenate([e, e[:10, ::-1], e[:5]]).astype(np.int64)


GRAPHS = {
    "empty": np.zeros((0, 2), np.int64),
    "single_edge": np.array([[0, 1]], np.int64),
    "star": np.stack([np.zeros(9, np.int64), np.arange(1, 10)], axis=1),
    "clique": _er_raw(8, 1.1, 0),
    "er_sparse": _er_raw(40, 0.1, 1),
    "er_dense": _er_raw(25, 0.5, 2),
    "noisy": _noisy_raw(3),
    "rmat": ref_gen.rmat_edges(7, edge_factor=6, seed=4),
    "ring_of_cliques": ref_gen.ring_of_cliques_edges(5, 6),
    # n >= 2^15: the reference's build_csr takes its vectorized Eo branch
    "wide_ids": np.array([[0, 40000], [40000, 40001], [0, 40001],
                          [5, 39999]], np.int64),
    "rmat_wide": np.concatenate([ref_gen.rmat_edges(7, edge_factor=6, seed=5),
                                 [[3, 40000]]]).astype(np.int64),
}


def _assert_graph_equal(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    for f in ("Es", "N", "Eid", "El", "Eo"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.degrees, b.degrees)
    assert np.array_equal(a.dplus, b.dplus)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_csr_pipeline_matches_reference(name):
    raw = GRAPHS[name]
    ref = ref_csr.canonical_edges_with_rows(raw)
    got = port_csr.canonical_edges_with_rows(raw)
    for x, y in zip(ref[:3], got[:3]):
        assert np.array_equal(x, y)
    assert ref[3] == got[3]
    E, lo, hi, n = got
    gr, gp = ref_csr.build_csr(E, n), port_csr.build_csr(E, n)
    _assert_graph_equal(gr, gp)
    if E.size == 0:
        return
    assert np.array_equal(ref_csr.edge_keys(lo, hi, n),
                          port_csr.edge_keys(lo, hi, n))
    assert np.array_equal(ref_kcore.kcore_numpy(gr), port_kcore.kcore_numpy(gp))
    for order, port_home in (("degeneracy_order", port_prep),
                             ("degree_order", port_csr)):
        perm_r = getattr(ref_csr, order)(E, n)
        perm_p = getattr(port_home, order)(E, n)
        assert np.array_equal(perm_r, perm_p), order
        assert np.array_equal(ref_csr.relabel(E, perm_r),
                              port_csr.relabel(E, perm_p))
    assert np.array_equal(ref_csr.edges_from_arrays(raw[:, 0], raw[:, 1]),
                          port_csr.edges_from_arrays(raw[:, 0], raw[:, 1]))


@pytest.mark.parametrize("seed", range(4))
def test_kcore_matches_reference_on_power_law(seed):
    E = ref_gen.barabasi_albert_edges(300, m_attach=3 + seed, seed=seed)
    gr, gp = ref_csr.build_csr(E), port_csr.build_csr(E)
    assert np.array_equal(ref_kcore.kcore_numpy(gr), port_kcore.kcore_numpy(gp))


BAD_EDGES = {
    "float_dtype": np.array([[0.0, 1.0]]),
    "bad_shape": np.array([[0, 1, 2]], np.int64),
    "negative_id": np.array([[0, 1], [-1, 2]], np.int64),
    "huge_id": np.array([[0, np.iinfo(np.int32).max]], np.int64),
    "self_loop": np.array([[0, 1], [3, 3]], np.int64),
}


@pytest.mark.parametrize("name", sorted(BAD_EDGES))
def test_same_rejections(name):
    bad = BAD_EDGES[name]
    with pytest.raises(ValueError) as ref_err:
        ref_csr.check_edge_array(bad)
    with pytest.raises(ValueError) as port_err:
        port_csr.canonical_edges_with_rows(bad)
    assert str(port_err.value) == str(ref_err.value)


def test_edge_keys_bounds_match_reference():
    # the tests/test_edge_keys.py cases: widening at n = 2^31, the
    # MAX_PACK_N boundary, the pack space beyond it, ids outside it
    assert port_csr.MAX_PACK_N == ref_csr.MAX_PACK_N
    n = 1 << 31
    lo = np.array([0, 1, (1 << 31) - 2], dtype=np.int32)
    hi = np.array([1, 2, (1 << 31) - 1], dtype=np.int32)
    got = port_csr.edge_keys(lo, hi, n)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref_csr.edge_keys(lo, hi, n))
    big = port_csr.MAX_PACK_N
    assert int(port_csr.edge_keys(np.array([big - 2]), np.array([big - 1]),
                                  big)[0]) == (big - 2) * big + (big - 1)
    one = np.array([0], np.int64)
    for fn in (ref_csr.edge_keys, port_csr.edge_keys):
        with pytest.raises(ValueError, match="overflows int64"):
            fn(one, one + 1, big + 1)
        with pytest.raises(ValueError, match="vertex ids must lie in"):
            fn(np.array([0]), np.array([100]), 100)
        with pytest.raises(ValueError, match="vertex ids must lie in"):
            fn(np.array([-1]), np.array([5]), 100)
        assert fn(one[:0], one[:0], big).shape == (0,)
    with pytest.raises(ValueError):
        port_csr.edges_from_arrays(np.array([0]), np.array([big]))


def test_device_arrays_cached_per_device():
    g = port_csr.build_csr(GRAPHS["rmat"])
    dev = g.device_arrays("cpu")
    assert g.device_arrays(torch.device("cpu")) is dev
    for key in ("N", "Eid", "Es", "Eo", "El"):
        t = dev[key]
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), getattr(g, key))
    assert np.array_equal(dev["u"].numpy(), g.El[:, 0])
    assert np.array_equal(dev["v"].numpy(), g.El[:, 1])
    assert dev["u"].is_contiguous() and dev["v"].is_contiguous()
    # a copy: writing through the tensor leaves the host graph untouched
    dev["N"][0] += 1
    assert g.N[0] + 1 == int(dev["N"][0])


@pytest.mark.parametrize("name", ["fig1", "karate_like", "triangle", "k4",
                                  "path", "cliques-tiny", "rmat-tiny",
                                  "ba-tiny", "er-tiny"])
def test_named_graphs_match_reference(name):
    assert np.array_equal(ref_datasets.named_graph(name),
                          port_datasets.named_graph(name))


def test_generators_match_reference():
    assert np.array_equal(ref_gen.rmat_edges(9, edge_factor=16, seed=0),
                          port_gen.rmat_edges(9, edge_factor=16, seed=0))
    assert np.array_equal(ref_gen.erdos_renyi_edges(200, 6.0, seed=1),
                          port_gen.erdos_renyi_edges(200, 6.0, seed=1))
    assert np.array_equal(ref_gen.barabasi_albert_edges(150, 4, seed=2),
                          port_gen.barabasi_albert_edges(150, 4, seed=2))
    assert port_datasets.GRAPH_SUITE == ref_datasets.GRAPH_SUITE
