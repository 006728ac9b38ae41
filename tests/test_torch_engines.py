"""Port parity: the paper's support and decomposition family.

``enumerate_triangles``, ``truss_trilist``, ``kcore_park``, ``truss_wc``,
``truss_ros`` and ``compute_support_ros`` of the port, on the CPU, against
the JAX package on the same seeded numpy graphs — exact equality, since
every result is an integer array.  The hypothesis mirrors of
``test_property_wc_equals_pkt`` and ``test_property_park_equals_bz`` hold
the port against itself and its oracles, as the reference's tests do.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st, HealthCheck

from repro.core.kcore import kcore_park as ref_kcore_park
from repro.core.ros import truss_ros as ref_truss_ros
from repro.core.support import build_peel_table as ref_build_peel_table
from repro.core.support import compute_support_ros as ref_support_ros
from repro.core.triangle_list import enumerate_triangles as ref_enumerate
from repro.core.triangle_list import truss_trilist as ref_trilist
from repro.core.wc import truss_wc as ref_truss_wc
from repro.graphs.csr import build_csr as ref_build
from repro.graphs.csr import edges_from_arrays
from repro.graphs.gen import (barabasi_albert_edges, ring_of_cliques_edges,
                              rmat_edges)

from repro_torch.core import (compute_support_ros, enumerate_triangles,
                              kcore_numpy, kcore_park, pkt, truss_numpy,
                              truss_ros, truss_trilist, truss_wc)
from repro_torch.core.support import compute_support
from repro_torch.graphs.csr import build_csr as port_build

SETTINGS = dict(max_examples=25, deadline=None,
                suppress_health_check=[HealthCheck.too_slow])


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return edges_from_arrays(src, dst, n)


GRAPHS = {
    "star": np.stack([np.zeros(9, np.int64), np.arange(1, 10)], axis=1),
    "path": np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.int64),
    "clique": _er(7, 1.1, 0),
    "ring_of_cliques": ring_of_cliques_edges(4, 5),
    "rmat": rmat_edges(7, edge_factor=6, seed=3),
    "ba": barabasi_albert_edges(40, 3, seed=2),
    "er": _er(30, 0.3, 5),
}


def _graphs(name):
    E = GRAPHS[name]
    gr, gp = ref_build(E), port_build(E)
    for f in ("N", "Eid", "Es", "Eo", "El"):
        assert np.array_equal(getattr(gr, f), getattr(gp, f)), f
    return gr, gp


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_enumerate_triangles_same_array_same_order(name):
    gr, gp = _graphs(name)
    want = ref_enumerate(gr)
    got = enumerate_triangles(gp, device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_truss_trilist_matches_reference(name):
    gr, gp = _graphs(name)
    got = truss_trilist(gp, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, ref_trilist(gr))
    assert np.array_equal(got, truss_numpy(gp.El))


def test_peel_trilist_counts_match_pkt():
    """The triangle-list peel walks the same levels and sub-levels as PKT
    (compaction off: it does not change the counts)."""
    from repro_torch.core.triangle_list import _triangles_dev, peel_trilist

    gp = port_build(GRAPHS["rmat"])
    res = pkt(gp, compact_frac=None, device="cpu")
    S0 = torch.from_numpy(res.support)
    S, levels, subs = peel_trilist(_triangles_dev(gp, torch.device("cpu")),
                                   S0, m=gp.m)
    assert np.array_equal(S.numpy() + 2, res.trussness)
    assert (levels, subs) == (res.levels, res.sublevels)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kcore_park_matches_reference(name):
    gr, gp = _graphs(name)
    got = kcore_park(gp, device="cpu")
    want = ref_kcore_park(gr)
    assert got.dtype == np.asarray(want).dtype
    assert np.array_equal(got, want)
    assert np.array_equal(got, kcore_numpy(gp))


#: isolated vertices in the middle of the id space
GAPS = np.array([[0, 1], [1, 2], [0, 2], [2, 3], [9, 10], [10, 11], [9, 11],
                 [11, 12], [20, 27]], np.int64)


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["gaps"])
def test_coreness_off_the_card_runs_the_torch_loop(name):
    """``kcore.coreness`` on CPU tensors is ``peel_cores`` over the CSR's
    slots: BZ's coreness, the torch loop's sub-levels with one host read
    each, its plain version counted and nothing launched."""
    from repro_torch.core.kcore import coreness, peel_cores
    from repro_torch.kernels import kcore as kcore_kernel

    gp = port_build(GAPS) if name == "gaps" else _graphs(name)[1]
    arrays = gp.device_arrays("cpu")
    deg = torch.tensor(gp.degrees)
    rows = torch.repeat_interleave(torch.arange(gp.n, dtype=torch.int32),
                                   deg.to(torch.int64))
    want, subs = peel_cores(arrays["N"], rows, deg)
    before = kcore_kernel.COUNTS.mine()
    got = coreness(arrays["Es"], arrays["N"])
    assert kcore_kernel.COUNTS.mine() == {"kernel": before["kernel"],
                                          "plain": before["plain"] + 1}
    assert got.core.dtype == torch.int32 and torch.equal(got.core, want)
    assert np.array_equal(got.core.numpy(), kcore_numpy(gp))
    assert (got.sublevels, got.host_reads, got.blocks) == (subs, subs, 0)
    assert 0 < subs <= 2 * gp.n


def test_core_loop_runs_only_on_a_card():
    """The kernel's wrapper launches or refuses: CPU tensors are
    ``coreness``'s to route to ``peel_cores``."""
    from repro_torch.kernels import kcore as kcore_kernel

    Es = torch.tensor([0, 1, 2], dtype=torch.int32)
    N = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kcore_kernel.core_loop(Es, N)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compute_support_ros_matches_reference(name):
    gr, gp = _graphs(name)
    want = ref_support_ros(gr)
    got = compute_support_ros(gp, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, compute_support(gp, device="cpu"))
    # a prebuilt host table gives the same support
    assert np.array_equal(
        compute_support_ros(gp, ref_build_peel_table(gr), device="cpu"), want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wc_and_ros_match_reference(name):
    gr, gp = _graphs(name)
    want = ref_truss_wc(gr)
    assert np.array_equal(truss_wc(gp), want)
    assert np.array_equal(truss_ros(gp, device="cpu"), ref_truss_ros(gr))
    assert np.array_equal(truss_ros(gp, device="cpu"), want)


def test_empty_graph():
    g = port_build(np.zeros((0, 2), np.int64), 3)
    assert enumerate_triangles(g, device="cpu").shape == (0, 3)
    assert truss_trilist(g, device="cpu").shape == (0,)
    assert compute_support_ros(g, device="cpu").shape == (0,)
    assert truss_ros(g, device="cpu").shape == (0,)
    assert truss_wc(g).shape == (0,)
    assert np.array_equal(kcore_park(g, device="cpu"), np.zeros(3, np.int32))


def test_entry_points_refuse_to_run_on_cpu_by_default(monkeypatch):
    """Without a card, each new entry point raises unless asked for the
    CPU.  ``truss_wc`` is a host loop by design and takes no device."""
    from repro_torch.kernels.ops import compute_support_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = port_build(np.array([[0, 1], [1, 2], [0, 2]], np.int64))
    for fn in (enumerate_triangles, truss_trilist, kcore_park,
               compute_support_ros, truss_ros, compute_support_kernel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(g)
        fn(g, device="cpu")


# ------------------------------------------------------------ hypothesis ----

@st.composite
def graphs(draw):
    n = draw(st.integers(4, 28))
    density = draw(st.floats(0.05, 0.6))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    src, dst = np.nonzero(np.triu(mask, 1))
    return edges_from_arrays(src, dst, n)


@given(graphs())
@settings(**SETTINGS)
def test_property_wc_equals_pkt(E):
    if E.size == 0:
        return
    g = port_build(E)
    want = pkt(g, device="cpu").trussness
    assert np.array_equal(truss_wc(g), want)
    assert np.array_equal(truss_ros(g, device="cpu"), want)
    assert np.array_equal(truss_trilist(g, device="cpu"), want)


@given(graphs())
@settings(**SETTINGS)
def test_property_park_equals_bz(E):
    if E.size == 0:
        return
    g = port_build(E)
    core = kcore_numpy(g)
    assert np.array_equal(kcore_park(g, device="cpu"), core)
    # coreness ≤ degree, and the max k-core is non-empty
    assert (core <= g.degrees).all()
