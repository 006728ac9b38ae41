"""Port parity: wedge tables, the support phase and K1's plain version.

Seeded numpy graphs go through ``repro`` (the JAX reference, Pallas in
interpret mode) and ``repro_torch`` on the CPU; every comparison is exact
equality — support is integer-only and integer adds are order-free.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.support as ref_support
import repro.graphs.csr as ref_csr
import repro.kernels.wedge_common as ref_wc
from repro.core.pkt import chunk_ranges as ref_chunk_ranges
from repro.core.ref import support_naive
from repro.graphs.gen import ring_of_cliques_edges, rmat_edges
from repro.kernels.support import support_accumulate as ref_accumulate
from repro.kernels.support import support_counts as ref_support_counts

import repro_torch.core.support as port_support
import repro_torch.graphs.csr as port_csr
import repro_torch.kernels.wedge_common as port_wc
from repro_torch.kernels import support as port_kernel


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return ref_csr.edges_from_arrays(src, dst, n)


GRAPHS = {
    "single_edge": np.array([[0, 1]], np.int64),
    "star": np.stack([np.zeros(9, np.int64), np.arange(1, 10)], axis=1),
    "path": np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.int64),
    "clique": _er(7, 1.1, 0),
    "ring_of_cliques": ring_of_cliques_edges(4, 5),
    "rmat": rmat_edges(6, edge_factor=5, seed=3),
    "er": _er(30, 0.3, 5),
}


def _graphs(name):
    E = GRAPHS[name]
    return ref_csr.build_csr(E), port_csr.build_csr(E)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_tables_match_reference_rows(name):
    """The torch table functions reproduce the JAX ones row for row, with the
    same explicit chunk and the same inert sentinel padding."""
    gr, gp = _graphs(name)
    dr, dp = gr.device_arrays(), gp.device_arrays("cpu")
    m = gr.m

    sp = port_wc.next_pow2(max(1, port_support.support_table_size(gp)))
    assert port_support.support_table_size(gp) == \
        ref_support.support_table_size(gr)
    want = ref_support._build_support_table_dev(
        dr["El"][:, 0], dr["El"][:, 1], dr["Es"], dr["Eo"], jnp.int32(m),
        m=m, size=sp)
    got = port_support._build_support_table_dev(
        dp["u"], dp["v"], dp["Es"], dp["Eo"], m, m=m, size=sp)
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        assert np.array_equal(np.asarray(w), t.numpy())

    pp = port_wc.next_pow2(max(1, port_support.peel_table_size(gp)))
    assert port_support.peel_table_size(gp) == ref_support.peel_table_size(gr)
    chunk = port_wc.pow2_chunk(pp, 8)
    want = ref_support._build_peel_table_dev(
        dr["El"][:, 0], dr["El"][:, 1], dr["Es"], jnp.int32(m), m=m, size=pp,
        chunk=chunk)
    got = port_support._build_peel_table_dev(
        dp["u"], dp["v"], dp["Es"], m, m=m, size=pp, chunk=chunk)
    has = np.asarray(want[7])
    assert np.array_equal(has, got[7].numpy())
    for w, t in zip(want[:5], got[:5]):       # e1, cand, lo, hi, off
        assert np.array_equal(np.asarray(w), t.numpy())
    for w, t in zip(want[5:7], got[5:7]):     # c_start, c_end (where defined)
        assert np.array_equal(np.asarray(w)[has], t.numpy()[has])
    # and the host bookkeeping agrees with both
    ptab = port_support.build_peel_table(gp)
    h_has, h_cs, h_ce = ref_chunk_ranges(ptab.off, chunk)
    assert np.array_equal(h_has, has)
    assert np.array_equal(h_cs[has], got[5].numpy()[has])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_host_tables_match_reference(name):
    gr, gp = _graphs(name)
    for build in ("build_support_table", "build_peel_table"):
        a = getattr(ref_support, build)(gr)
        b = getattr(port_support, build)(gp)
        for f in ("e1", "cand_slot", "lo", "hi", "off"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (build, f)
    assert port_support._search_iters(gp) == ref_support._search_iters(gr)
    assert port_support._search_iters(gp, oriented=True) == \
        ref_support._search_iters(gr, oriented=True)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compute_support_all_modes_match_reference(name):
    gr, gp = _graphs(name)
    want = ref_support.compute_support(gr)
    naive = support_naive(gp.El, np.ones(gp.m, bool))
    assert np.array_equal(want, naive)
    for mode in port_support.SUPPORT_MODES:
        for table_mode in port_support.TABLE_MODES:
            for chunk in (None, 4):
                got = port_support.compute_support(
                    gp, mode=mode, table_mode=table_mode, chunk=chunk,
                    device="cpu")
                assert got.dtype == np.int32
                assert np.array_equal(got, want), (mode, table_mode, chunk)
    assert port_support.triangle_count(gp, device="cpu") == \
        int(want.sum()) // 3


@pytest.mark.parametrize("name", ["clique", "ring_of_cliques", "rmat", "er"])
@pytest.mark.parametrize("chunk", [16, 100])
def test_plain_k1_matches_pallas_interpret(name, chunk):
    """support_accumulate_ref, fed by the CSR, == the Pallas kernel
    (interpret mode) over the reference's own table on [:m], per-chunk
    triangle partials included; the partials sum to S.sum()/3."""
    gr, gp = _graphs(name)
    tab = port_support.build_support_table(gp)
    c, n_chunks = port_wc.chunk_layout(tab.size, chunk)
    arrays = port_wc.pad_chunked(tab.e1, tab.cand_slot, tab.lo, tab.hi,
                                 m=gp.m, chunk=c, n_chunks=n_chunks)
    iters = port_support._search_iters(gp, oriented=True)
    S_ref, tri_ref = ref_accumulate(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(gr.N),
        jnp.asarray(gr.Eid), chunk=c, n_chunks=n_chunks, iters=iters,
        m=gr.m, interpret=True)
    _, tri_total = ref_support_counts(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(gr.N),
        jnp.asarray(gr.Eid), chunk=c, n_chunks=n_chunks, iters=iters,
        m=gr.m, interpret=True)
    before = port_kernel.COUNTS.as_dict()
    dp = gp.device_arrays("cpu")
    S, tri = port_kernel.support_accumulate(
        dp["u"], dp["v"], dp["Es"], dp["Eo"], dp["N"], dp["Eid"], m=gp.m,
        chunk=c, n_chunks=n_chunks)
    after = port_kernel.COUNTS.as_dict()
    # a CPU tensor takes the plain version, never the kernel
    assert after["plain"] == before["plain"] + 1
    assert after["kernel"] == before["kernel"]
    assert S.shape == (gp.m + 1,) and tri.shape == (n_chunks,)
    assert np.array_equal(S.numpy()[:gp.m], np.asarray(S_ref)[:gr.m])
    assert np.array_equal(tri.numpy(), np.asarray(tri_ref))
    assert int(tri.sum()) == int(tri_total) == int(S[:gp.m].sum()) // 3
    assert int(S[gp.m]) == 0  # the port writes nothing to slot m


def test_slices_do_not_change_the_result(monkeypatch):
    """Walking the tables in slices is invisible in every executor."""
    import importlib

    port_pkt = importlib.import_module("repro_torch.core.pkt")
    gr, gp = _graphs("rmat")
    want = importlib.import_module("repro.core.pkt").pkt(gr)
    monkeypatch.setattr(port_wc, "SLICE_ROWS", 7)
    assert len(port_wc.row_slices(20)) == 3
    for mode in port_support.SUPPORT_MODES:
        assert np.array_equal(
            port_support.compute_support(gp, mode=mode, device="cpu"),
            want.support)
    for mode in port_pkt.PEEL_MODES:
        got = port_pkt.pkt(gp, mode=mode, chunk=4, device="cpu")
        assert np.array_equal(got.trussness, want.trussness), mode
        assert (got.levels, got.sublevels) == (want.levels, want.sublevels)


def test_probe_matches_reference():
    rng = np.random.default_rng(11)
    N = np.sort(rng.integers(0, 60, size=50)).astype(np.int32)
    lo = rng.integers(0, 50, size=200).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 20, size=200), 50).astype(np.int32)
    cand = rng.integers(0, 50, size=200).astype(np.int32)
    want = ref_wc.probe(jnp.asarray(N), jnp.asarray(cand), jnp.asarray(lo),
                        jnp.asarray(hi), iters=6)
    got = port_wc.probe(torch.tensor(N), torch.tensor(cand), torch.tensor(lo),
                        torch.tensor(hi), iters=6)
    got_np = port_wc.probe_np(N, cand, lo, hi, iters=6)
    for w, t, h in zip(want, got, got_np):
        assert np.array_equal(np.asarray(w), t.numpy())
        assert np.array_equal(np.asarray(w), h)
    # too few iterations: the search stops where the reference stops
    for iters in (1, 2):
        w = ref_wc.ranged_searchsorted(jnp.asarray(N), jnp.asarray(N[cand]),
                                       jnp.asarray(lo), jnp.asarray(hi), iters)
        t = port_wc.ranged_searchsorted(torch.tensor(N), torch.tensor(N[cand]),
                                        torch.tensor(lo), torch.tensor(hi),
                                        iters)
        assert np.array_equal(np.asarray(w), t.numpy())


def test_chunk_layout_matches_reference():
    for size in (0, 1, 5, 100, 4096, 1 << 20):
        for chunk in (1, 3, 64, 1 << 14, 1 << 30):
            assert port_wc.chunk_layout(size, chunk) == \
                ref_wc.chunk_layout(size, chunk)
            assert port_wc.pow2_chunk(max(1, port_wc.next_pow2(size)),
                                      chunk) == \
                ref_wc.pow2_chunk(max(1, ref_wc.next_pow2(size)), chunk)
        # the formula fallback: a pow2 within the band
        c = port_wc.auto_chunk(size)
        assert c & (c - 1) == 0
        assert port_wc.AUTO_CHUNK_MIN <= c <= port_wc.AUTO_CHUNK_MAX
    e1 = np.arange(5, dtype=np.int32)
    got = port_wc.pad_chunked(e1, e1, e1, e1 + 1, m=9, chunk=4, n_chunks=2)
    want = ref_wc.pad_chunked(e1, e1, e1, e1 + 1, m=9, chunk=4, n_chunks=2)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_invalid_modes_rejected():
    _, gp = _graphs("clique")
    with pytest.raises(ValueError, match="mode"):
        port_support.compute_support(gp, mode="jnp", device="cpu")
    with pytest.raises(ValueError, match="table_mode"):
        port_support.compute_support(gp, table_mode="disk", device="cpu")
    with pytest.raises(ValueError, match="int32"):
        port_support._check_table_size(1 << 31)
