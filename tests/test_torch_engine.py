"""Port parity: the one-shot ``TrussEngine`` of ``repro_torch`` on the CPU.

Mixed-size submissions must come back equal to the JAX engine's results and
to the numpy oracle; the flush-ordering, admission and ticket contracts of
``tests/test_truss_engine.py`` hold for the port too.
"""

import functools

import numpy as np
import pytest

from repro.core.ref import truss_numpy
from repro.graphs.csr import edges_from_arrays
from repro.graphs.gen import ring_of_cliques_edges, rmat_edges
from repro.serve.truss_engine import TrussEngine as RefEngine

from repro_torch.core.pkt import pkt, truss_pkt
from repro_torch.graphs.csr import build_csr
from repro_torch.kernels import count_launches
from repro_torch.kernels import support as support_kernel
from repro_torch.serve import truss_engine as te
from repro_torch.serve.truss_engine import (TrussEngine, disjoint_union,
                                            truss_batched)


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return edges_from_arrays(src, dst, n)


def _oracle(edges):
    """truss_numpy on the canonical edges, mapped to each input row."""
    e = np.asarray(edges, np.int64)
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    E = edges_from_arrays(lo, hi)
    t = truss_numpy(E)
    pos = {(int(a), int(b)): i for i, (a, b) in enumerate(E)}
    return np.array([t[pos[(int(a), int(b))]] for a, b in zip(lo, hi)])


def _fleet():
    return [
        _er(12, 0.4, 0),
        ring_of_cliques_edges(3, 5),
        np.array([[0, 1]], np.int64),                  # tiny: one edge
        _er(36, 0.2, 1),
        rmat_edges(6, edge_factor=4, seed=2),
        np.array([[0, 1], [1, 2]], np.int64),          # tiny: path
        _er(20, 0.35, 3),
        np.array([[2, 1], [0, 1], [1, 0], [0, 2]], np.int64),  # swapped, dup
    ]


@functools.lru_cache(maxsize=None)
def _reference_results(table_mode):
    return RefEngine(table_mode=table_mode).map(_fleet())


@pytest.mark.parametrize("table_mode", ["device", "numpy"])
@pytest.mark.parametrize("mode", ["kernel", "chunked"])
def test_mixed_sizes_match_reference_engine(table_mode, mode):
    fleet = _fleet()
    eng = TrussEngine(mode=mode, table_mode=table_mode, device="cpu")
    tickets = [eng.submit(e) for e in fleet]
    assert len({eng.bucket_of(t) for t in tickets}) >= 3   # several classes
    # resolve out of submission order
    got = {t: eng.result(t) for t in reversed(tickets)}
    want = _reference_results(table_mode)
    for i, t in enumerate(tickets):
        assert got[t].dtype == np.int64
        assert np.array_equal(got[t], want[i]), i
        assert np.array_equal(got[t], _oracle(fleet[i])), i
    assert eng.stats["graphs_done"] == len(fleet)
    assert eng.throughput > 0
    # on the CPU every dispatch took the plain versions, never a kernel
    for launches in eng.stats["bucket_launches"].values():
        assert launches["support"] == launches["peel"] == 0
        # the kernel peel executor runs K2's plain version every sub-level
        assert launches["plain"] > 0 or mode != "kernel"


def test_one_bucket_is_one_union_dispatch():
    a, b, c = _er(16, 0.3, 10), _er(16, 0.3, 11), _er(16, 0.3, 12)
    eng = TrussEngine(device="cpu")
    ts = [eng.submit(e) for e in (a, b, c)]
    keys = {eng.bucket_of(t) for t in ts}
    support0 = support_kernel.COUNTS.plain
    eng.flush()
    # one support fold for the whole bucket
    assert support_kernel.COUNTS.plain - support0 == len(keys)
    assert eng.stats["batches"] == len(keys)
    for t, e in zip(ts, (a, b, c)):
        assert np.array_equal(eng.result(t), _oracle(e))


def test_count_launches_reads_one_block():
    """count_launches reports the block's K1/K2/update/loop/K3 launches
    and plain calls only: on the CPU, one support fold, one peel loop per
    segment, one peel fold per sub-level and one update per sub-level and
    per level start, all plain."""
    E = ring_of_cliques_edges(3, 5)
    truss_pkt(E, device="cpu")   # counted before the block: must not show
    with count_launches() as counted:
        assert counted == {}     # filled only when the block exits
        res = pkt(build_csr(E), device="cpu")
    assert counted == {"support": 0, "peel": 0, "update": 0, "loop": 0,
                       "intersect": 0,
                       "plain": (1 + (res.compactions + 1)
                                 + 2 * res.sublevels + res.levels)}


def test_disjoint_union_equals_build_csr():
    graphs = [build_csr(e) for e in (_er(10, 0.4, 20), _er(7, 0.6, 21),
                                     ring_of_cliques_edges(2, 4))]
    op = disjoint_union(graphs)
    offs = np.cumsum([0] + [g.n for g in graphs])
    E = np.concatenate([g.El.astype(np.int64) + o
                        for g, o in zip(graphs, offs)])
    want = build_csr(E, int(offs[-1]))
    for f in ("Es", "N", "Eid", "El", "Eo"):
        assert np.array_equal(getattr(op.g, f), getattr(want, f)), f
    assert (op.g.n, op.g.m) == (want.n, want.m)
    assert op.edge_off.tolist() == np.cumsum([0] + [g.m for g in graphs]
                                             ).tolist()


def test_flush_failure_keeps_tickets_pending(monkeypatch):
    e1, e2 = _er(12, 0.4, 33), _er(12, 0.4, 34)
    eng = TrussEngine(device="cpu")
    t1, t2 = eng.submit(e1), eng.submit(e2)

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(TrussEngine, "_dispatch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.flush()
    assert eng.bucket_of(t1) is not None      # still pending, not lost
    assert eng.bucket_of(t2) is not None
    monkeypatch.undo()
    assert np.array_equal(eng.result(t1), _oracle(e1))
    assert np.array_equal(eng.result(t2), _oracle(e2))


def test_flush_only_selected_bucket():
    small, big = _er(12, 0.4, 30), _er(40, 0.2, 31)
    eng = TrussEngine(device="cpu")
    ts, tb = eng.submit(small), eng.submit(big)
    ks, kb = eng.bucket_of(ts), eng.bucket_of(tb)
    assert ks is not None and kb is not None and ks != kb
    eng.flush(only=[ks])
    assert eng.bucket_of(ts) is None
    assert eng.bucket_of(tb) == kb
    assert np.array_equal(eng.result(ts), _oracle(small))
    assert np.array_equal(eng.result(tb), _oracle(big))
    eng.submit(small)
    eng.flush(only=[kb])                      # unknown key: no-op
    assert eng.stats["graphs_done"] == 2


def test_flush_mode_overrides_and_host_flush():
    fleet = [_er(14, 0.4, 40), rmat_edges(5, edge_factor=4, seed=41)]
    eng = TrussEngine(device="cpu")
    ts = eng.submit_many(fleet)
    eng.flush(mode="dense", support_mode="torch")
    for t, e in zip(ts, fleet):
        assert np.array_equal(eng.result(t), _oracle(e))
    ts = eng.submit_many(fleet)
    eng.flush_host()
    for t, e in zip(ts, fleet):
        assert np.array_equal(eng.result(t), _oracle(e))
    with pytest.raises(ValueError, match="mode"):
        eng.flush(mode="pallas")
    with pytest.raises(ValueError, match="support_mode"):
        eng.flush(support_mode="jnp")


def test_oversized_graph_rejected():
    eng = TrussEngine(max_edges=8, device="cpu")
    with pytest.raises(ValueError, match="too large.*max_edges=8"):
        eng.submit(_er(20, 0.5, 0))
    assert eng.stats["graphs_done"] == 0 and not eng._pending
    t = eng.submit(np.array([[0, 1], [0, 2], [1, 2]], np.int64))
    assert (eng.result(t) == 3).all()
    # the limit counts *canonical* edges: duplicate/swapped rows collapse
    assert TrussEngine(max_edges=1, device="cpu").submit(
        np.array([[0, 1], [1, 0]] * 6, np.int64)) >= 0
    for kwargs in (dict(max_edges=0), dict(chunk=0), dict(mode="pallas"),
                   dict(support_mode="jnp"), dict(table_mode="disk")):
        with pytest.raises(ValueError):
            TrussEngine(device="cpu", **kwargs)


def test_tickets_single_read_discard_and_auto_flush():
    eng = TrussEngine(max_pending=2, device="cpu")
    fleet = [_er(10, 0.4, s) for s in range(4)]
    ts = [eng.submit(e) for e in fleet]
    assert eng.stats["flushes"] == 2 and not eng._pending
    assert np.array_equal(eng.result(ts[0]), _oracle(fleet[0]))
    with pytest.raises(KeyError):
        eng.result(ts[0])                     # single read
    eng.discard(ts[1])                        # drops a materialized result
    with pytest.raises(KeyError):
        eng.result(ts[1])
    eng.discard(123456)                       # unknown: ignored
    t = TrussEngine(device="cpu").submit(np.zeros((0, 2), np.int64))
    assert t == 0
    with pytest.raises(ValueError, match="self-loops"):
        eng.submit(np.array([[0, 0]], np.int64))


def test_truss_batched_and_no_reorder():
    fleet = [_er(18, 0.3, 50), ring_of_cliques_edges(3, 4)]
    for reorder in (True, False):
        got = truss_batched(fleet, reorder=reorder, device="cpu")
        for g, e in zip(got, fleet):
            assert np.array_equal(g, _oracle(e))


def test_union_runs_respect_the_table_bound(monkeypatch):
    """A bucket whose union would overflow the int32 table layout is split
    into several unions; results are unchanged.  The kernel peel builds no
    peel table, so its unions are bounded by the support rows alone."""
    fleet = [_er(16, 0.3, s) for s in range(60, 64)]
    eng = TrussEngine(device="cpu")
    ts = eng.submit_many(fleet)
    ceiling = 128
    monkeypatch.setattr(te.support_mod, "_MAX_TABLE", ceiling)
    pending = list(eng._pending)
    counted = {"kernel": lambda r: sum(p.sup_size for p in r),
               "chunked": lambda r: max(sum(p.sup_size for p in r),
                                        sum(p.peel_size for p in r))}
    runs = {mode: TrussEngine._unions(pending, mode) for mode in counted}
    for mode, rows in counted.items():
        assert sum(len(r) for r in runs[mode]) == len(fleet)
        assert len(runs[mode]) > 1
        for r in runs[mode]:
            assert len(r) == 1 or te._next_pow2(rows(r)) <= ceiling
    assert len(runs["kernel"]) < len(runs["chunked"])
    eng.flush()
    for t, e in zip(ts, fleet):
        assert np.array_equal(eng.result(t), _oracle(e))
