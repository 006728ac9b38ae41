"""The fused peel loop on the card: one launch of ``peel_loop_kernel`` per
peel segment against the host loop over the three standalone kernels.

Every test here needs an NVIDIA card (marker ``card``) and skips without
one; the file imports nothing of the JAX package, so it runs on a machine
that has only the port.  On the card::

    python -m pytest -q -m card tests/test_torch_card.py

Both loops start from the same state (initial support on the card, slot
``m`` processed) and must agree bitwise on ``S_ext``, ``processed``,
``levels`` and ``sublevels``; the decompositions must equal the port's
plain versions on the CPU and the host oracle.  The k-core's one launch
(``kcore_kernel``) is held the same way against ``peel_cores``, the torch
loop, on the card, and against the host's ``kcore_numpy``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import prep
from repro_torch.core import support as support_mod
from repro_torch.core.kcore import kcore_numpy, peel_cores
from repro_torch.core.ref import truss_numpy
from repro_torch.graphs.csr import build_csr
from repro_torch.graphs.gen import barabasi_albert_edges, rmat_edges
from repro_torch.kernels import count_launches, cuda_build
from repro_torch.kernels import kcore as kkcore
from repro_torch.kernels import peel as kpeel
from repro_torch.serve.truss_engine import TrussEngine

# ``repro_torch.core`` re-exports the ``pkt`` function, which shadows the
# module
pkt_mod = importlib.import_module("repro_torch.core.pkt")

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def ego_net(n, papers, seed):
    """An ego (vertex 0) and ``n - 1`` co-authors as a union of paper
    cliques, the ego on every paper: deep, near-clique, like COLLAB's."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(papers):
        k = int(rng.integers(2, min(n, 12)))
        members = np.concatenate(
            [[0], rng.choice(np.arange(1, n), size=k - 1, replace=False)])
        a, b = np.triu_indices(k, 1)
        rows.append(np.stack([members[a], members[b]], axis=1))
    E = np.unique(np.sort(np.concatenate(rows), axis=1), axis=0)
    return E.astype(np.int64)


GRAPHS = {
    "er": lambda: _er(60, 0.3, 7),
    "rmat10": lambda: rmat_edges(10, edge_factor=16, seed=1),
    "rmat14": lambda: rmat_edges(14, edge_factor=16, seed=2),
    "ba": lambda: barabasi_albert_edges(2000, 6, seed=3),
    "ego": lambda: ego_net(120, 60, seed=4),
}


def _state(g, dev):
    """The peel's start on ``dev``: (S_ext, processed, csr, N, Eid)."""
    S0 = support_mod._support_device(g, mode="kernel", chunk=None,
                                     device=dev).to(torch.int32)
    S_ext = torch.cat([S0, torch.full((1,), kpeel.SENTINEL_S,
                                      dtype=torch.int32, device=dev)])
    processed = torch.zeros(g.m + 1, dtype=torch.bool, device=dev)
    processed[g.m] = True
    arrays = g.device_arrays(dev)
    return (S_ext, processed, pkt_mod.prepare_peel_csr(g, device=dev),
            arrays["N"], arrays["Eid"])


def _run(loop, st, m, pinned=None, stop_live=0):
    S_ext, processed, csr, N, Eid = st
    S, P = S_ext.clone(), processed.clone()
    res = loop(S, P, csr.u, csr.v, csr.Es, N, Eid, pinned, m=m,
               work_cap=csr.work_cap, stop_live=stop_live)
    return S, P, res


def _assert_same(a, b):
    S1, P1, r1 = a
    S2, P2, r2 = b
    assert torch.equal(S1, S2)
    assert torch.equal(P1, P2)
    assert (r1.levels, r1.sublevels) == (r2.levels, r2.sublevels)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fused_loop_equals_host_loop(card, name, pinned):
    g = build_csr(GRAPHS[name]())
    m = g.m
    st = _state(g, card)
    pin = None
    if pinned:
        rng = np.random.default_rng(len(name))
        pin = torch.tensor(np.append(rng.random(m) < 0.25, False),
                           device=card)
    with count_launches() as counted:
        fused = _run(kpeel.peel_loop, st, m, pin)
    host = _run(kpeel.host_loop, st, m, pin)
    _assert_same(fused, host)
    assert fused[2].host_reads == 1 and fused[2].wait_ns >= 0
    assert host[2].host_reads == host[2].sublevels
    assert counted["loop"] == 1
    assert counted["peel"] == counted["update"] == counted["plain"] == 0
    # the plain version on the CPU agrees too
    S_ext, processed, csr, N, Eid = st
    cpu = (S_ext.cpu(), processed.cpu(),
           pkt_mod.PeelCSR(csr.u.cpu(), csr.v.cpu(), csr.Es.cpu(),
                           csr.work_cap), N.cpu(), Eid.cpu())
    plain = _run(kpeel.peel_loop, cpu, m, None if pin is None else pin.cpu())
    _assert_same((fused[0].cpu(), fused[1].cpu(), fused[2]), plain)


@pytest.mark.parametrize("name", ["rmat14", "ego", "ba"])
def test_segments_end_at_the_host_loops_level_boundary(card, name):
    """Several ``stop_live`` values: each segment stops where the host loop
    does, and a second segment from there finishes the peel alike."""
    g = build_csr(GRAPHS[name]())
    m = g.m
    st = _state(g, card)
    for frac in (0.9, 0.5, 0.25, 0.05):
        stop = int(frac * m)
        fused = _run(kpeel.peel_loop, st, m, stop_live=stop)
        host = _run(kpeel.host_loop, st, m, stop_live=stop)
        _assert_same(fused, host)
        live = (m + 1) - int(fused[1].sum())
        assert live <= stop or fused[2].levels == 0
        rest = (fused[0], fused[1]) + st[2:]
        _assert_same(_run(kpeel.peel_loop, rest, m),
                     _run(kpeel.host_loop, rest, m))


def test_empty_edge_space(card):
    S = torch.full((1,), kpeel.SENTINEL_S, dtype=torch.int32, device=card)
    P = torch.ones(1, dtype=torch.bool, device=card)
    z = torch.zeros(1, dtype=torch.int32, device=card)
    e = torch.zeros(0, dtype=torch.int32, device=card)
    res = kpeel.peel_loop(S, P, e, e, z, e, e, m=0, work_cap=1)
    assert (res.levels, res.sublevels, res.host_reads) == (0, 0, 1)
    assert pkt_mod.pkt(build_csr(np.zeros((0, 2), np.int64)),
                       device=card).sublevels == 0


def test_a_loop_past_its_cap_raises(card):
    """Slot ``m`` left live never joins a frontier: each level's sub-level
    retires nothing, and the launch stops at its cap instead of hanging."""
    g = build_csr(GRAPHS["er"]())
    S_ext, processed, csr, N, Eid = _state(g, card)
    processed[g.m] = False
    with pytest.raises(cuda_build.KernelError, match="sub-levels"):
        kpeel.peel_loop(S_ext, processed, csr.u, csr.v, csr.Es, N, Eid,
                        m=g.m, work_cap=csr.work_cap)


def _id_gaps():
    """Two R-MAT graphs with 5,000 ids between them that hold no edge."""
    a = rmat_edges(10, edge_factor=16, seed=8)
    b = rmat_edges(10, edge_factor=16, seed=9)
    return np.concatenate([a, b + a.max() + 5001])


def _star(leaves):
    return np.stack([np.zeros(leaves, np.int64),
                     np.arange(1, leaves + 1, dtype=np.int64)], axis=1)


def _clique(k):
    a, b = np.triu_indices(k, 1)
    return np.stack([a, b], axis=1).astype(np.int64)


def _path(k):
    return np.stack([np.arange(k - 1), np.arange(1, k)],
                    axis=1).astype(np.int64)


CORE_GRAPHS = {
    "rmat16": lambda: rmat_edges(16, edge_factor=16, seed=7),
    "gaps": _id_gaps,
    "clique": lambda: _clique(600),
    "star": lambda: _star(100_000),
    "path": lambda: _path(5_000),
    "small": lambda: _er(60, 0.3, 7),
}


def _torch_loop(arrays):
    """``peel_cores`` over the CSR's slots on their device."""
    deg = arrays["Es"][1:] - arrays["Es"][:-1]
    rows = torch.repeat_interleave(
        torch.arange(deg.shape[0], dtype=torch.int32, device=deg.device),
        deg.to(torch.int64), output_size=arrays["N"].shape[0])
    return peel_cores(arrays["N"], rows, deg)


@pytest.mark.parametrize("name", sorted(CORE_GRAPHS))
def test_core_loop_equals_the_torch_loop(card, name):
    """One launch of ``kcore_kernel`` gives ``peel_cores``' coreness and
    sub-levels on the card and BZ's coreness on the host: a scale-16 R-MAT
    graph with hubs, ids that hold no edge in the middle, a clique, a star
    of 10^5 slots (one row over many warps), a path (thousands of
    sub-levels) and a graph under 256 vertices (a one-block grid)."""
    g = build_csr(CORE_GRAPHS[name]())
    arrays = g.device_arrays(card)
    before = kkcore.COUNTS.mine()["kernel"]
    got = kkcore.core_loop(arrays["Es"], arrays["N"])
    assert kkcore.COUNTS.mine()["kernel"] == before + 1
    torch.cuda.synchronize()
    want, subs = _torch_loop(arrays)
    assert got.core.dtype == torch.int32 and torch.equal(got.core, want)
    assert got.sublevels == subs
    assert np.array_equal(got.core.cpu().numpy(), kcore_numpy(g))
    assert got.host_reads == 1
    assert 1 <= got.blocks <= -(-g.n // 256)
    if g.n < 256:
        assert got.blocks == 1


def test_a_core_loop_past_its_cap_raises(card):
    """A multigraph row (two vertices, ten slots each way) peels only at
    level 10, past the 2n sub-levels a simple graph can take: the kernel
    stops and the wrapper raises."""
    Es = torch.tensor([0, 10, 20], dtype=torch.int32, device=card)
    N = torch.tensor([1] * 10 + [0] * 10, dtype=torch.int32, device=card)
    with pytest.raises(cuda_build.KernelError, match="sub-levels"):
        kkcore.core_loop(Es, N)


@pytest.mark.parametrize("compaction", [None, 0.5])
def test_pkt_launches_one_loop_per_segment(card, compaction):
    g = build_csr(GRAPHS["rmat14"]())
    kw = (dict(compact_frac=None) if compaction is None
          else dict(compact_frac=compaction, compact_min=0))
    with count_launches() as counted:
        res = pkt_mod.pkt(g, device=card, **kw)
    want = pkt_mod.pkt(g, device="cpu", **kw)
    assert np.array_equal(res.trussness, want.trussness)
    assert (res.levels, res.sublevels, res.compactions) == \
        (want.levels, want.sublevels, want.compactions)
    assert (compaction is not None) == (res.compactions > 0)
    assert counted == {"support": 1, "peel": 0, "update": 0,
                       "loop": res.compactions + 1, "intersect": 0,
                       "plain": 0}


def test_region_peel_with_pinned_edges(card):
    g = build_csr(GRAPHS["rmat10"]())
    S0 = pkt_mod.pkt(g, device=card).support
    rng = np.random.default_rng(8)
    live = np.sort(rng.choice(g.m, size=2 * g.m // 3, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    for kw in (dict(compact_frac=None),
               dict(compact_frac=0.99, compact_min=0)):
        got = pkt_mod.peel_live_subset(g.El, live, S0[live], pinned,
                                       device=card, **kw)
        want = pkt_mod.peel_live_subset(g.El, live, S0[live], pinned,
                                        device="cpu", **kw)
        assert np.array_equal(got, want)


def test_compactions_built_on_the_card(card):
    """A scale-14 R-MAT graph compacted at half its live edges until fewer
    than 2^15 stay live: its three compactions keep 2^14 survivors or
    more, above ``DEVICE_COMPACT_MIN_ROWS``, so each is built on the card
    (``pkt.compact`` ``on="cuda"``), and ``pkt`` equals the CPU run
    bitwise, one fused loop a segment and nothing run plain.  A region
    peel of two thirds of its edges, a quarter of them pinned, equals the
    CPU run too; its compactions are built on the card from
    ``DEVICE_COMPACT_MIN_ROWS`` survivors and on the host below."""
    g = build_csr(GRAPHS["rmat14"]())
    kw = dict(compact_frac=0.5, compact_min=1 << 15)
    rng = np.random.default_rng(9)
    live = np.sort(rng.choice(g.m, size=2 * g.m // 3, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    trace.enable()
    try:
        with count_launches() as counted:
            got = pkt_mod.pkt(g, device=card, **kw)
        whole = [sp for sp in trace.spans() if sp.name == "pkt.compact"]
        trace.clear()
        region = pkt_mod.peel_live_subset(g.El, live, got.support[live],
                                          pinned, device=card, **kw)
        subset = [sp for sp in trace.spans() if sp.name == "pkt.compact"]
    finally:
        trace.disable()
        trace.clear()
    want = pkt_mod.pkt(g, device="cpu", **kw)
    assert np.array_equal(got.trussness, want.trussness)
    assert np.array_equal(got.support, want.support)
    assert (got.levels, got.sublevels, got.compactions) == \
        (want.levels, want.sublevels, want.compactions)
    assert len(whole) == got.compactions >= 3
    assert all(sp.attrs["m"] >= prep.DEVICE_COMPACT_MIN_ROWS for sp in whole)
    assert [sp.attrs["on"] for sp in whole] == ["cuda"] * len(whole)
    assert counted["loop"] == got.compactions + 1
    assert counted["plain"] == counted["peel"] == counted["update"] == 0
    assert np.array_equal(region, pkt_mod.peel_live_subset(
        g.El, live, got.support[live], pinned, device="cpu", **kw))
    assert subset and subset[0].attrs["on"] == "cuda"
    for sp in subset:
        big = sp.attrs["m"] >= prep.DEVICE_COMPACT_MIN_ROWS
        assert sp.attrs["on"] == ("cuda" if big else "host")


def test_engine_batch_of_ego_nets(card):
    """A batch of COLLAB-like ego nets through the engine on the card:
    every result equals the plain engine on the CPU and the host oracle,
    and no dispatch launched K2 or an update on its own."""
    graphs = [ego_net(int(n), int(n) // 2, seed=100 + i) for i, n in
              enumerate(np.random.default_rng(5).integers(20, 90, 48))]
    eng = TrussEngine(max_pending=len(graphs) + 1, device=card)
    got = eng.map(graphs)
    want = TrussEngine(max_pending=len(graphs) + 1, device="cpu").map(graphs)
    for E, a, b in zip(graphs, got, want):
        assert np.array_equal(a, b)
        assert np.array_equal(a, truss_numpy(E))
    for counts in eng.stats["bucket_launches"].values():
        assert counts["loop"] >= 1 and counts["support"] >= 1
        assert counts["peel"] == counts["update"] == counts["plain"] == 0


def test_loop_spans_carry_the_fused_grid(card):
    """Each ``pkt.loop`` span's ``blocks`` is the fused launch's grid: the
    resident blocks, or one block per 256 slots where that is fewer."""
    g = build_csr(GRAPHS["rmat14"]())
    trace.enable()
    try:
        pkt_mod.pkt(g, device=card, compact_frac=0.5, compact_min=0)
        loops = [sp for sp in trace.spans() if sp.name == "pkt.loop"]
    finally:
        trace.disable()
        trace.clear()
    resident = kpeel.resident_grids()["loop"]
    assert len(loops) > 1
    for sp in loops:
        wanted = (sp.attrs["m"] + 256) // 256       # ceil((m + 1) / 256)
        assert sp.attrs["blocks"] == min(resident, wanted)


def _plain_reference():
    """The benchmark's plain reference (``bench/reference/truss.py``),
    loaded by path: it imports nothing of the port."""
    name = "bench_reference_truss"
    if name not in sys.modules:
        path = (pathlib.Path(__file__).resolve().parents[1] / "bench"
                / "reference" / "truss.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.mark.parametrize("seed,peel_rows", [(1001, 1_074_459_056),
                                            (11, 1_074_027_026)])
def test_scale18_graphs_past_the_peel_table_ceiling(card, seed, peel_rows):
    """Graph500 scale-18 graphs whose peel table would pad past 2^31 - 1
    rows, which the table executors and the JAX package refuse: the kernel
    path decomposes them through ``truss_pkt`` and ``TrussEngine.submit``,
    equal to the plain reference, the fused loop's grid at its cap."""
    E = rmat_edges(18, edge_factor=16, seed=seed)
    g, _, _ = prep.preprocess(E)
    sup_rows = support_mod.support_table_size(g)
    assert support_mod.peel_table_size(g) == peel_rows
    assert 1 << (peel_rows - 1).bit_length() > support_mod._MAX_TABLE
    assert 1 << (sup_rows - 1).bit_length() <= support_mod._MAX_TABLE
    trace.enable()
    try:
        got = pkt_mod.truss_pkt(E, device=card)
        loops = [sp for sp in trace.spans() if sp.name == "pkt.loop"]
    finally:
        trace.disable()
        trace.clear()
    eng = TrussEngine(device=card)
    via_engine = eng.result(eng.submit(E))
    want = _plain_reference().decompose(E, card)
    assert np.array_equal(got, want.trussness)
    assert np.array_equal(via_engine, want.trussness)
    assert loops[0].attrs["blocks"] == kpeel.resident_grids()["loop"]
    assert loops[0].attrs["blocks"] < (g.m + 256) // 256
    print(json.dumps({"seed": seed, "m": g.m, "peel_rows": peel_rows,
                      "support_rows": sup_rows,
                      "triangles": want.triangles,
                      "max_trussness": int(want.trussness.max()),
                      "segments": [[sp.attrs["m"], sp.attrs["blocks"]]
                                   for sp in loops]}))


def test_truss_pkt_preprocesses_on_the_card_from_its_threshold(card):
    """From ``DEVICE_PREP_MIN_ROWS`` rows on, ``truss_pkt`` on the card
    builds the graph and aligns the answer there: a seeded scale-16 R-MAT
    graph, its rows shuffled and flipped, gives the host path's graph and
    answer and the plain reference's trussness; the ``pkt.preprocess`` span
    says ``on="cuda"`` with the device k-core's sub-levels.  The first
    ``DEVICE_PREP_MIN_ROWS`` of those rows take the card's path too, and a
    graph below the threshold takes the host path (``on="host"``); both
    answer as the plain reference."""
    E = rmat_edges(16, edge_factor=16, seed=5)
    small = rmat_edges(10, edge_factor=16, seed=5)
    assert len(small) < prep.DEVICE_PREP_MIN_ROWS <= len(E)
    rng = np.random.default_rng(6)
    order = rng.permutation(len(E))
    flip = rng.random(len(E)) < 0.5
    rows = np.where(flip[:, None], E[order][:, ::-1], E[order])
    trace.enable()
    try:
        got = pkt_mod.truss_pkt(rows, device=card)
        got_edge = pkt_mod.truss_pkt(rows[:prep.DEVICE_PREP_MIN_ROWS],
                                     device=card)
        got_small = pkt_mod.truss_pkt(small, device=card)
        pre = [sp for sp in trace.spans() if sp.name == "pkt.preprocess"]
    finally:
        trace.disable()
        trace.clear()
    g, n, keys = prep.preprocess(rows)
    g2, n2, keys2 = prep.preprocess_device(rows, device=card)
    assert (g2.n, g2.m, n2) == (g.n, g.m, n)
    for f in ("Es", "N", "Eid", "El", "Eo"):
        a, b = getattr(g, f), getattr(g2, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(keys2.cpu().numpy(), keys)
    host = pkt_mod.align_to_input(pkt_mod.pkt(g, device=card).trussness, g,
                                  None, n, keys=keys)
    ref = _plain_reference()
    assert np.array_equal(got, host)
    assert np.array_equal(got, ref.decompose(E, card).trussness[order])
    edge = E[order[:prep.DEVICE_PREP_MIN_ROWS]]
    assert np.array_equal(got_edge, ref.decompose(edge, card).trussness)
    assert np.array_equal(got_small, ref.decompose(small, card).trussness)
    assert [sp.attrs["on"] for sp in pre] == ["cuda", "cuda", "host"]
    assert pre[0].attrs["core_sublevels"] > 0
    assert pre[1].attrs["core_sublevels"] > 0
    assert pre[2].attrs["core_sublevels"] == 0
    # the card's k-core: one launch and one read, the torch loop's
    # sub-levels over the same graph
    assert [sp.attrs["core_host_reads"] for sp in pre] == [1, 1, 0]
    g0 = build_csr(E)
    assert pre[0].attrs["core_sublevels"] == \
        _torch_loop(g0.device_arrays(card))[1]


def test_klevel_handle_toggles_equal_the_cpu(card):
    """A live scale-14 R-MAT handle under ``insert_mode="klevel"`` on the
    card, against the same handle on the CPU, over a toggle script (four
    pools of 8 edges, each deleted and put back): after every batch the
    mode, the counts, the edges, the trussness, the support and the
    triangle rows (order included) are equal, and the trussness equals a
    from-scratch ``truss_pkt``.  On the card the open preprocesses there,
    and each batch's key algebra and CSR builds run there (``inc.csr``
    ``on="cuda"``); both re-peel the same regions on the same rungs."""
    from repro_torch.core.truss_inc import IncrementalTruss

    E = GRAPHS["rmat14"]()
    rng = np.random.default_rng(14)
    pools = E[rng.choice(len(E), 32, replace=False)].reshape(4, 8, 2)
    trace.enable()
    try:
        gpu = IncrementalTruss(E, insert_mode="klevel", device=card)
        opened = trace.spans()
        trace.clear()
        cpu = IncrementalTruss(E, insert_mode="klevel", device="cpu")
        for pool in pools:
            for batch in (dict(remove_edges=pool), dict(add_edges=pool)):
                trace.clear()
                s1 = gpu.update(**batch)
                spans = trace.spans()
                s2 = cpu.update(**batch)
                for f in ("mode", "m_after", "inserted", "deleted",
                          "affected", "boundary", "rounds", "changed"):
                    assert getattr(s1, f) == getattr(s2, f), f
                for f in ("edges", "trussness", "support", "triangles"):
                    assert np.array_equal(getattr(gpu, f), getattr(cpu, f))
                assert np.array_equal(gpu.trussness,
                                      pkt_mod.truss_pkt(gpu.edges,
                                                        device=card))
                csr = [sp for sp in spans if sp.name == "inc.csr"]
                assert csr and all(sp.attrs["on"] == "cuda" for sp in csr)
    finally:
        trace.disable()
        trace.clear()
    pre = [sp for sp in opened if sp.name == "pkt.preprocess"]
    assert [sp.attrs["on"] for sp in pre] == ["cuda"]
    assert [sp.name for sp in opened if sp.name.startswith("inc.")] == \
        ["inc.rebuild"]
    assert gpu.region_peels == cpu.region_peels
