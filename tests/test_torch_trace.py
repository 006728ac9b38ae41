"""The port's spans and per-thread launch counts (``repro_torch.trace``,
``repro_torch.kernels.count_launches``) on the CPU.

Spans are recorded only after ``trace.enable()`` or while ``torch.profiler``
records; they nest by thread, sit on the profiler's clock, carry the loop
counts of ``pkt`` and the engine, and change no result.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.pkt import pkt
from repro_torch.graphs.csr import build_csr
from repro_torch.graphs.gen import ring_of_cliques_edges, rmat_edges
from repro_torch.kernels import count_launches
from repro_torch.serve import truss_engine as te
from repro_torch.serve.truss_engine import TrussEngine


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _graphs(k=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        e = ring_of_cliques_edges(2 + i % 3, 4 + i % 4, seed=i)
        out.append(e[rng.permutation(len(e))])
    return out


def _engine_run(graphs):
    eng = TrussEngine(device="cpu", max_pending=4)
    return eng.map(graphs), eng


def _under(how, fn):
    """``fn()`` with recording switched on as ``how`` says."""
    if how == "enable":
        trace.enable()
        try:
            return fn()
        finally:
            trace.disable()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            return fn()
    return fn()


@pytest.mark.parametrize("how", ["off", "enable", "profiler"])
def test_records_only_while_enabled_or_profiled(how):
    graphs = _graphs(5)
    _under(how, lambda: _engine_run(graphs))
    names = {sp.name for sp in trace.spans()}
    if how == "off":
        assert trace.spans() == [] and trace.dropped() == 0
        assert trace.span("x").__enter__() is None
        return
    assert {"engine.submit", "engine.flush", "engine.dispatch",
            "engine.union", "engine.align", "csr.canonical", "csr.order",
            "csr.relabel", "csr.build", "pkt.support", "pkt.peel_csr",
            "pkt.loop", "pkt.readback"} <= names
    subs = [sp for sp in trace.spans() if sp.name == "engine.submit"]
    assert sorted(sp.attrs["ticket"] for sp in subs) == list(range(5))
    assert all(sp.attrs["m"] > 0 for sp in subs)
    for sp in trace.spans():
        assert sp.end_ns >= sp.start_ns > 0
        assert sp.thread == threading.get_ident()


def test_phase_timings_leave_the_buffer_empty_while_off():
    g = build_csr(ring_of_cliques_edges(3, 5))
    res = pkt(g, phase_timings=True, compact_frac=0.99, compact_min=0,
              device="cpu")
    assert set(res.phases) == {"tables", "support", "peel", "compact"}
    assert trace.spans() == []


def test_parents_follow_nesting_and_auto_flush_is_a_child_of_submit():
    trace.enable()
    _engine_run(_graphs(6))
    by_id = {sp.id: sp for sp in trace.spans()}

    def ancestors(sp):
        while sp.parent is not None:
            sp = by_id[sp.parent]
            yield sp

    for sp in by_id.values():
        for a in ancestors(sp):
            assert a.start_ns <= sp.start_ns and sp.end_ns <= a.end_ns
    flushes = [sp for sp in by_id.values() if sp.name == "engine.flush"]
    # max_pending 4 of 6 graphs: one auto-flush inside the fourth submit,
    # then map's own flush at top level
    assert [by_id[f.parent].name if f.parent else None
            for f in flushes] == ["engine.submit", None]
    assert by_id[flushes[0].parent].attrs["ticket"] == 3
    for name, parent in [("engine.dispatch", "engine.flush"),
                         ("engine.union", "engine.dispatch"),
                         ("engine.align", "engine.dispatch"),
                         ("pkt.loop", "engine.dispatch"),
                         ("csr.canonical", "engine.submit")]:
        for sp in by_id.values():
            if sp.name == name:
                assert parent in {a.name for a in ancestors(sp)}, name


def test_span_bounds_hold_their_profiler_annotation():
    names = [f"t.span{i}" for i in range(6)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.warm"):
            pass
        for name in names:
            with trace.span(name):
                time.sleep(0.002)
    ann = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith(trace.PREFIX)}
    spans = {sp.name: sp for sp in trace.spans()}
    slack = 1_000_000
    for name in names:
        ev, sp = ann[trace.PREFIX + name], spans[name]
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert sp.start_ns - slack <= start <= end <= sp.end_ns + slack


@pytest.mark.parametrize("compact", [False, True])
def test_loop_spans_carry_the_sublevels(compact):
    g = build_csr(rmat_edges(7, 8, seed=3))
    kw = dict(compact_frac=0.99, compact_min=0) if compact else {}
    trace.enable()
    res = pkt(g, device="cpu", **kw)
    loops = [sp for sp in trace.spans() if sp.name == "pkt.loop"]
    assert len(loops) == res.compactions + 1
    assert sum(sp.attrs["sublevels"] for sp in loops) == res.sublevels
    assert sum(sp.attrs["levels"] for sp in loops) == res.levels
    assert all(sp.attrs["wait_ns"] >= 0 for sp in loops)
    assert (res.compactions > 0) == compact


@pytest.mark.parametrize("path", ["host", "device"])
def test_compact_spans_carry_their_path(path, monkeypatch):
    """Each ``pkt.compact`` span carries ``m`` (its survivors) and ``on``:
    "host" for the host rebuild, which the CPU takes, else the device's
    type (here the CPU, with ``prep.compacts_on_device`` patched).  The
    spans of a ``pkt`` keep their names and parents on either path; only
    the host rebuild's ``csr.build`` sits inside ``pkt.compact``."""
    from repro_torch.core import prep

    if path == "device":
        monkeypatch.setattr(prep, "compacts_on_device",
                            lambda rows, device: True)
    g = build_csr(rmat_edges(7, 8, seed=3))
    trace.enable()
    res = pkt(g, device="cpu", compact_frac=0.99, compact_min=0)
    spans = trace.spans()
    compacts = [sp for sp in spans if sp.name == "pkt.compact"]
    loops = [sp for sp in spans if sp.name == "pkt.loop"]
    assert len(compacts) == res.compactions > 0
    on = "host" if path == "host" else "cpu"
    for sp, nxt in zip(compacts, loops[1:]):
        assert sp.attrs == {"m": sp.attrs["m"], "on": on}
        assert sp.parent is None and nxt.start_ns >= sp.end_ns
    builds = [sp for sp in spans if sp.name == "csr.build"]
    assert len(builds) == (res.compactions if path == "host" else 0)
    inside = {sp.id for sp in compacts}
    assert all(sp.parent in inside for sp in builds)
    names = [sp.name for sp in spans if sp.name != "csr.build"]
    assert names == (["pkt.support", "pkt.peel_csr"]
                     + ["pkt.loop", "pkt.readback", "pkt.compact"]
                     * res.compactions + ["pkt.loop", "pkt.readback"])


def test_dispatch_spans_sum_their_pkt_calls(monkeypatch):
    calls = []
    inner = te.pkt

    def counted(g, **kw):
        res = inner(g, **kw)
        calls.append(res)
        return res

    monkeypatch.setattr(te, "pkt", counted)
    trace.enable()
    _engine_run(_graphs(9, seed=1))
    spans = trace.spans()
    by_id = {sp.id: sp for sp in spans}

    def under(sp, anc):
        while sp.parent is not None:
            sp = by_id[sp.parent]
            if sp is anc:
                return True
        return False

    dispatches = [sp for sp in spans if sp.name == "engine.dispatch"]
    assert sum(d.attrs["graphs"] for d in dispatches) == 9
    assert (sum(d.attrs["sublevels"] for d in dispatches)
            == sum(r.sublevels for r in calls))
    assert (sum(d.attrs["levels"] for d in dispatches)
            == sum(r.levels for r in calls))
    for d in dispatches:
        loops = [sp for sp in spans if sp.name == "pkt.loop" and under(sp, d)]
        assert d.attrs["sublevels"] == sum(sp.attrs["sublevels"]
                                           for sp in loops)
        unions = [sp for sp in spans
                  if sp.name == "engine.union" and under(sp, d)]
        # on the CPU every "kernel" call runs its plain version: K1 once a
        # union, the peel loop once a segment, K2 and the update every
        # sub-level, the dense update every level
        assert d.attrs["launches"]["plain"] == (
            len(unions) + len(loops) + 2 * d.attrs["sublevels"]
            + d.attrs["levels"])


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_results_are_bitwise_equal_with_recording_on(how):
    graphs = _graphs(7, seed=2)
    g = build_csr(rmat_edges(7, 8, seed=5))
    want_e, _ = _engine_run(graphs)
    want_p = pkt(g, device="cpu", compact_frac=0.99, compact_min=0)
    got_e, _ = _under(how, lambda: _engine_run(graphs))
    got_p = _under(how, lambda: pkt(g, device="cpu", compact_frac=0.99,
                                    compact_min=0))
    for a, b in zip(want_e, got_e):
        assert np.array_equal(a, b)
    for f in ("trussness", "support", "levels", "sublevels", "compactions"):
        assert np.array_equal(getattr(want_p, f), getattr(got_p, f)), f


@pytest.mark.parametrize("main_works", [False, True])
def test_count_launches_sees_only_its_own_thread(main_works):
    g_main = build_csr(ring_of_cliques_edges(3, 5))
    g_other = build_csr(rmat_edges(7, 8, seed=1))
    ready = threading.Barrier(2, timeout=60)
    seen = {}

    def other():
        with count_launches() as counted:
            ready.wait()
            seen["res"] = pkt(g_other, device="cpu")
            ready.wait()
        seen["counts"] = counted

    t = threading.Thread(target=other)
    t.start()
    with count_launches() as mine:
        ready.wait()
        res = pkt(g_main, device="cpu") if main_works else None
        ready.wait()
    t.join(timeout=60)
    assert not t.is_alive()

    def plain(r):
        if r is None:
            return 0
        return 1 + (r.compactions + 1) + 2 * r.sublevels + r.levels

    assert mine == {"support": 0, "peel": 0, "update": 0, "loop": 0,
                    "intersect": 0, "plain": plain(res)}
    assert seen["counts"]["plain"] == plain(seen["res"])


def test_buffer_bound_counts_dropped():
    rec = trace.Recorder(limit=3)
    for _ in range(5):
        with rec.span("x"):
            pass
    assert rec.spans() == [] and rec.dropped() == 0
    rec.enable()
    for i in range(5):
        with rec.span("x", i=i) as sp:
            assert sp.attrs == {"i": i}
    assert [sp.attrs["i"] for sp in rec.spans()] == [0, 1, 2]
    assert rec.dropped() == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped() == 0


def test_profiling_flag_follows_the_profiler():
    assert not trace.profiling()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.profiling()
        with trace.span("t.inside") as sp:
            assert sp is not None
    assert not trace.profiling()
    assert [sp.name for sp in trace.spans()] == ["t.inside"]


def test_device_preprocess_span_carries_its_path_and_sublevels(monkeypatch):
    """``prep.prepare`` on the device path (here the CPU, as ``on_device``
    would choose a card) is one ``pkt.preprocess`` span with the device's
    type, the k-core's sub-levels (as many as ``kcore.peel_cores`` runs)
    and its host reads (off the card, one a sub-level),
    ``preprocess_device``'s three steps inside."""
    from repro_torch.core import prep
    from repro_torch.core.kcore import peel_cores

    E = rmat_edges(8, 8, seed=4)
    g = build_csr(E)
    deg = torch.tensor(g.degrees)
    rows = torch.repeat_interleave(torch.arange(g.n, dtype=torch.int32),
                                   deg.to(torch.int64))
    _, subs = peel_cores(torch.tensor(g.N), rows, deg)
    monkeypatch.setattr(prep, "on_device", lambda rows, device: True)
    trace.enable()
    prep.prepare(E, device=torch.device("cpu"))
    spans = trace.spans()
    (pre,) = [sp for sp in spans if sp.name == "pkt.preprocess"]
    assert pre.parent is None
    assert pre.attrs == {"on": "cpu", "core_sublevels": subs,
                         "core_host_reads": subs}
    assert subs > 0
    steps = [sp for sp in spans if sp.parent == pre.id]
    assert [sp.name for sp in steps] == ["prep.canonical", "prep.order",
                                         "prep.build"]
    assert all(sp.attrs == {"m": len(E)} for sp in steps)


def test_one_shot_spans_nest_and_carry_their_counts():
    """``truss_pkt`` is one ``pkt.one_shot`` span holding ``pkt.preprocess``
    (the ``csr.*`` helpers inside it; on the CPU the host path, no device
    k-core), ``pkt``'s spans and ``pkt.align``; ``pkt.peel_csr`` carries the
    peel rows and the work list's size, each ``pkt.loop`` the fused launch's
    grid (0: the CPU's host loop)."""
    from repro_torch.core import support as support_mod
    from repro_torch.core.pkt import truss_pkt
    from repro_torch.core.prep import preprocess
    from repro_torch.kernels import peel as kpeel

    E = rmat_edges(8, 8, seed=4)
    rows = np.ascontiguousarray(E[::-1, ::-1])
    g, n, _ = preprocess(rows)
    trace.clear()
    trace.enable()
    truss_pkt(rows, device="cpu", compact_frac=0.99, compact_min=0)
    spans = trace.spans()
    by_id = {sp.id: sp for sp in spans}

    def ancestors(sp):
        while sp.parent is not None:
            sp = by_id[sp.parent]
            yield sp.name

    (shot,) = [sp for sp in spans if sp.name == "pkt.one_shot"]
    assert shot.parent is None
    assert shot.attrs == {"rows": len(rows), "n": n, "m": g.m}
    for name in ("pkt.preprocess", "pkt.align"):
        (sp,) = [sp for sp in spans if sp.name == name]
        assert sp.parent == shot.id
    (pre,) = [sp for sp in spans if sp.name == "pkt.preprocess"]
    assert pre.attrs == {"on": "host", "core_sublevels": 0,
                         "core_host_reads": 0}
    for sp in spans:
        if sp is not shot:
            assert "pkt.one_shot" in set(ancestors(sp)), sp.name
        if sp.name in ("csr.canonical", "csr.order", "csr.relabel"):
            assert "pkt.preprocess" in set(ancestors(sp))
        if sp.name == "csr.build":
            # the graph's build, or a compacted subproblem's
            assert {"pkt.preprocess", "pkt.compact"} & set(ancestors(sp))
    (csr,) = [sp for sp in spans if sp.name == "pkt.peel_csr"]
    rows_peel = support_mod.peel_table_size(g)
    assert csr.attrs == {"m": g.m, "peel_rows": rows_peel,
                         "work_cap": kpeel.work_capacity(g.m, rows_peel)}
    loops = [sp for sp in spans if sp.name == "pkt.loop"]
    assert len(loops) > 1
    assert all(sp.attrs["blocks"] == 0 for sp in loops)


#: the spans of a live handle's update (``core/truss_inc.py``)
INC_SPANS = {"inc.update", "inc.delete", "inc.search", "inc.region_peel",
             "inc.csr", "inc.rebuild"}


def _inc_spans(spans):
    return [sp for sp in spans if sp.name.startswith("inc.")]


@pytest.mark.parametrize("local_frac", [1.0, 0.0])
def test_update_spans_record_the_repair_s_steps(local_frac):
    """One ``klevel`` update that deletes and puts back edges of a ring of
    cliques: a local repair records exactly ``inc.update`` (with its
    counts), ``inc.csr``, ``inc.delete``, ``inc.search`` and
    ``inc.region_peel``; a forced fallback (``local_frac`` 0) records
    ``inc.update``, ``inc.csr``, ``inc.delete`` and ``inc.rebuild``; every
    one of them under the ``inc.update`` span.  Opening the handle is one
    ``inc.rebuild`` span."""
    from repro_torch.core.truss_inc import IncrementalTruss

    E = ring_of_cliques_edges(4, 5)
    trace.enable()
    inc = IncrementalTruss(E, insert_mode="klevel", local_frac=local_frac,
                           device="cpu")
    opened = _inc_spans(trace.spans())
    assert [sp.name for sp in opened] == ["inc.rebuild"]
    assert opened[0].attrs == {"m": len(E)}
    trace.clear()
    st = inc.update(add_edges=np.array([[0, 7], [1, 11]]),
                    remove_edges=E[:2])
    spans = _inc_spans(trace.spans())
    names = {sp.name for sp in spans}
    if local_frac:
        assert st.mode == "local"
        assert names == INC_SPANS - {"inc.rebuild"}
    else:
        assert st.mode == "full"
        assert names == {"inc.update", "inc.csr", "inc.delete",
                         "inc.rebuild"}
    (up,) = [sp for sp in spans if sp.name == "inc.update"]
    assert up.parent is None
    assert up.attrs == {"insert_mode": "klevel", "mode": st.mode,
                        "inserted": st.inserted, "deleted": st.deleted,
                        "affected": st.affected, "boundary": st.boundary,
                        "rounds": st.rounds}
    by_id = {sp.id: sp for sp in trace.spans()}
    for sp in spans:
        if sp is not up:
            p = sp
            while p.parent is not None:
                p = by_id[p.parent]
            assert p is up, sp.name
    for sp in spans:
        if sp.name == "inc.csr":
            assert sp.attrs == {"on": "host"}
        if sp.name == "inc.region_peel":
            assert sp.attrs["on"] == "host" and sp.attrs["edges"] >= 1
            assert "pinned" in sp.attrs
        if sp.name == "inc.search":
            assert sp.attrs["region"] >= 1 and sp.attrs["levels"] >= 0
    # ``affected`` also counts the deletions' descent
    peeled = sum(sp.attrs["edges"] for sp in spans
                 if sp.name == "inc.region_peel")
    assert (0 < peeled <= st.affected) if local_frac else peeled == 0
