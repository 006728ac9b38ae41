"""The ``graph500-s18.decompose`` cell: its generator, the readers of its
per-layer metrics, and its comparison, on the CPU at a small scale."""

import json
import pathlib
import types

import numpy as np
import pytest

from bench.gen import graph500
from bench.harness import spec
from bench.tests import small

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELL = "graph500-s18.decompose"
READERS = ("preprocess_s.decompose", "support_s.decompose",
           "peel_s.decompose", "compact_s.decompose")


def params(**kw):
    p = json.loads((BENCH / "configs" / "graph500-s18.json").read_text())[
        "params"]
    return dict(p, **kw)


def test_config_states_the_published_graph():
    p = params()
    assert (p["scale"], p["edge_factor"]) == (18, 16)
    assert (p["a"], p["b"], p["c"], p["d"]) == (0.57, 0.19, 0.19, 0.05)


@pytest.mark.parametrize("scale", [8, 11])
def test_graph_is_simple_canonical_and_made_from_the_seed(scale):
    a = graph500.make(params(scale=scale), 2**31 + 9)
    b = graph500.make(params(scale=scale), 2**31 + 9)
    c = graph500.make(params(scale=scale), 2**31 + 10)
    E, R = a["graphs"][0], a["rows"]
    assert np.array_equal(E, b["graphs"][0]) and np.array_equal(R, b["rows"])
    assert not np.array_equal(E, c["graphs"][0])
    n = 1 << scale
    assert E.dtype == np.int64
    assert (E[:, 0] < E[:, 1]).all() and E.min() >= 0 and E.max() < n
    keys = E[:, 0] * n + E[:, 1]
    assert (np.diff(keys) > 0).all()          # distinct, in key order
    # R lists the same edges in the same order, about half of them flipped
    assert np.array_equal(np.sort(R, axis=1), E)
    flipped = (R[:, 0] > R[:, 1]).mean()
    assert 0.4 < flipped < 0.6


@pytest.mark.parametrize("scale", [8, 12])
def test_edge_count_is_the_rows_less_loops_and_duplicates(scale):
    p = params(scale=scale)
    rows = graph500.kronecker_rows(scale, p["edge_factor"], p["a"], p["b"],
                                   p["c"], np.random.default_rng(3))
    assert rows.shape == (p["edge_factor"] << scale, 2)
    distinct = {(min(u, v), max(u, v)) for u, v in rows.tolist() if u != v}
    E = graph500.canonical(rows, 1 << scale)
    assert len(distinct) == E.shape[0]
    assert 0.5 < E.shape[0] / rows.shape[0] < 1.0


def test_the_initiator_skews_the_degrees():
    E = graph500.make(params(scale=12), 4)["graphs"][0]
    deg = np.bincount(E.reshape(-1))
    assert deg.max() > 20 * deg[deg > 0].mean()


def test_initiator_shares_must_add_up():
    with pytest.raises(ValueError, match="add up"):
        graph500.make(params(scale=6, d=0.1), 1)


def span(id_, name, start, end, parent=None, **attrs):
    return types.SimpleNamespace(id=id_, parent=parent, name=name,
                                 start_ns=start, end_ns=end,
                                 duration_ns=end - start, attrs=attrs)


def fake_run(spans):
    return types.SimpleNamespace(records={"program_spans": spans})


def test_readers_sum_inside_one_shot_calls_per_call():
    s = 1_000_000_000
    spans = [
        span(1, "pkt.one_shot", 0, 10 * s),
        span(2, "pkt.preprocess", 0, 6 * s, 1),
        span(3, "csr.build", 1 * s, 2 * s, 2),
        span(4, "pkt.support", 6 * s, 7 * s, 1),
        span(5, "pkt.loop", 7 * s, 8 * s, 1),
        span(6, "pkt.compact", 8 * s, 9 * s, 1),
        span(7, "pkt.loop", 9 * s, 10 * s, 1),
        span(8, "pkt.one_shot", 20 * s, 30 * s),
        span(9, "pkt.preprocess", 20 * s, 28 * s, 8),
        span(10, "pkt.support", 28 * s, 29 * s, 8),
        span(11, "pkt.loop", 29 * s, 30 * s, 8),
        # outside every one-shot call: the warm-up's, not counted
        span(12, "pkt.loop", 40 * s, 45 * s),
    ]
    run = fake_run(spans)
    got = {name: spec.metric_reader(name)(run) for name in READERS}
    assert got == pytest.approx({"preprocess_s.decompose": 7.0,
                                 "support_s.decompose": 1.0,
                                 "peel_s.decompose": 1.5,
                                 "compact_s.decompose": 0.5})


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_one_shot_spans(name):
    spans = [span(1, "pkt.preprocess", 0, 5), span(2, "pkt.loop", 5, 9)]
    assert spec.metric_reader(name)(fake_run(spans)) is None
    assert spec.metric_reader(name)(fake_run(None)) is None


def test_device_idle_of_the_cell_is_the_generic_reader():
    assert not (BENCH / "metrics" / "device_idle.decompose.py").exists()
    assert (spec.metric_reader("device_idle.decompose")
            is spec.metric_reader("device_idle.batch"))


def test_traced_run_reads_every_layer():
    r = small.run(CELL, traced=True)
    assert r["correct"] is True
    for name in READERS:
        # the small graph's m passes compaction's floor: it compacts too
        assert r["metrics"][name]["value"] > 0, name
    assert "device_idle.decompose" not in r["metrics"]    # no device here


def _plain_truss_pkt(pkt_mod):
    """``truss_pkt`` as a program without the one-shot spans has it."""
    def truss_pkt(edges, *, device="cuda", **kw):
        g, n, keys = pkt_mod.preprocess(edges)
        res = pkt_mod.pkt(g, device=device)
        return pkt_mod.align_to_input(res.trussness, g, None, n, keys=keys)
    return truss_pkt


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    import importlib
    pkt_mod = importlib.import_module("repro_torch.core.pkt")
    monkeypatch.setattr(pkt_mod, "truss_pkt", _plain_truss_pkt(pkt_mod))
    r = small.run(CELL, traced=True)
    assert r["correct"] is True
    assert not set(READERS) & set(r["metrics"])


@pytest.mark.parametrize("fault", ["off_by_one", "one_missing", "stale"])
def test_a_corrupted_answer_is_not_correct(monkeypatch, fault):
    import importlib
    pkt_mod = importlib.import_module("repro_torch.core.pkt")
    inner = pkt_mod.truss_pkt
    first = []

    def bad(edges, **kw):
        out = inner(edges, **kw)
        if fault == "off_by_one":
            out = out.copy()
            out[len(out) // 3] += 1
        elif fault == "one_missing":
            out = np.delete(out, len(out) // 3)
        else:
            # every call answers as the first did: the warm-up's graph
            if not first:
                first.append(out)
            out = first[0]
        return out
    monkeypatch.setattr(pkt_mod, "truss_pkt", bad)
    assert small.run(CELL, seconds=1.0)["correct"] is False


def test_a_program_that_refuses_the_graph_fails_at_once(monkeypatch):
    """A step that raises (a program whose guard refuses the graph) ends
    the run with its error after one step, before the window is out."""
    import importlib
    pkt_mod = importlib.import_module("repro_torch.core.pkt")
    inner = pkt_mod.truss_pkt
    calls = []

    def refuse(edges, **kw):
        calls.append(len(edges))
        if len(calls) > 1:          # the warm-up's graph passes
            raise ValueError("wedge table exceeds the int32 layout")
        return inner(edges, **kw)
    monkeypatch.setattr(pkt_mod, "truss_pkt", refuse)
    with pytest.raises(ValueError, match="int32"):
        small.run(CELL, seconds=30.0)
    assert len(calls) == 2
