"""The readers of the program's spans (``bench/harness/spans.py`` and the
four metrics that read it) on small traced CPU runs."""

import sys
import types

import numpy as np
import pytest

from bench.harness import spec, trace
from bench.tests import small

READERS = ("preprocess_s_per_graph.batch", "sublevels_per_graph.batch",
           "sublevel_us.batch", "idle_in_loop.batch")


@pytest.fixture(scope="module")
def traced():
    """One small traced run of ``collab.batch`` on the CPU."""
    return small.run("collab.batch", traced=True)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_positive_value_or_nothing(traced, name):
    m = traced["metrics"].get(name)
    if name.startswith("idle_in_loop"):
        # no device on the CPU: nothing to read, never 0
        assert m is None
    else:
        assert m is not None and m["value"] > 0
    assert traced["correct"] is True


def test_sublevels_per_graph_reads_the_dispatch_spans(traced):
    # a union's sub-levels serve all of its graphs: fewer than one graph's
    # worth each, but at least one sub-level a dispatch
    v = traced["metrics"]["sublevels_per_graph.batch"]["value"]
    assert 0 < v < 1000


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    # a program without repro_torch.trace: the import fails (the program's
    # own modules keep the recorder they imported)
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    r = small.run("collab.batch", traced=True)
    assert not set(READERS) & set(r["metrics"])
    assert "dispatch_s_per_graph.batch" in r["metrics"]


def test_untraced_runs_read_no_program_spans():
    r = small.run("collab.batch", traced=False)
    assert not set(READERS) & set(r["metrics"])


def _fake_run(union, loops, window_s):
    spans = [types.SimpleNamespace(name="pkt.loop", id=i + 1, parent=None,
                                   start_ns=s, end_ns=e, duration_ns=e - s,
                                   attrs={"sublevels": 1})
             for i, (s, e) in enumerate(loops)]
    busy = trace.busy_ns(union)
    return types.SimpleNamespace(
        trace={"union": union, "busy_s": busy / 1e9, "window_s": window_s},
        records={"program_spans": spans})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_in_loop_equals_busy_ns_per_span(seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(10_000, 400, replace=False))
    union = [(int(a), int(b)) for a, b in cuts.reshape(-1, 2)]
    ends = np.sort(rng.choice(10_000, 40, replace=False))
    loops = [(int(a), int(b)) for a, b in ends.reshape(-1, 2)]
    loops += [(0, 10_000), (int(cuts[0]), int(cuts[1])), (5, 5)]
    run = _fake_run(union, loops, 1e-5)
    want = sum(e - s - trace.busy_ns(union, s, e) for s, e in loops)
    got = spec.metric_reader("idle_in_loop.batch")(run)
    assert got == pytest.approx(100.0 * want / 1e4)
