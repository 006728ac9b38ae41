"""The ``graph500-s18.toggle`` cell: its driver, the readers of its
per-layer metrics, and its comparison, on the CPU at a small scale.

Importing this module registers the traffic mix's CPU sizes, which
``small.py`` does not list, so that the tests parametrised over every
cell (``small.CELLS``) run it too.
"""

import json
import pathlib
import types

import numpy as np
import pytest

from bench.harness import spec
from bench.tests import small

small.SMALL_TRAFFIC.setdefault("toggle", {"batch_edges": 8, "pools": 4})

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELL = "graph500-s18.toggle"
SPAN_READERS = ("inc_local_share.toggle", "inc_region_edges.toggle",
                "inc_search_s.toggle", "inc_peel_s.toggle",
                "inc_csr_s.toggle", "inc_rebuild_s.toggle")
#: the generic readers of the pkt loop's spans and of the device trace,
#: shared with ``collab.batch``: a region of 2^12 edges or more is re-peeled
#: through the loop on the card
LOOP_READERS = ("sublevel_us.toggle", "host_reads_per_sublevel.toggle",
                "idle_in_loop.toggle")
READERS = SPAN_READERS + LOOP_READERS + ("device_idle.toggle",)


def test_the_cell_and_its_metrics_are_declared():
    bench = spec.load_benchmark()
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("graph500-s18-live",
                                                       "toggle", 1)
    cell = spec.load_cell(CELL, bench)
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    assert {m["name"] for m in cell.end_to_end} == {"graphs_per_s",
                                                    "setup_s"}
    traffic = json.loads((BENCH / "traffic" / "toggle.json").read_text())
    assert traffic["params"] == {"batch_edges": 8, "pools": 4,
                                 "insert_mode": "klevel", "local_frac": 0.25}
    assert cell.config["reduced"] == [] and cell.config["params"]["scale"] \
        == 18


def test_the_live_deployment_runs_the_published_graph():
    """The live configuration is its own deployment (its own source, the
    update experiment) of the very graph that ``graph500-s18`` decomposes
    whole: same generator, reference and parameters."""
    bench = spec.load_benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    live, whole = configs["graph500-s18-live"], configs["graph500-s18"]
    assert live["source"] != whole["source"] and live["file"] != whole["file"]
    a, b = (json.loads((BENCH.parent / c["file"]).read_text())
            for c in (live, whole))
    for key in ("generator", "reference", "params", "reduced"):
        assert a[key] == b[key], key
    assert a["source"] == live["source"]


def test_a_small_run_is_correct():
    r = small.run(CELL, seconds=2.0)
    assert r["correct"] is True, r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["compared"]["answers_checked"]["value"] == r["attempted"]
    assert set(r["metrics"]) == {"graphs_per_s", "setup_s"}


def test_a_traced_run_reads_every_layer():
    r = small.run(CELL, seconds=2.0, traced=True)
    assert r["correct"] is True
    for name in SPAN_READERS:
        assert r["metrics"][name]["value"] >= 0, name
    assert 0 <= r["metrics"]["inc_local_share.toggle"]["value"] <= 100
    assert r["metrics"]["inc_region_edges.toggle"]["value"] > 0
    assert r["metrics"]["inc_csr_s.toggle"]["value"] > 0
    # no device on the CPU: the device reader reads nothing, never 0
    assert "device_idle.toggle" not in r["metrics"]


def test_an_answer_from_the_step_before_is_not_correct(monkeypatch):
    """Each read of the trussness answers as the read before did: every
    answer belongs to the state before its step."""
    from repro_torch.serve.truss_engine import TrussHandle
    inner = TrussHandle.trussness.fget
    last = []

    def stale(self):
        now = inner(self)
        out = last[-1] if last else now
        last.append(now)
        return out
    monkeypatch.setattr(TrussHandle, "trussness", property(stale))
    assert small.run(CELL, seconds=1.0)["correct"] is False


def test_a_step_that_raises_ends_the_window(monkeypatch):
    from repro_torch.serve.truss_engine import TrussEngine
    inner = TrussEngine.update
    calls = []

    def flaky(self, *a, **k):
        calls.append(1)
        if len(calls) == 4:         # the warm-up's two, then two steps
            raise RuntimeError("injected")
        return inner(self, *a, **k)
    monkeypatch.setattr(TrussEngine, "update", flaky)
    r = small.run(CELL, seconds=30.0)
    assert r["correct"] is False and r["failed"] == 1
    assert r["attempted"] == 2 and len(calls) == 4
    assert r["compared"]["unanswered"]["value"] == 1


def span(id_, name, start, end, parent=None, **attrs):
    return types.SimpleNamespace(id=id_, parent=parent, name=name,
                                 start_ns=start, end_ns=end,
                                 duration_ns=end - start, attrs=attrs)


def fake_run(spans):
    return types.SimpleNamespace(records={"program_spans": spans})


def test_readers_sum_inside_updates_per_update():
    s = 1_000_000_000
    spans = [
        span(1, "inc.update", 0, 10 * s, mode="local", affected=30),
        span(2, "inc.csr", 0, 1 * s, 1),
        span(3, "inc.delete", 1 * s, 4 * s, 1),
        span(4, "inc.csr", 1 * s, 2 * s, 3),
        span(5, "inc.update", 20 * s, 30 * s, mode="full", affected=10),
        span(6, "inc.search", 20 * s, 22 * s, 5),
        span(7, "inc.region_peel", 22 * s, 23 * s, 5),
        span(8, "inc.rebuild", 23 * s, 29 * s, 5),
        # outside every update: the open's rebuild, not counted
        span(9, "inc.rebuild", 40 * s, 45 * s),
    ]
    run = fake_run(spans)
    got = {name: spec.metric_reader(name)(run) for name in SPAN_READERS}
    assert got == pytest.approx({"inc_local_share.toggle": 50.0,
                                 "inc_region_edges.toggle": 20.0,
                                 "inc_search_s.toggle": 1.0,
                                 "inc_peel_s.toggle": 0.5,
                                 "inc_csr_s.toggle": 1.0,
                                 "inc_rebuild_s.toggle": 3.0})


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_read_nothing_without_update_spans(name):
    spans = [span(1, "inc.search", 0, 5), span(2, "inc.rebuild", 5, 9)]
    assert spec.metric_reader(name)(fake_run(spans)) is None
    assert spec.metric_reader(name)(fake_run(None)) is None


@pytest.mark.parametrize("name", ("device_idle.toggle",) + LOOP_READERS)
def test_device_idle_of_the_cell_is_the_generic_reader(name):
    assert not (BENCH / "metrics" / f"{name}.py").exists()
    assert (spec.metric_reader(name)
            is spec.metric_reader(name.replace(".toggle", ".batch")))


def test_loop_readers_read_the_region_peels_loops():
    """A window of updates whose region peels ran the pkt loop: the
    loop's readers read its spans, and nothing where no loop ran."""
    spans = [
        span(1, "inc.update", 0, 10_000),
        span(2, "inc.region_peel", 1_000, 9_000, 1),
        span(3, "pkt.loop", 2_000, 6_000, 2, sublevels=4, host_reads=1),
        span(4, "pkt.loop", 6_000, 8_000, 2, sublevels=4, host_reads=1),
    ]
    assert spec.metric_reader("sublevel_us.toggle")(fake_run(spans)) \
        == pytest.approx(0.75)
    assert spec.metric_reader("host_reads_per_sublevel.toggle")(
        fake_run(spans)) == pytest.approx(0.25)
    for name in LOOP_READERS[:2]:
        assert spec.metric_reader(name)(fake_run(spans[:2])) is None


def test_answers_keep_as_uint8_and_share_equal_bytes():
    drv = spec.driver(spec.load_cell(CELL).traffic)
    state = types.SimpleNamespace(kept={}, returned=[])
    a = np.array([2, 3, 165], np.int64)
    drv._keep(state, 1, a)
    drv._keep(state, 0, a + 1)
    drv._keep(state, 1, a.copy())
    drv._keep(state, 1, None)
    (k0, t0), (_, t1), (k2, t2), (_, t3) = state.returned
    assert t0.dtype == np.uint8 and t2 is t0 and (k0, k2) == (1, 1)
    assert t1.tolist() == [3, 4, 166] and t3 is None
    with pytest.raises(ValueError, match="uint8"):
        drv._keep(state, 0, np.array([256]))
