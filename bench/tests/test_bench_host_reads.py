"""The reader of ``host_reads_per_sublevel`` on synthetic spans and on a
small traced CPU run."""

import types

import pytest

from bench.harness import spec
from bench.tests import small

NAME = "host_reads_per_sublevel.batch"


def _run(*attrs):
    spans = [types.SimpleNamespace(name="pkt.loop", start_ns=0, end_ns=1,
                                   duration_ns=1, attrs=dict(a))
             for a in attrs]
    spans.append(types.SimpleNamespace(name="engine.dispatch", start_ns=0,
                                       end_ns=1, duration_ns=1,
                                       attrs={"host_reads": 99,
                                              "sublevels": 1}))
    return types.SimpleNamespace(records={"program_spans": spans})


def test_reads_per_sublevel_over_the_loop_spans():
    run = _run({"sublevels": 40, "host_reads": 1},
               {"sublevels": 10, "host_reads": 1},
               {"sublevels": 30, "host_reads": 30})
    assert spec.metric_reader(NAME)(run) == pytest.approx(32 / 80)


def test_spans_without_the_attribute_read_nothing():
    # the parent's program: pkt.loop spans with no host_reads
    reader = spec.metric_reader(NAME)
    assert reader(_run({"sublevels": 40}, {"sublevels": 3})) is None
    assert reader(_run()) is None
    assert reader(_run({"sublevels": 0, "host_reads": 0})) is None
    assert reader(types.SimpleNamespace(
        records={"program_spans": None})) is None


def test_a_traced_cpu_run_reads_one_per_sublevel():
    # on the CPU the loop runs from the host: one read a sub-level
    r = small.run("collab.batch", traced=True)
    assert r["metrics"][NAME]["value"] == pytest.approx(1.0)
    assert r["correct"] is True
