"""Each cell's comparison fails when the timed path is broken underneath.

Every test drives a whole run of a small cell on the CPU (the harness's
look for a card skipped) with the program altered where its answers are
produced: one edge's trussness off by one, an edge missing, half of a
batch left out, a step that hands back the previous step's answers, and
the control in ``pkt``'s place.  ``correct`` must come out false each
time.
"""

import numpy as np
import pytest

from bench.tests import small


def off_by_one(t):
    t = np.array(t, copy=True)
    t[len(t) // 2] += 1
    return t


def one_missing(t):
    return np.delete(np.asarray(t), len(t) // 2)


FAULTS = {"off_by_one": off_by_one, "one_missing": one_missing}


@pytest.fixture
def pkt_mod():
    import importlib
    return importlib.import_module("repro_torch.core.pkt")


def _engine():
    from repro_torch.serve.truss_engine import TrussEngine
    return TrussEngine


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_batch_fails_on_a_wrong_answer(monkeypatch, fault):
    E = _engine()
    inner = E.map

    def bad(self, graphs):
        out = inner(self, graphs)
        out[0] = FAULTS[fault](out[0])
        return out
    monkeypatch.setattr(E, "map", bad)
    assert small.run("collab.batch")["correct"] is False


def test_batch_fails_when_half_of_a_slice_is_left_out(monkeypatch):
    E = _engine()
    inner = E.map

    def half(self, graphs):
        out = inner(self, graphs[: len(graphs) // 2])
        return out + out[: len(graphs) - len(out)]
    monkeypatch.setattr(E, "map", half)
    assert small.run("collab.batch")["correct"] is False


def test_batch_fails_when_a_step_returns_the_previous_answers(monkeypatch):
    """A step whose state never moves on: every ``map`` after the first
    hands back the first call's answers."""
    E = _engine()
    inner = E.map
    first = []

    def stale(self, graphs):
        out = inner(self, graphs)
        if not first:
            first.append(out)
        return (first[0] * len(graphs))[:len(graphs)]
    monkeypatch.setattr(E, "map", stale)
    assert small.run("collab.batch")["correct"] is False


@pytest.mark.parametrize("name", small.CELLS)
def test_the_control_in_the_program_s_place_fails(monkeypatch, pkt_mod,
                                                  name):
    """The control (sub-levels skipped) answers in place of ``pkt``."""
    from bench.tests import control
    inner = pkt_mod.pkt

    def approx(g, *a, **k):
        res = inner(g, *a, **k)
        t = control.decompose(g.El) if g.m else res.trussness
        return res.__class__(**{**res.__dict__,
                                "trussness": t.astype(np.int32)})
    monkeypatch.setattr(pkt_mod, "pkt", approx)
    import importlib
    engine = importlib.import_module("repro_torch.serve.truss_engine")
    if hasattr(engine, "pkt"):
        monkeypatch.setattr(engine, "pkt", approx)
    assert small.run(name, seconds=1.5)["correct"] is False
