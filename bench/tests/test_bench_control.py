"""The control comes out as not correct: at the cells' own sizes on the
card, and at a small size on the CPU.

The control is the plain reference with its sub-levels left out
(``control.py``), put where the program's answers go.  Each test counts
the edges whose trussness the control gets wrong, against the exact limit
of 0 that the cells compare with, and prints the count.
"""

import json

import numpy as np
import pytest

from bench.harness import spec
from bench.reference import truss
from bench.tests import control, small

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def wrong(got, want) -> int:
    return int((np.asarray(got) != np.asarray(want)).sum())


def control_wrong(cell, seed, device, sample: int) -> int:
    """Edges the control gets wrong over the first ``sample`` graphs of
    the seed's collection."""
    graphs = spec.generator(cell.config).make(cell.config["params"],
                                              seed)["graphs"][:sample]
    got = control.decompose_many(graphs, device)
    want = truss.decompose_many(graphs, device)
    return sum(wrong(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", small.CELLS)
def test_control_fails_at_a_small_size(name):
    cell = small.cell(name)
    for seed in SEEDS:
        assert control_wrong(cell, seed, "cpu", sample=60) > 0


@pytest.mark.chip
@pytest.mark.parametrize("name", small.CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    cell = spec.load_cell(name)
    counts = [control_wrong(cell, seed, cuda, sample=1000)
              for seed in SEEDS]
    print(json.dumps({"control": name, "wrong_trussness": counts}))
    assert min(counts) > 0
