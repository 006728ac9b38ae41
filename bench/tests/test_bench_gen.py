"""The COLLAB-like collection generator."""

import json
import pathlib

import numpy as np
import pytest

from bench.gen import collab

BENCH = pathlib.Path(__file__).resolve().parents[1]


def params(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "params"]


def test_collab_sizes_are_the_same_for_every_seed_and_match_the_source():
    p = params("collab")
    nv, me, cls = collab.sizes(p)
    assert nv.size == 5000 and nv.min() >= 32 and nv.max() <= 492
    assert abs(nv.mean() - 74.49) / 74.49 < 0.02
    assert abs(me.mean() - 2457.78) / 2457.78 < 0.02
    assert np.bincount(cls).tolist() == [2600, 775, 1625]


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_collab_collection_means_within_two_percent(seed):
    p = params("collab")
    data = collab.make(p, seed)
    graphs = data["graphs"]
    m = np.array([g.shape[0] for g in graphs])
    n = np.array([g.max() + 1 for g in graphs])
    assert len(graphs) == 5000
    assert abs(n.mean() - 74.49) / 74.49 < 0.02
    assert abs(m.mean() - 2457.78) / 2457.78 < 0.02
    for g in graphs[:200]:
        assert (g[:, 0] < g[:, 1]).all()
        assert np.unique(g[:, 0] * 1000 + g[:, 1]).size == g.shape[0]
        assert (g[:, 0] == 0).sum() == g.max()   # the ego meets everyone


def test_collab_is_made_from_the_seed():
    p = dict(params("collab"), graphs=50)
    a, b = collab.make(p, 11), collab.make(p, 11)
    c = collab.make(p, 12)
    assert all((x == y).all() for x, y in zip(a["graphs"], b["graphs"]))
    assert any(x.shape != y.shape or (x != y).any()
               for x, y in zip(a["graphs"], c["graphs"]))
