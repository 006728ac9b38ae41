"""The plain reference against a brute-force truss and the port.

The R-MAT graphs come from the port's own generator: the tests may read
the program, the reference may not."""

import itertools

import numpy as np
import pytest

from bench.reference import truss
from repro_torch.graphs.gen import rmat_edges


def brute_truss(edges: np.ndarray) -> np.ndarray:
    """Trussness by definition: the largest k whose k-truss (edges left
    after repeatedly removing those in fewer than k - 2 triangles) still
    holds the edge."""
    E = [tuple(map(int, e)) for e in edges]
    out = {e: 2 for e in E}
    k = 3
    live = set(E)
    while live:
        changed = True
        while changed:
            adj = {}
            for a, b in live:
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set()).add(a)
            drop = {e for e in live
                    if len(adj[e[0]] & adj[e[1]]) < k - 2}
            changed = bool(drop)
            live -= drop
        for e in live:
            out[e] = k
        k += 1
    return np.array([out[e] for e in E])


def canon(pairs) -> np.ndarray:
    e = np.array(sorted({(min(a, b), max(a, b)) for a, b in pairs
                         if a != b}), dtype=np.int64).reshape(-1, 2)
    return e


TINY = {
    "triangle": canon([(0, 1), (1, 2), (0, 2)]),
    "k5": canon(itertools.combinations(range(5), 2)),
    "two_k4_bridge": canon(list(itertools.combinations(range(4), 2))
                           + list(itertools.combinations(range(4, 8), 2))
                           + [(3, 4)]),
    "path": canon([(0, 1), (1, 2), (2, 3)]),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_matches_brute_force_on_tiny_graphs(name):
    e = TINY[name]
    assert (truss.decompose(e).trussness == brute_truss(e)).all()


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_brute_force_on_random_graphs(seed):
    rng = np.random.default_rng(seed)
    n = 14
    e = canon(p for p in itertools.combinations(range(n), 2)
              if rng.random() < 0.45)
    assert (truss.decompose(e).trussness == brute_truss(e)).all()


def test_reference_matches_brute_force_on_rmat_8():
    e = rmat_edges(8, 16, seed=0)
    assert (truss.decompose(e).trussness == brute_truss(e)).all()


def test_reference_matches_the_port_on_rmat_8():
    from repro_torch import truss_pkt
    e = rmat_edges(8, 16, seed=1)
    assert (truss.decompose(e).trussness
            == truss_pkt(e, device="cpu")).all()


def test_reference_counts_and_union():
    e = TINY["k5"]
    d = truss.decompose(e)
    assert d.triangles == 10 and d.m == 10 and d.n == 5
    parts = truss.decompose_many([TINY["k5"], TINY["path"], TINY["k5"]],
                                 block_edges=12)
    assert [p.tolist() for p in parts] == [[5] * 10, [2] * 3, [5] * 10]


def test_small_pair_chunks_give_the_same_triangles(monkeypatch):
    e = rmat_edges(8, 16, seed=2)
    whole = truss.decompose(e)
    monkeypatch.setattr(truss, "PAIR_CHUNK", 7)
    cut = truss.decompose(e)
    assert cut.triangles == whole.triangles
    assert (cut.trussness == whole.trussness).all()
