"""Deterministic named graphs for tests and the benchmark suite."""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import edges_from_arrays
from repro_torch.graphs import gen


def paper_fig1_edges() -> np.ndarray:
    """The example graph of the paper's Figure 1 (reconstructed).

    Two triangle-rich lobes joined by a 2-truss bridge: all vertices have
    coreness 3, two edges have trussness 2, the rest trussness 3, and there are
    two 3-trusses. Construction: two K4-minus-an-edge... we use two diamonds
    (4-cycles with one chord each give trussness 3 on all edges) linked by two
    bridge edges of trussness 2.
    """
    # Lobe A: vertices 0..3, edges of K4 minus (1,2)? K4 has every edge in 2
    # triangles -> trussness 4. For trussness 3 on all edges use a "diamond":
    # cycle 0-1-2-3 with chord 0-2: edges (0,1),(1,2),(2,3),(0,3),(0,2) —
    # chord in 2 triangles, rim edges in 1 -> 3-truss requires >=1 triangle/edge.
    a = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2)]
    b = [(4, 5), (5, 6), (6, 7), (4, 7), (4, 6)]
    bridges = [(3, 4), (2, 5)]
    e = np.array(a + b + bridges, dtype=np.int64)
    return edges_from_arrays(e[:, 0], e[:, 1], 8)


def karate_like_edges() -> np.ndarray:
    """A fixed small social-like graph (deterministic, 34 vertices)."""
    rng = np.random.default_rng(34)
    # planted: two communities of 17 with dense intra, sparse inter edges
    src, dst = [], []
    for base in (0, 17):
        for i in range(17):
            for j in range(i + 1, 17):
                if rng.random() < 0.45:
                    src.append(base + i)
                    dst.append(base + j)
    for _ in range(10):
        src.append(int(rng.integers(0, 17)))
        dst.append(int(rng.integers(17, 34)))
    return edges_from_arrays(np.array(src), np.array(dst), 34)


def triangle_edges() -> np.ndarray:
    """A single triangle (trussness 3 on every edge)."""
    return np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64)


def k4_edges() -> np.ndarray:
    """The complete graph on four vertices (trussness 4)."""
    return np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)


def path_edges(n: int = 5) -> np.ndarray:
    """A path on ``n`` vertices (triangle-free: trussness 2)."""
    return np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).astype(np.int64)


def named_graph(name: str) -> np.ndarray:
    """Edges of a named graph: a fixed one, or ``<kind>-<size>`` generated."""
    if name == "fig1":
        return paper_fig1_edges()
    if name == "karate_like":
        return karate_like_edges()
    if name == "triangle":
        return triangle_edges()
    if name == "k4":
        return k4_edges()
    if name == "path":
        return path_edges()
    kind, _, size = name.partition("-")
    return gen.random_graph_edges(kind, size or "small")


#: The benchmark suite mirroring the paper's Table 1 *structure* (ordered by
#: rising wedge count; mixes social-like skew with flat and deep-truss
#: shapes). Sized for a single-core CPU run of the full harness.
GRAPH_SUITE = [
    "cliques-tiny",
    "er-small",
    "ba-small",
    "rmat-small",
    "cliques-small",
    "ba-medium",
]

#: Larger suite for headline benchmarks (kept laptop-tractable).
GRAPH_SUITE_LARGE = GRAPH_SUITE + [
    "er-medium", "rmat-medium", "cliques-medium", "ba-large", "rmat-large"]
