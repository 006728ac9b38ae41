"""Synthetic graph generators (offline stand-ins for the paper's SNAP/UFL suite).

The paper's 15 graphs are social networks and web crawls with skewed degree
distributions. Offline we mirror the *shape statistics* that drive the
algorithms (skew → wedge/triangle ratio, coreness spread):

  - RMAT         : skewed, social-network-like (the Graph500 generator)
  - Erdős–Rényi  : flat degrees, low clustering (adversarial for ordering wins)
  - Barabási–Albert : power-law-ish, moderate clustering
  - ring of cliques  : high trussness, deep peeling (web-crawl-like t_max)

All generators return canonical (m,2) int64 u<v unique edge arrays.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import edges_from_arrays


def rmat_edges(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> np.ndarray:
    """Graph500-style R-MAT: 2^scale vertices, ~edge_factor * 2^scale edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        go_down = r1 >= ab
        go_right = np.where(go_down, r2 >= c_norm, r2 >= a_norm)
        src = 2 * src + go_down
        dst = 2 * dst + go_right
    return edges_from_arrays(src, dst, n)


def erdos_renyi_edges(n: int, avg_degree: float, seed: int = 0) -> np.ndarray:
    """Erdős–Rényi G(n, m) with m = n * avg_degree / 2 sampled edges."""
    rng = np.random.default_rng(seed)
    m_target = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=2 * m_target)
    dst = rng.integers(0, n, size=2 * m_target)
    e = edges_from_arrays(src, dst, n)
    if e.shape[0] > m_target:
        sel = rng.choice(e.shape[0], size=m_target, replace=False)
        e = e[np.sort(sel)]
    return e


def barabasi_albert_edges(n: int, m_attach: int, seed: int = 0) -> np.ndarray:
    """Preferential attachment via the repeated-nodes trick (vectorized-ish)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = []
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m_attach, n):
        for t in targets:
            src_l.append(v)
            dst_l.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m_attach)
        idx = rng.integers(0, len(repeated), size=m_attach)
        targets = list({repeated[i] for i in idx})
        while len(targets) < m_attach:
            targets.append(int(rng.integers(0, v + 1)))
            targets = list(set(targets))
    return edges_from_arrays(np.array(src_l), np.array(dst_l), n)


def ring_of_cliques_edges(n_cliques: int, clique_size: int, seed: int = 0) -> np.ndarray:
    """n_cliques cliques of clique_size vertices, chained in a ring.

    Every intra-clique edge has trussness = clique_size; bridge edges have
    trussness 2 — a deterministic ground-truth-rich instance.
    """
    del seed
    src_l: list[int] = []
    dst_l: list[int] = []
    for ci in range(n_cliques):
        base = ci * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                src_l.append(base + i)
                dst_l.append(base + j)
        nxt = ((ci + 1) % n_cliques) * clique_size
        src_l.append(base)
        dst_l.append(nxt)
    n = n_cliques * clique_size
    return edges_from_arrays(np.array(src_l), np.array(dst_l), n)


def random_graph_edges(kind: str, size: str, seed: int = 0) -> np.ndarray:
    """Convenience dispatcher used by benchmarks: kind x {tiny,small,medium,large}."""
    if kind == "rmat":
        scale = {"tiny": 8, "small": 12, "medium": 15, "large": 17}[size]
        return rmat_edges(scale, edge_factor=8, seed=seed)
    if kind == "er":
        n = {"tiny": 256, "small": 4096, "medium": 32768, "large": 131072}[size]
        return erdos_renyi_edges(n, avg_degree=16.0, seed=seed)
    if kind == "ba":
        n = {"tiny": 256, "small": 4096, "medium": 32768, "large": 131072}[size]
        return barabasi_albert_edges(n, m_attach=8, seed=seed)
    if kind == "cliques":
        k = {"tiny": (8, 8), "small": (64, 12), "medium": (256, 16), "large": (512, 24)}[size]
        return ring_of_cliques_edges(*k)
    raise ValueError(f"unknown graph kind {kind!r}")
