"""Trivially-correct truss decomposition oracle (numpy + python sets).

Definitionally faithful and slow: for k = 3, 4, ... repeatedly delete edges
whose support inside the remaining subgraph is < k-2; edges deleted while
moving to k have trussness k-1. Used as the ground truth for property tests.
"""

from __future__ import annotations

import numpy as np


def support_naive(edges: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Support of each alive edge within the alive subgraph (set intersection)."""
    adj: dict[int, set[int]] = {}
    for (u, v), a in zip(edges, alive):
        if a:
            adj.setdefault(int(u), set()).add(int(v))
            adj.setdefault(int(v), set()).add(int(u))
    S = np.zeros(edges.shape[0], dtype=np.int64)
    for e, ((u, v), a) in enumerate(zip(edges, alive)):
        if a:
            S[e] = len(adj.get(int(u), set()) & adj.get(int(v), set()))
    return S


def truss_numpy(edges: np.ndarray) -> np.ndarray:
    """Returns trussness (>= 2) per edge of a canonical u<v edge array."""
    m = edges.shape[0]
    truss = np.full(m, 2, dtype=np.int64)
    alive = np.ones(m, dtype=bool)
    k = 3
    while alive.any():
        while True:
            S = support_naive(edges, alive)
            drop = alive & (S < k - 2)
            if not drop.any():
                break
            truss[drop] = k - 1
            alive &= ~drop
        # all remaining edges are in a k-truss (support-wise); bump k
        truss[alive] = k
        k += 1
    return truss


def max_truss(edges: np.ndarray) -> int:
    """Largest k such that the k-truss is non-empty (numpy oracle)."""
    t = truss_numpy(edges)
    return int(t.max(initial=2))
