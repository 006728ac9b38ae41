"""WC: the Wang–Cheng sequential truss decomposition (paper Algorithm 1).

This is the paper's sequential baseline: hash-table adjacency, bucket-sorted
edges with O(1) reordering (the Batagelj–Zaversnik trick), ascending-support
peeling one edge at a time. Implemented faithfully in numpy + dicts — it is
*meant* to exhibit the hash-table and sequential-processing costs that PKT
removes, and doubles as an independent oracle.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def truss_wc(g: CSRGraph) -> np.ndarray:
    """Returns trussness per edge id (aligned with g.El). O(m^1.5)."""
    m, n = g.m, g.n
    if m == 0:
        return np.zeros(0, np.int64)

    # hash table: (u, v) -> edge id, u < v   (paper's Eh)
    eh: dict[tuple[int, int], int] = {}
    for e in range(m):
        u, v = int(g.El[e, 0]), int(g.El[e, 1])
        eh[(u, v)] = e
    adj: list[set[int]] = [set() for _ in range(n)]
    for u, v in g.El:
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))

    # support via intersection (the WC paper computes it the same way)
    S = np.zeros(m, dtype=np.int64)
    for e in range(m):
        u, v = int(g.El[e, 0]), int(g.El[e, 1])
        if len(adj[u]) > len(adj[v]):
            u, v = v, u
        S[e] = sum(1 for w in adj[u] if w in adj[v])

    # bucket structure over support for O(1) "Reorder El"
    max_s = int(S.max(initial=0))
    bin_start = np.zeros(max_s + 2, dtype=np.int64)
    np.add.at(bin_start, S + 1, 1)
    bin_start = np.cumsum(bin_start)
    pos = np.zeros(m, dtype=np.int64)
    el_sorted = np.zeros(m, dtype=np.int64)
    fill = bin_start[:-1].copy()
    for e in range(m):
        pos[e] = fill[S[e]]
        el_sorted[pos[e]] = e
        fill[S[e]] += 1
    bin_ptr = bin_start[:-1].copy()  # current start of each bucket

    truss = np.zeros(m, dtype=np.int64)
    removed = np.zeros(m, dtype=bool)

    def decrease(e2: int, k: int) -> None:
        """S[e2] -= 1 with bucket maintenance, never below k."""
        if S[e2] <= k:
            return
        s2 = int(S[e2])
        p2 = int(pos[e2])
        pw = int(bin_ptr[s2])
        w_ = int(el_sorted[pw])
        if e2 != w_:
            el_sorted[p2], el_sorted[pw] = w_, e2
            pos[e2], pos[w_] = pw, p2
        bin_ptr[s2] += 1
        S[e2] -= 1

    for i in range(m):
        e = int(el_sorted[i])
        k = int(S[e])
        u, v = int(g.El[e, 0]), int(g.El[e, 1])
        if len(adj[u]) > len(adj[v]):
            u, v = v, u
        for w in list(adj[u]):
            if w in adj[v]:
                e2 = eh[(min(v, w), max(v, w))]
                e3 = eh[(min(u, w), max(u, w))]
                if removed[e2] or removed[e3]:
                    continue
                decrease(e2, k)
                decrease(e3, k)
        truss[e] = k + 2
        removed[e] = True
        adj[u].discard(v)
        adj[v].discard(u)

    return truss
