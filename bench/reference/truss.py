"""Plain truss decomposition: triangle listing and level-by-level peeling
in PyTorch tensor operations, on the card or on the CPU.

The trussness of an edge is the largest k such that the edge lies in a
subgraph whose every edge closes at least k - 2 triangles inside it.  The
peel here is the textbook one (Wang & Cheng, VLDB 2012), run a sub-level at
a time: at support level k, every live edge with support <= k leaves with
trussness k + 2, every live triangle through one of them dies, and each
surviving edge of a dying triangle loses one support.  When no live edge
is left at or under k, k rises to the least live support.

Triangles are listed once each, at their lowest vertex in (degree, id)
order: for each oriented edge a -> b, the later out-neighbours c of a are
paired with b and the edge b - c is looked up among the sorted edge keys.

Independent of the program under test: it shares no code, orientation,
table or kernel with ``repro_torch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: candidate pairs expanded at a time while listing triangles
PAIR_CHUNK = 1 << 24


@dataclasses.dataclass
class Decomposition:
    """A graph's trussness and its counts."""

    trussness: np.ndarray    # (m,) int64, aligned to the input rows
    n: int                   # vertices (max id + 1)
    m: int                   # edges
    triangles: int


def _keys(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    return lo * n + hi


def triangles(edges: torch.Tensor, n: int):
    """List every triangle once: (t, 3) int64 edge ids.  ``edges`` is
    (m, 2) int64, u < v, unique."""
    dev = edges.device
    m = edges.shape[0]
    u, v = edges[:, 0], edges[:, 1]
    deg = torch.bincount(torch.cat([u, v]), minlength=n)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(deg * n + torch.arange(n, device=dev))] = \
        torch.arange(n, device=dev)
    low_first = rank[u] < rank[v]
    a = torch.where(low_first, u, v)
    b = torch.where(low_first, v, u)
    order = torch.argsort(a * n + b)
    a, b, eid = a[order], b[order], order
    outdeg = torch.bincount(a, minlength=n)
    off = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(outdeg, 0)
    keys = _keys(u, v, n)
    key_order = torch.argsort(keys)
    sorted_keys = keys[key_order]
    # oriented edge i pairs with the later edges of its out-list
    later = off[a + 1] - 1 - torch.arange(m, device=dev)
    reach = torch.cumsum(later, 0)
    found = []
    start = 0
    while start < m:
        base = int(reach[start - 1]) if start else 0
        stop = int(torch.searchsorted(reach, base + PAIR_CHUNK,
                                      right=True))
        stop = max(stop, start + 1)
        cnt = later[start:stop]
        total = int(cnt.sum())
        if total:
            i = torch.repeat_interleave(
                torch.arange(start, stop, device=dev), cnt,
                output_size=total)
            first = torch.cumsum(cnt, 0) - cnt
            j = i + 1 + torch.arange(total, device=dev) - \
                torch.repeat_interleave(first, cnt, output_size=total)
            x, y = b[i], b[j]
            want = _keys(torch.minimum(x, y), torch.maximum(x, y), n)
            pos = torch.searchsorted(sorted_keys, want).clamp_(max=m - 1)
            hit = sorted_keys[pos] == want
            found.append(torch.stack(
                [eid[i[hit]], eid[j[hit]], key_order[pos[hit]]], 1))
        start = stop
    tri = (torch.cat(found) if found
           else torch.zeros((0, 3), dtype=torch.int64, device=dev))
    return tri


def peel(tri: torch.Tensor, m: int) -> torch.Tensor:
    """Trussness of each of ``m`` edges from the triangle list."""
    dev = tri.device
    flat = tri.reshape(-1)
    sup = torch.bincount(flat, minlength=m)
    off = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(sup, 0)
    by_edge = torch.argsort(flat, stable=True) // 3
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    tri_alive = torch.ones(tri.shape[0], dtype=torch.bool, device=dev)
    truss = torch.zeros(m, dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    k = 0
    while True:
        front = torch.nonzero(alive & (sup <= k)).squeeze(1)
        if front.numel() == 0:
            least = int(torch.where(alive, sup, big).min()) if m else big
            if least == big:
                return truss
            k = least
            continue
        truss[front] = k + 2
        alive[front] = False
        start = off[front]
        cnt = off[front + 1] - start
        total = int(cnt.sum())
        if total == 0:
            continue
        pos = torch.repeat_interleave(start - (torch.cumsum(cnt, 0) - cnt),
                                      cnt, output_size=total)
        rows = by_edge[pos + torch.arange(total, device=dev)]
        rows = torch.unique(rows[tri_alive[rows]])
        tri_alive[rows] = False
        ends = tri[rows].reshape(-1)
        ends = ends[alive[ends]]
        sup.index_add_(0, ends, torch.full_like(ends, -1))


def decompose(edges: np.ndarray, device="cpu") -> Decomposition:
    """Trussness of canonical (m, 2) rows (u < v, unique), row-aligned."""
    E = torch.as_tensor(np.ascontiguousarray(edges, dtype=np.int64),
                        device=device)
    m = int(E.shape[0])
    n = int(E.max()) + 1 if m else 0
    if m == 0:
        return Decomposition(np.zeros(0, np.int64), 0, 0, 0)
    if bool((E[:, 0] >= E[:, 1]).any()):
        raise ValueError("rows must be canonical: u < v")
    tri = triangles(E, n)
    return Decomposition(peel(tri, m).cpu().numpy(), n, m, int(tri.shape[0]))


def decompose_many(graphs, device="cpu", *,
                   block_edges: int = 1 << 22) -> list[np.ndarray]:
    """Trussness of each graph of ``graphs`` (canonical rows each), decided
    over disjoint unions of up to ``block_edges`` edges at a time."""
    out: list[np.ndarray] = [None] * len(graphs)
    i = 0
    while i < len(graphs):
        j, edges_in = i, 0
        while j < len(graphs) and (j == i or
                                   edges_in + len(graphs[j]) <= block_edges):
            edges_in += len(graphs[j])
            j += 1
        parts, base, bounds = [], 0, [0]
        for g in graphs[i:j]:
            g = np.asarray(g, dtype=np.int64)
            parts.append(g + base)
            base += int(g.max()) + 1 if len(g) else 0
            bounds.append(bounds[-1] + len(g))
        truss = decompose(np.concatenate(parts), device).trussness
        for k in range(i, j):
            out[k] = truss[bounds[k - i]:bounds[k - i + 1]]
        i = j
    return out
