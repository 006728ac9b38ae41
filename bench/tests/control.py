"""The control: the plain reference with one guarantee broken.

The configurations state exact trussness.  The control is the reference's
peel with its sub-levels left out, the step a faster peel would be
tempted to skip: each level removes the edges at or under it once, and
the level then rises, so that edges whose support falls under the level
inside it leave one level too late.  Its answers must come out as not
correct.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import truss


def peel_one_pass(tri: torch.Tensor, m: int) -> torch.Tensor:
    """Like ``truss.peel``, but one sub-level per level."""
    dev = tri.device
    flat = tri.reshape(-1)
    sup = torch.bincount(flat, minlength=m)
    off = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(sup, 0)
    by_edge = torch.argsort(flat, stable=True) // 3
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    tri_alive = torch.ones(tri.shape[0], dtype=torch.bool, device=dev)
    out = torch.zeros(m, dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    k = 0
    while True:
        least = int(torch.where(alive, sup, big).min())
        if least == big:
            return out
        k = max(k, least)
        front = torch.nonzero(alive & (sup <= k)).squeeze(1)
        out[front] = k + 2
        alive[front] = False
        start = off[front]
        cnt = off[front + 1] - start
        total = int(cnt.sum())
        k += 1                                  # the sub-levels skipped
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


def decompose(edges: np.ndarray, device="cpu") -> np.ndarray:
    """The control's trussness of canonical rows, row-aligned."""
    E = torch.as_tensor(np.ascontiguousarray(edges, dtype=np.int64),
                        device=device)
    n = int(E.max()) + 1
    tri = truss.triangles(E, n)
    return peel_one_pass(tri, int(E.shape[0])).cpu().numpy()


def decompose_many(graphs, device="cpu") -> list[np.ndarray]:
    """The control per graph, over one disjoint union."""
    parts, base, bounds = [], 0, [0]
    for g in graphs:
        parts.append(np.asarray(g, np.int64) + base)
        base += int(g.max()) + 1
        bounds.append(bounds[-1] + len(g))
    t = decompose(np.concatenate(parts), device)
    return [t[bounds[i]:bounds[i + 1]] for i in range(len(graphs))]
