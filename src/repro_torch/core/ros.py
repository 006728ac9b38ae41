"""Ros baseline (paper Algorithm 2 + sequential peel).

Rossi's algorithm parallelizes *only* the support computation (edge-based full
intersection, work ∝ Σ d(v)² — no orientation win), then peels sequentially
with the same bucket structure as WC but hash-free (CSR + Eid). This is the
paper's strongest prior shared-memory baseline (Tables 3–4).  The support
runs on the device (``support.compute_support_ros``); the peel is the JAX
package's host loop, copied.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.support import compute_support_ros
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph


def truss_ros(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """Trussness per edge id; support in parallel on ``device`` ("cuda" by
    default, raises when no card is present; or "cpu"), peel sequential."""
    device = resolve_device(device)
    m = g.m
    if m == 0:
        return np.zeros(0, np.int64)
    S = compute_support_ros(g, device=device).astype(np.int64)

    Es, N, Eid, El = g.Es, g.N, g.Eid, g.El

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
    bin_ptr = bin_start[:-1].copy()

    truss = np.zeros(m, dtype=np.int64)
    removed = np.zeros(m, dtype=bool)

    def decrease(e2: int, k: int) -> None:
        if S[e2] <= k:
            return
        s2 = int(S[e2]); p2 = int(pos[e2])
        pw = int(bin_ptr[s2]); w_ = int(el_sorted[pw])
        if e2 != w_:
            el_sorted[p2], el_sorted[pw] = w_, e2
            pos[e2], pos[w_] = pw, p2
        bin_ptr[s2] += 1
        S[e2] -= 1

    for i in range(m):
        e = int(el_sorted[i])
        k = int(S[e])
        u, v = int(El[e, 0]), int(El[e, 1])
        if Es[u + 1] - Es[u] > Es[v + 1] - Es[v]:
            u, v = v, u
        row_v = N[Es[v]:Es[v + 1]]
        eid_v = Eid[Es[v]:Es[v + 1]]
        for j in range(Es[u], Es[u + 1]):
            w = N[j]
            t = np.searchsorted(row_v, w)
            if t < row_v.shape[0] and row_v[t] == w:
                e2 = int(Eid[j])            # (u, w)
                e3 = int(eid_v[t])          # (v, w)
                if removed[e2] or removed[e3]:
                    continue
                decrease(e2, k)
                decrease(e3, k)
        truss[e] = k + 2
        removed[e] = True

    return truss
