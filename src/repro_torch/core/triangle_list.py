"""Triangle-list truss decomposition — the O(|△|)-memory comparator.

The port of the JAX package's ``core/triangle_list.py``
(Zhang–Parthasarathy style): enumerate every triangle once up front, then
peel level-synchronously over the static triangle list.  A triangle "dies"
the first sub-level any of its edges is in the frontier, and contributes
one decrement to each of its other edges with S > l — the paper's
tie-break, stated triangle-centrically.

The peel loop runs on the host, as ``core/pkt.py: _peel_loop`` does, and
reads one small tensor per sub-level: ``[#dying triangles, #processed,
l]``.  The next sub-level's frontier is computed as ``S == min(live S)``,
which is the current level while any live edge still holds it and the
next level's minimum otherwise, so one read answers both loop tests.  Dead
triangles are dropped as they die, and only the dying ones are scattered:
the JAX package adds a masked 0 for every triangle to one spare slot,
which on the GPU would serialize on that address.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import support as support_mod
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels import wedge_common

_SENTINEL_S = 1 << 30


def _triangles_dev(g: CSRGraph, device: torch.device) -> torch.Tensor:
    """(t, 3) int32 edge-id triangles on ``device``, in support-table order.

    The oriented support table is built and probed one slice of
    ``wedge_common.SLICE_ROWS`` rows at a time, so that only the triangles
    found and one slice's table are held at once (a whole Graph500
    scale-18 table is 0.94 × 10^9 rows)."""
    size = support_mod.support_table_size(g)
    if size == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=device)
    support_mod._check_table_size(size)
    dev = g.device_arrays(device)
    N, Eid = dev["N"], dev["Eid"]
    iters = support_mod._search_iters(g, oriented=True)
    parts = []
    for start, stop in wedge_common.row_slices(size):
        e1, cand, lo, hi, _ = support_mod._build_support_table_dev(
            dev["u"], dev["v"], dev["Es"], dev["Eo"], g.m, m=g.m,
            size=stop - start, start=start)
        hit, safe = wedge_common.probe(N, cand, lo, hi, iters=iters)
        idx = torch.nonzero(hit)[:, 0]
        parts.append(torch.stack([e1[idx], Eid[cand[idx]], Eid[safe[idx]]],
                                 dim=1))
    return torch.cat(parts)


def enumerate_triangles(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """All triangles as an (t, 3) int32 array of edge ids (canonical order).

    Row ``i`` is the ``i``-th hit of the oriented support table: anchor
    edge, then the edges of its candidate and probe slots.  ``device`` is
    "cuda" (the default; raises when no card is present) or "cpu".
    """
    device = resolve_device(device)
    if g.m == 0:
        return np.zeros((0, 3), np.int32)
    return _triangles_dev(g, device).cpu().numpy()


def peel_trilist(tri: torch.Tensor, S0: torch.Tensor, *, m: int):
    """Level-synchronous peel over the triangle list.

    ``tri`` (t, 3) int32 edge ids, ``S0`` (m,) int32 initial support, both
    on one device.  Returns ``(S, levels, sublevels)`` with the final S on
    that device.  The live triangles are kept as three contiguous edge-id
    columns, so a triangle's frontier test is three gathers and two ORs.
    """
    dev = tri.device
    cols = [tri[:, k].contiguous() for k in range(3)]
    S = S0.to(torch.int32).clone()
    processed = torch.zeros(m, dtype=torch.bool, device=dev)
    l = S.min()
    inC = S == l
    dies = inC[cols[0]] | inC[cols[1]] | inC[cols[2]]
    n_die, l_host = torch.stack([dies.sum(), l.to(torch.int64)]).tolist()
    t = tri.shape[0]
    n_done = 0
    levels, subs = 1, 0
    while n_done < m:
        d_idx = torch.nonzero_static(dies, size=n_die).view(-1)
        k_idx = torch.nonzero_static(~dies, size=t - n_die).view(-1)
        dying = torch.stack([c[d_idx] for c in cols])
        cols = [c[k_idx] for c in cols]
        t -= n_die
        # each dying triangle decrements its edges off the frontier with S > l
        gives = ~inC[dying] & (S[dying] > l)
        dec = torch.zeros(m, dtype=torch.int32, device=dev)
        dec.index_add_(0, dying.view(-1), gives.view(-1).to(torch.int32))
        S = torch.where(~processed & ~inC & (dec > 0),
                        torch.maximum(S - dec, l), S)
        processed |= inC
        subs += 1
        l = torch.where(processed, _SENTINEL_S, S).min()
        inC = ~processed & (S == l)
        dies = inC[cols[0]] | inC[cols[1]] | inC[cols[2]]
        n_die, n_done, l_now = torch.stack(
            [dies.sum(), processed.sum(), l.to(torch.int64)]).tolist()
        if n_done < m and l_now != l_host:
            levels += 1
            l_host = l_now
    return S, levels, subs


def truss_trilist(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """Trussness per edge via the triangle-list variant (int64, aligned
    with ``g.El``).  The initial support runs through K1.  ``device`` is
    "cuda" (the default; raises when no card is present) or "cpu"."""
    device = resolve_device(device)
    if g.m == 0:
        return np.zeros(0, np.int64)
    S0 = support_mod._support_device(g, mode="kernel", chunk=None,
                                     device=device)
    tri = _triangles_dev(g, device)
    if tri.shape[0] == 0:
        return np.full(g.m, 2, np.int64)
    S, _, _ = peel_trilist(tri, S0, m=g.m)
    return S.cpu().numpy().astype(np.int64) + 2
