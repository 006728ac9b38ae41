"""The degree-class support path around K3 (``intersect.py``).

``compute_support_kernel`` is a drop-in for ``core.support.compute_support``
(the port of the JAX package's ``repro/kernels/ops.py``): edges are
bucketed by oriented-degree class (power-of-two row widths 8 … 256), each
bucket's ``N⁺(u)`` and ``N⁺(v)`` rows are gathered into padded (E, D)
arrays and intersected by K3, and the hit masks add support at the edge
ids of the matching slots.  Edges whose larger endpoint row exceeds the
last class fall back to the ranged binary search (the torch support
executor), whose table is built on the device.

Only hits are added: the JAX package scatters every miss to slot ``m``,
which on the GPU would send E·D zero-adds per bucket to one address.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.intersect import intersect_blocked

_DEG_CLASSES = (8, 16, 32, 64, 128, 256)


#: rows per thread block of K3: two for each of the kernel's eight warps, so
#: the smallest buckets (a few thousand rows at Graph500 scale 17) still fill
#: the card; the JAX package's VMEM-sized block (up to 1,024 rows) left them
#: on a few SMs.  No result depends on it.
BLOCK_ROWS = 16


def _gather_rows(N, Eid, start, length, D: int):
    """(E, D) padded rows of N and Eid: N[start[i] + j] for j < length[i],
    padded with -1 and 0."""
    ar = torch.arange(D, dtype=torch.int32, device=N.device)
    mask = ar[None, :] < length[:, None]
    safe = (start[:, None] + ar[None, :]).clamp(max=N.shape[0] - 1)
    return (torch.where(mask, N[safe], -1), torch.where(mask, Eid[safe], 0))


def _add_hits(S, eids, hit) -> None:
    """S[eids[hit]] += 1 — the hits only, never a sentinel slot."""
    sel = eids[hit.bool()]
    S.index_add_(0, sel, torch.ones_like(sel))


def bucket_rows(N, Eid, u_start, u_len, v_start, v_len, D: int):
    """K3's operands for one bucket: ``(rows_a, eids_a, rows_b, eids_b)``.

    ``rows_a`` pads with -1, ``rows_b`` with -2, as the kernel's callers in
    the JAX package do; the eid arrays pad with 0 (never read: the slot
    cannot hit).
    """
    rows_a, eids_a = _gather_rows(N, Eid, u_start, u_len, D)
    rows_b, eids_b = _gather_rows(N, Eid, v_start, v_len, D)
    rows_b = torch.where(rows_b < 0, -2, rows_b)
    return rows_a, eids_a, rows_b, eids_b


def _bucket_support(S, N, Eid, u_start, u_len, v_start, v_len, e1,
                    D: int) -> None:
    """Add one degree-class bucket's support contributions to ``S`` (m,)."""
    rows_a, eids_a, rows_b, eids_b = bucket_rows(N, Eid, u_start, u_len,
                                                 v_start, v_len, D)
    cnt, hita, hitb = intersect_blocked(rows_a, rows_b, block_rows=BLOCK_ROWS)
    del rows_a, rows_b
    S.index_add_(0, e1, cnt)
    _add_hits(S, eids_a, hita)
    del eids_a, hita
    _add_hits(S, eids_b, hitb)


def degree_buckets(g: CSRGraph, classes=_DEG_CLASSES):
    """Host bucketing of the edges by oriented-degree class.

    Returns ``(buckets, fallback)``: ``buckets`` a list of ``(D, ids,
    u_start, u_len, v_start, v_len)`` numpy int32 arrays per non-empty
    class, ``fallback`` the int64 ids of the edges above the last class.
    Edges with both oriented rows empty close no triangle as anchor and go
    nowhere.
    """
    u = g.El[:, 0].astype(np.int64)
    v = g.El[:, 1].astype(np.int64)
    Es = g.Es.astype(np.int64)
    Eo = g.Eo.astype(np.int64)
    dpu = Es[u + 1] - Eo[u]     # |N⁺(u)|
    dpv = Es[v + 1] - Eo[v]     # |N⁺(v)|
    dmax = np.maximum(dpu, dpv)
    buckets = []
    prev = 0
    for D in classes:
        ids = np.nonzero((dmax > prev) & (dmax <= D))[0]
        prev = D
        if ids.size == 0:
            continue
        buckets.append((D, ids.astype(np.int32),
                        Eo[u[ids]].astype(np.int32),
                        dpu[ids].astype(np.int32),
                        Eo[v[ids]].astype(np.int32),
                        dpv[ids].astype(np.int32)))
    return buckets, np.nonzero(dmax > classes[-1])[0]


def compute_support_kernel(g: CSRGraph, *, classes=_DEG_CLASSES,
                           device="cuda") -> np.ndarray:
    """AM4 support through K3's degree-class buckets → (m,) int32.

    Equal to ``core.support.compute_support``.  ``classes`` are the bucket
    row widths in increasing order; ``device`` is "cuda" (the default;
    raises when no card is present) or "cpu" (K3's plain version).
    """
    device = resolve_device(device)
    if g.m == 0:
        return np.zeros(0, np.int32)
    arrays = g.device_arrays(device)
    N, Eid = arrays["N"], arrays["Eid"]
    S = torch.zeros(g.m, dtype=torch.int32, device=device)
    buckets, fallback = degree_buckets(g, classes)
    for D, ids, u_start, u_len, v_start, v_len in buckets:
        up = [torch.tensor(x, device=device)
              for x in (u_start, u_len, v_start, v_len, ids)]
        _bucket_support(S, N, Eid, *up, D)
    if fallback.size:
        S += _fallback_support(g, fallback, device)
    return S.cpu().numpy()


def fallback_table(g: CSRGraph, edge_ids: np.ndarray, device):
    """Device-built oriented wedge rows of the given edges only.

    The rows of ``core.support.build_support_table`` restricted to
    ``edge_ids``, in the same order as the JAX package's host
    ``np.repeat`` builds them: ``(e1, cand_slot, lo, hi)`` int32.
    """
    arrays = g.device_arrays(device)
    Es, Eo = arrays["Es"], arrays["Eo"]
    ids = torch.tensor(edge_ids.astype(np.int32), device=device)
    u = arrays["u"][ids]
    v = arrays["v"][ids]
    cnt = Es[v + 1] - Eo[v]
    off = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=device)
    torch.cumsum(cnt, 0, dtype=torch.int64, out=off[1:])
    nw = int(off[-1])
    if nw > np.iinfo(np.int32).max:
        raise ValueError(f"fallback table of {nw} rows exceeds the int32 "
                         f"layout")
    local = torch.repeat_interleave(
        torch.arange(ids.shape[0], dtype=torch.int32, device=device),
        cnt.to(torch.int64), output_size=nw)
    intra = (torch.arange(nw, dtype=torch.int32, device=device)
             - off[:-1].to(torch.int32)[local])
    e1 = ids[local]
    cand = Eo[v[local]] + intra
    del intra
    ul = u[local]
    del local
    return e1, cand, Eo[ul], Es[ul + 1]


def _fallback_support(g: CSRGraph, edge_ids: np.ndarray,
                      device) -> torch.Tensor:
    """Ranged-binary-search support restricted to the given (huge) edges."""
    # core.support imports this package (wedge_common): import it late
    from repro_torch.core.support import _search_iters, _support_torch

    e1, cand, lo, hi = fallback_table(g, edge_ids, device)
    arrays = g.device_arrays(device)
    return _support_torch(arrays["N"], arrays["Eid"], e1, cand, lo, hi,
                          _search_iters(g, oriented=True), g.m)
