"""``truss_pkt``'s preprocessing as device sorts and scans.

The same result as ``core/pkt.py: preprocess`` (the host numpy helpers of
``graphs/csr.py`` and ``kcore_numpy``), bit for bit, from integer work on
the device.  The rows go up once; then:

  1. canonical edges: ``lo * n + hi`` keys of the rows, sorted and deduped;
  2. the coreness order: ``kcore.peel_cores`` over the slots of the
     canonical edges, then a stable sort of the coreness (ties by id, as
     ``np.lexsort((arange, core))``) and its inverse;
  3. the relabelled edges, sorted by key: ``El`` in lexicographic order,
     so edge ids follow it as in ``build_csr``;
  4. the CSR: the symmetrized ``(src, dst)`` keys sorted with their edge
     ids (``N``, ``Eid``); ``Es`` the degrees' running sum; ``Eo`` each
     row's start plus its neighbours below it, which are the edges it ends
     (``v``);
  5. each input row's key in the relabelled id space, left on the device
     for ``pkt.align_device``.

Only the five CSR arrays come back to the host, into an ordinary
``CSRGraph`` whose device cache already holds them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.kcore import peel_cores
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import (_MAX_N, MAX_PACK_N, CSRGraph,
                                    build_csr, check_edge_array)


def edge_keys(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``graphs.csr.edge_keys`` on tensors: ``lo * n + hi`` in int64, with
    its ``MAX_PACK_N`` bound on ``n``.  The ids are not range-checked (that
    would read the device): every caller here packs ids below ``n``."""
    n = int(n)
    if n > MAX_PACK_N:
        raise ValueError(
            f"n={n} overflows int64 lo*n+hi key packing (max {MAX_PACK_N})")
    return lo.to(torch.int64) * n + hi.to(torch.int64)


def _upload(edges, device: torch.device):
    """The rows on ``device`` as (k, 2) int64 and the id space ``n``, with
    ``check_edge_array``'s checks: dtype and shape on the host, the values
    in one read of the device.  A failed check is raised by
    ``check_edge_array`` itself, so the messages are its own."""
    arr = np.asarray(edges)
    if arr.size == 0:
        return None, 0
    if (not np.issubdtype(arr.dtype, np.integer) or arr.ndim != 2
            or arr.shape[1] != 2):
        check_edge_array(arr)
    if arr.dtype not in (np.int32, np.int64):
        arr = arr.astype(np.int64)
    rows = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    rows = rows.to(torch.int64)
    vmin, vmax, loops = torch.stack(
        [rows.min(), rows.max(),
         (rows[:, 0] == rows[:, 1]).any().to(torch.int64)]).tolist()
    if vmin < 0 or vmax >= _MAX_N or loops:
        check_edge_array(arr)
    return rows, vmax + 1


def _coreness_perm(E_lo, E_hi, n: int):
    """``perm[v]`` = rank of ``v`` by (coreness, id), and the k-core's
    sub-level count."""
    src = torch.cat([E_lo, E_hi]).to(torch.int32)
    dst = torch.cat([E_hi, E_lo]).to(torch.int32)
    deg = torch.bincount(src, minlength=n).to(torch.int32)
    core, subs = peel_cores(dst, src, deg)
    order = torch.sort(core, stable=True).indices
    perm = torch.empty(n, dtype=torch.int64, device=core.device)
    perm[order] = torch.arange(n, device=core.device)
    return perm, subs


def _csr(K: torch.Tensor, n: int, device: torch.device) -> CSRGraph:
    """The CSR graph of the sorted canonical keys ``K`` (on ``device``),
    downloaded, its cache of ``device`` arrays seeded with the tensors."""
    m = K.shape[0]
    u, v = K // n, K % n
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    order = torch.sort(edge_keys(src, dst, n)).indices
    ids = torch.arange(m, dtype=torch.int32, device=K.device)
    Es = torch.cumsum(torch.bincount(src, minlength=n + 1), 0)
    Es = torch.cat([Es.new_zeros(1), Es[:-1]])
    t = dict(
        N=dst[order].to(torch.int32), Eid=torch.cat([ids, ids])[order],
        Es=Es.to(torch.int32),
        Eo=(Es[:-1] + torch.bincount(v, minlength=n)).to(torch.int32),
        El=torch.stack([u, v], dim=1).to(torch.int32),
        u=u.to(torch.int32), v=v.to(torch.int32))
    g = CSRGraph(n=n, m=m, **{f: t[f].cpu().numpy()
                              for f in ("Es", "N", "Eid", "El", "Eo")})
    g._dev[str(device)] = t
    return g


def preprocess_device(edges, *, reorder: bool = True, device="cuda"):
    """``core/pkt.py: preprocess`` on ``device``: rows → ``(g, n,
    row_keys)``, equal to it field for field, with ``row_keys`` an int64
    tensor on ``device``.

    One ``pkt.preprocess`` span (``on`` the device type, ``core_sublevels``
    the k-core's sub-levels) that ends after the CSR arrays' download, with
    ``prep.canonical``, ``prep.order`` and ``prep.build`` inside (``m``).
    Raises ``check_edge_array``'s ``ValueError`` on rows it rejects.
    """
    device = resolve_device(device)
    with trace.span("pkt.preprocess", on=device.type, core_sublevels=0):
        with trace.span("prep.canonical"):
            rows, n = _upload(edges, device)
            if rows is None:
                return (build_csr(np.zeros((0, 2), np.int64), 0), 0,
                        torch.zeros(0, dtype=torch.int64, device=device))
            lo = torch.minimum(rows[:, 0], rows[:, 1])
            hi = torch.maximum(rows[:, 0], rows[:, 1])
            del rows
            row_keys = edge_keys(lo, hi, n)
            K = torch.unique(row_keys)
            trace.set(m=K.shape[0])
        if reorder:
            with trace.span("prep.order", m=K.shape[0]):
                E_lo, E_hi = K // n, K % n
                perm, subs = _coreness_perm(E_lo, E_hi, n)
                rl, rh = perm[E_lo], perm[E_hi]
                K = torch.sort(edge_keys(torch.minimum(rl, rh),
                                         torch.maximum(rl, rh), n)).values
                rl, rh = perm[lo], perm[hi]
                row_keys = edge_keys(torch.minimum(rl, rh),
                                     torch.maximum(rl, rh), n)
            trace.set(core_sublevels=subs)
        with trace.span("prep.build", m=K.shape[0]):
            g = _csr(K, n, device)
        return g, n, row_keys
