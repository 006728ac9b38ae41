"""Preprocessing: edge rows → relabelled CSR graph and row keys, and back.

Every entry point that takes edge rows prepares its graph here:

  1. canonical edges: the rows validated, each as ``(lo, hi)``, the unique
     ones sorted by their ``lo * n + hi`` key;
  2. the coreness order (the paper's preprocessing, with ``reorder``):
     vertices ranked by (coreness, id), the edges relabelled by that rank;
  3. each input row's key in the relabelled id space;
  4. the CSR graph of the relabelled edges (``graphs.csr.build_csr``).

It is written twice, with one result, bit for bit:

  * on the host (numpy): ``order_and_build`` (steps 2–4, for callers that
    canonicalize themselves: the engine's ``submit``, the handle's full
    rebuild, the CLI) and ``preprocess`` (all four);
  * on a device (``preprocess_device``): sorts and scans, the k-core by
    ``kcore.coreness`` over the canonical edges' CSR (one cooperative
    launch on a card, ``kcore.peel_cores`` elsewhere), the row keys left
    on the device for ``align_device``.  Only the five CSR arrays come back
    to the host, into an ordinary ``CSRGraph`` whose device cache already
    holds them.

``prepare`` chooses between the two (``on_device``), and ``align`` maps an
answer per ``g.El`` row back to the input rows with whichever row keys it
got.  The device path's CSR build (``csr_arrays``) also rebuilds the
survivors of a live-edge compaction (``core/pkt.py``), on a device where
``compacts_on_device`` says.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.kcore import coreness, kcore_numpy
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import (_MAX_N, MAX_PACK_N, CSRGraph, build_csr,
                                    canonical_edges_with_rows,
                                    check_edge_array, relabel)
from repro_torch.graphs.csr import edge_keys as host_edge_keys

#: the spans of the host path (``repro_torch.trace``)
PREPROCESS_SPANS = ("csr.canonical", "csr.order", "csr.relabel",
                    "csr.build")

#: input rows from which ``prepare`` on a CUDA device preprocesses and
#: aligns there: a sort-and-scan pipeline costs tens of launches and one read
#: a k-core sub-level.  On an H100 the host's numpy wins on a whole Graph500
#: scale-10 graph (10,505 rows) and the card on every graph from 2^14 rows
#: measured (PERF.md, section 6)
DEVICE_PREP_MIN_ROWS = 1 << 14

#: survivors from which the kernel executor's live-edge compaction
#: (``core/pkt.py: _segmented_peel``) rebuilds on a CUDA device.  On an H100,
#: rebuilding the survivors of R-MAT graphs peeled to a quarter of their
#: edges, the host won at 1,184 survivors, the two were even at 2,267, and
#: the card won from 5,366 on, by 1.7x there and 4x at 11,753 (PERF.md,
#: section 6)
DEVICE_COMPACT_MIN_ROWS = 1 << 12


# --- the host path -----------------------------------------------------------


def degeneracy_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Coreness-based vertex permutation: perm[v] = new id of vertex v.

    Vertices sorted by (coreness, id). Matches the paper's preprocessing
    ("doing a k-core decomposition and then reordering vertices").  One
    ``csr.order`` span.
    """
    with trace.span("csr.order", m=len(edges)):
        core = kcore_numpy(build_csr(edges, n))
        # stable by id within coreness
        order = np.lexsort((np.arange(n), core))
        perm = np.empty(n, dtype=np.int64)
        perm[order] = np.arange(n)
        return perm


def order_and_build(E: np.ndarray, lo: np.ndarray, hi: np.ndarray, n: int, *,
                    reorder: bool) -> tuple[CSRGraph, np.ndarray]:
    """Steps 2–4 on the host: ``(g, row_keys)``.

    ``E`` is the canonical key-sorted edge array and ``lo``/``hi`` the
    canonical endpoints of each input row, as ``canonical_edges_with_rows``
    returns them.  With ``reorder`` the vertices are relabelled by
    ``degeneracy_order`` first.  ``row_keys`` locates each row's edge in
    ``g`` for ``align_to_input``.  Opens no span of its own: the helpers'
    ``csr.order``, ``csr.relabel`` and ``csr.build``.
    """
    if reorder:
        perm = degeneracy_order(E, n)
        E = relabel(E, perm)
        rl, rh = perm[lo], perm[hi]
        lo, hi = np.minimum(rl, rh), np.maximum(rl, rh)
    return build_csr(E, n), host_edge_keys(lo, hi, n)


def preprocess(edges, *, reorder: bool = True):
    """Rows → ``(g, n, row_keys)`` on the host.

    Validates and canonicalizes the rows (endpoint order free, duplicates
    allowed; ``check_edge_array``'s ``ValueError`` on the rest), then
    ``order_and_build``.
    """
    E, lo, hi, n = canonical_edges_with_rows(edges)
    if E.size == 0:
        return build_csr(E, 0), 0, np.zeros(0, np.int64)
    g, row_keys = order_and_build(E, lo, hi, n, reorder=reorder)
    return g, n, row_keys


# --- the device path ---------------------------------------------------------


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
    """``degeneracy_order`` on the device: ``perm[v]`` = rank of ``v`` by
    (coreness, id), and ``kcore.coreness``'s result.  Its CSR is the
    canonical edges' slots grouped by vertex (one sort of the slots' rows;
    the order within a row is free)."""
    src = torch.cat([E_lo, E_hi]).to(torch.int32)
    dst = torch.cat([E_hi, E_lo]).to(torch.int32)
    Es = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    torch.cumsum(torch.bincount(src, minlength=n), 0, dtype=torch.int32,
                 out=Es[1:])
    res = coreness(Es, dst[torch.sort(src).indices])
    order = torch.sort(res.core, stable=True).indices
    perm = torch.empty(n, dtype=torch.int64, device=src.device)
    perm[order] = torch.arange(n, device=src.device)
    return perm, res


def csr_arrays(u: torch.Tensor, v: torch.Tensor, n: int) -> dict:
    """``N``, ``Eid``, ``Es``, ``u`` and ``v`` (int32, on the endpoints'
    device) of the canonical edges ``(u[e], v[e])`` (int64), given in key
    order, so edge ids follow it as in ``build_csr``: ``N`` and ``Eid`` the
    symmetrized ``(src, dst)`` keys sorted with their edge ids, ``Es`` the
    degrees' running sum.  Nothing is downloaded."""
    m = u.shape[0]
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    order = torch.sort(edge_keys(src, dst, n)).indices
    ids = torch.arange(m, dtype=torch.int32, device=u.device)
    Es = torch.cumsum(torch.bincount(src, minlength=n + 1), 0)
    Es = torch.cat([Es.new_zeros(1), Es[:-1]])
    return dict(N=dst[order].to(torch.int32),
                Eid=torch.cat([ids, ids])[order], Es=Es.to(torch.int32),
                u=u.to(torch.int32), v=v.to(torch.int32))


def csr_graph(K: torch.Tensor, n: int, device: torch.device) -> CSRGraph:
    """The CSR graph of the sorted canonical keys ``K`` (on ``device``),
    downloaded, its cache of ``device`` arrays seeded with the tensors:
    ``csr_arrays``, ``El``, and ``Eo``, each row's start plus its
    neighbours below it, which are the edges it ends (``v``).  Equal to
    ``build_csr`` of the keys' edges field for field; the live handle
    (``core/truss_inc.py``) builds every graph of an update batch here."""
    u, v = K // n, K % n
    t = csr_arrays(u, v, n)
    t.update(Eo=(t["Es"][:-1] + torch.bincount(v, minlength=n)).to(
                 torch.int32),
             El=torch.stack([t["u"], t["v"]], dim=1))
    g = CSRGraph(n=n, m=K.shape[0], **{f: t[f].cpu().numpy()
                                       for f in ("Es", "N", "Eid", "El",
                                                 "Eo")})
    g._dev[str(device)] = t
    return g


def preprocess_device(edges, *, reorder: bool = True, device="cuda"):
    """``preprocess`` on ``device``: rows → ``(g, n, row_keys)``, equal to
    it field for field, with ``row_keys`` an int64 tensor on ``device``.

    Spans ``prep.canonical``, ``prep.order`` and ``prep.build`` (``m``),
    and puts the k-core's sub-level count and its blocking reads of the
    device on the enclosing span as ``core_sublevels`` and
    ``core_host_reads`` (1 for the card's one launch, one a sub-level for
    ``peel_cores``).  Raises ``check_edge_array``'s ``ValueError`` on
    rows it rejects.
    """
    device = resolve_device(device)
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
            perm, core = _coreness_perm(E_lo, E_hi, n)
            rl, rh = perm[E_lo], perm[E_hi]
            K = torch.sort(edge_keys(torch.minimum(rl, rh),
                                     torch.maximum(rl, rh), n)).values
            rl, rh = perm[lo], perm[hi]
            row_keys = edge_keys(torch.minimum(rl, rh),
                                 torch.maximum(rl, rh), n)
        trace.set(core_sublevels=core.sublevels,
                  core_host_reads=core.host_reads)
    with trace.span("prep.build", m=K.shape[0]):
        g = csr_graph(K, n, device)
    return g, n, row_keys


# --- the choice --------------------------------------------------------------


def on_device(rows: int, device: torch.device) -> bool:
    """Whether ``prepare`` builds the graph of ``rows`` input rows on
    ``device``: on a CUDA device from ``DEVICE_PREP_MIN_ROWS`` rows, else
    on the host."""
    return device.type == "cuda" and rows >= DEVICE_PREP_MIN_ROWS


def compacts_on_device(survivors: int, device: torch.device) -> bool:
    """Whether the live-edge compaction rebuilds ``survivors`` edges on
    ``device``: on a CUDA device from ``DEVICE_COMPACT_MIN_ROWS``, else on
    the host."""
    return device.type == "cuda" and survivors >= DEVICE_COMPACT_MIN_ROWS


def canonical(edges, device: torch.device) -> tuple[np.ndarray, int]:
    """The rows' unique canonical edges, key-sorted ``(k, 2)`` int64, and
    their id space ``n``: ``canonical_edges_with_rows``'s ``E`` and ``n``,
    found on ``device`` where ``on_device`` says (one ``prep.canonical``
    span, ``m``), else on the host.  Raises ``check_edge_array``'s
    ``ValueError`` on rows it rejects."""
    if not on_device(len(edges), device):
        E, _, _, n = canonical_edges_with_rows(edges)
        return E, n
    with trace.span("prep.canonical"):
        rows, n = _upload(edges, device)
        if rows is None:
            return np.zeros((0, 2), np.int64), 0
        K = torch.unique(edge_keys(torch.minimum(rows[:, 0], rows[:, 1]),
                                   torch.maximum(rows[:, 0], rows[:, 1]), n))
        trace.set(m=K.shape[0])
        return torch.stack([K // n, K % n], dim=1).cpu().numpy(), n


def prepare(edges, *, reorder: bool = True, device: torch.device):
    """Rows → ``(g, n, row_keys)``, on ``device`` where ``on_device`` says
    (``row_keys`` then a tensor there) and on the host otherwise.

    One ``pkt.preprocess`` span: ``on`` "host" or the device's type,
    ``core_sublevels`` and ``core_host_reads`` the device k-core's
    sub-levels and host reads (0 on the host), the path's own spans inside.
    """
    dev = on_device(len(edges), device)
    with trace.span("pkt.preprocess", on=device.type if dev else "host",
                    core_sublevels=0, core_host_reads=0):
        if dev:
            return preprocess_device(edges, reorder=reorder, device=device)
        return preprocess(edges, reorder=reorder)


# --- back to the input rows --------------------------------------------------


def align_to_input(trussness: np.ndarray, g: CSRGraph,
                   edges: np.ndarray | None, n: int, *,
                   keys: np.ndarray | None = None) -> np.ndarray:
    """Map per-``g.El``-row trussness back to the caller's edge order.

    ``edges`` must be the canonical (u<v) edge array ``g`` was built from
    (possibly in a different row order); ``g.El`` rows are lexicographically
    sorted, so each input edge is located by key search.  Callers that
    already hold per-row keys (``u*n + v`` in g's id space) may pass ``keys``
    instead of ``edges``.  A key missing from ``g.El`` raises a descriptive
    ValueError.
    """
    key_g = host_edge_keys(g.El[:, 0], g.El[:, 1], n)
    if keys is None:
        keys = host_edge_keys(edges[:, 0], edges[:, 1], n)
    keys = np.asarray(keys, dtype=np.int64)
    if key_g.shape[0] == 0:
        if keys.shape[0] == 0:
            return np.zeros(0, np.int64)
        raise ValueError(
            f"cannot align {keys.shape[0]} edge(s) to an empty graph")
    pos = np.searchsorted(key_g, keys)
    safe = np.minimum(pos, key_g.shape[0] - 1)
    bad = (pos >= key_g.shape[0]) | (key_g[safe] != keys)
    if bad.any():
        k = int(keys[bad][0])
        raise ValueError(
            f"{int(bad.sum())} edge(s) not present in the graph's edge list; "
            f"first missing: ({k // n}, {k % n})")
    return trussness[pos].astype(np.int64)


def align_device(trussness: np.ndarray, g: CSRGraph, n: int,
                 keys: torch.Tensor, device: torch.device) -> np.ndarray:
    """``align_to_input`` with the row ``keys`` on ``device``: the search
    runs against ``g``'s copy of ``El`` there (``g.device_arrays``), and
    only the answer comes back.  A key missing from ``g.El`` raises
    ``align_to_input``'s ``ValueError``."""
    if g.m == 0 or keys.shape[0] == 0:
        return align_to_input(trussness, g, None, n, keys=keys.cpu().numpy())
    dev = g.device_arrays(device)
    key_g = edge_keys(dev["u"], dev["v"], n)
    pos = torch.searchsorted(key_g, keys)
    found = key_g[pos.clamp_(max=g.m - 1)] == keys
    if not bool(found.all()):
        return align_to_input(trussness, g, None, n, keys=keys.cpu().numpy())
    T = torch.from_numpy(trussness).to(device)
    return T[pos].to(torch.int64).cpu().numpy()


def align(trussness: np.ndarray, g: CSRGraph, n: int, row_keys,
          device: torch.device) -> np.ndarray:
    """``trussness`` per ``g.El`` row → per input row, by ``prepare``'s
    ``row_keys``: ``align_device`` for a tensor, ``align_to_input`` for a
    host array."""
    if isinstance(row_keys, torch.Tensor):
        return align_device(trussness, g, n, row_keys, device)
    return align_to_input(trussness, g, None, n, keys=row_keys)
