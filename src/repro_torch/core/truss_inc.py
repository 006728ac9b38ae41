"""Incremental truss maintenance — local repair instead of full recompute.

The port of the JAX package's ``core/truss_inc.py`` (DESIGN.md §7, §9, §13).
A persistent handle absorbs edge insertions and deletions with repair work
bounded by the *affected region*:

  1. **Persistent triangle state** — besides CSR + trussness + support, a
     handle retains the graph's triangle list, maintained incrementally:
     deletions drop the rows containing a deleted edge, insertions append
     the rows they create (enumerated by the oriented-wedge probe,
     ``kernels/wedge_common``).  Support repair and affected-region search
     are then index operations — no per-update support pass.
  2. **Affected region** — an edge at level k can *drop* only if it is
     triangle-connected in the old graph to a deleted edge through edges
     with ``T >= k`` (deletions batch exactly, by an h-index descent), and
     can *rise* only if triangle-connected in the new graph to an inserted
     edge through edges whose new trussness reaches k+1.  The default
     ``insert_mode="batched"`` repairs a whole insertion batch against one
     merged region under the batch bound ``UB = min(S+2, T+b)``;
     ``insert_mode="sequential"`` keeps the one-at-a-time path as the
     bitwise parity oracle.  ``insert_mode="klevel"`` applies the edges
     one at a time too, each against the region of k-level triangle
     connectivity (Huang et al., SIGMOD 2014): an edge at level k can rise
     only through triangles whose edges all stay at or above k, stepping
     only through edges at level k (``_klevel_region``).  Its bound is
     also capped by the handle's *ceiling*: the trussness of the last
     decomposed graph that still holds every current edge (a subgraph's
     trussness never exceeds its supergraph's), so an edge put back rises
     no higher than it stood, and a level no insertion can lift is not
     searched, the graph's top level included.
  3. **Local re-peel** — the region is re-peeled against a *pinned
     boundary*: exterior triangle partners are seeded at their death level
     ``trussness − 2`` and shielded from decrements.  Regions up to
     ``host_peel_max`` edges run a host-numpy mirror of the sub-level loop;
     larger ones run ``core.pkt.peel_live_subset`` on the device, whose
     "kernel" executor is K2 with the boundary pinned.
  4. **Fallback** — when a region exceeds ``local_frac`` of the edge set,
     the update falls back to the full (support + peel) pipeline — K1 and
     K2 on the card — refreshing all retained state.

Where the port differs from the reference (results are bitwise equal):

  * The triangle list lives on the handle's device, and every pass over it
    runs there as torch ops: the deletion mask and id remaps, the
    edge → triangle incidence (a stable sort, the same permutation as the
    reference's host ``argsort``), the level-filtered BFS (``_tri_bfs``)
    and the h-operator with its descent (``_h_values``, ``_h_descent``).
    The reference runs them as host numpy; at Graph500 scale 17 (36 M
    triangles) one 0.1 % churn batch took 923 s that way on the host of
    an H100 machine (PERF.md).
  * A batch's edge keys, id maps and CSR builds run on the device too
    (``_Batch``, ``prep.csr_graph``), as does the full rebuild's
    preprocessing (``prep.prepare``); the committed CSR, trussness and
    support are downloaded once a batch.  The "batched" and "sequential"
    modes keep their per-edge bookkeeping (bounds, candidate masks) as
    host numpy; "klevel" keeps its batch state on the device.
  * ``triangle_list`` enumerates on the device (``core.triangle_list``'s
    oriented-table probe) and sorts the rows into the reference's order;
    the reference probes a full-adjacency table on the host.

``triangles_through`` (the batch's new triangles) and ``_host_peel`` (the
region peel at or below ``host_peel_max``) stay host numpy, as in the
reference.  The serving layer wraps this in ``TrussEngine.open / update /
close`` (``serve/truss_engine.py``); ``launch/truss.py --update-stream``
replays synthetic churn through it.

Spans (``repro_torch.trace``, one per call): ``inc.update`` (``mode``,
``insert_mode``, ``inserted``, ``deleted``, ``affected``, ``boundary``,
``rounds``), ``inc.delete``, ``inc.search`` (``levels``, ``region``),
``inc.region_peel`` (``on``: "host" or the device's type; ``edges``,
``pinned``), ``inc.csr`` (``on``; a batch's key algebra, each CSR build
and the recount) and ``inc.rebuild`` (``m``; every full rebuild, the one
at construction too).
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import support as support_mod
from repro_torch.core.hierarchy import HIER_MODES, TrussHierarchy
from repro_torch.core import prep
from repro_torch.core.pkt import (_COMPACT_FRAC, _COMPACT_MIN, PEEL_MODES,
                                  peel_live_subset, truss_pkt)
from repro_torch.core.prep import align_to_input
from repro_torch.core.support import check_axis
from repro_torch.core.triangle_list import _triangles_dev
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs.csr import (CSRGraph, build_csr, check_edge_array,
                                    edge_keys)
from repro_torch.kernels import wedge_common
from repro_torch.testing.chaos import fault_point

#: Insertion repair strategies (DESIGN.md §13): ``"batched"`` repairs the
#: whole insertion batch against one merged candidate region; ``"sequential"``
#: applies edges one at a time (the ±1 locality bound) and serves as the
#: bitwise parity oracle for the batched path; ``"klevel"`` applies them one
#: at a time as well, each against its k-level region (``_klevel_region``),
#: and equals "sequential" in trussness, support and triangle rows.
INSERT_MODES = ("sequential", "batched", "klevel")

#: ``core/pkt.py`` itself (``repro_torch.core`` re-exports its ``pkt``
#: function under the module's name): full rebuilds call ``pkt`` through it,
#: so that whatever stands in the module's ``pkt`` is what a handle runs
_pkt_mod = importlib.import_module("repro_torch.core.pkt")


class IntegrityError(RuntimeError):
    """Maintained incremental state failed a consistency check.

    Raised by the pinned-boundary replay invariant in ``_region_peel``
    (before any corrupt trussness could be committed) and by
    :meth:`IncrementalTruss.check_invariants` (after commit, on a sampled
    edge set).  The recovery is to rebuild from the retained CSR
    (:meth:`IncrementalTruss.rebuild`) rather than retry (DESIGN.md §15).
    """


@dataclasses.dataclass(frozen=True)
class UpdateStats:
    """Outcome of one ``IncrementalTruss.update`` call."""

    mode: str            # "noop" | "local" | "full"
    m_before: int
    m_after: int
    inserted: int        # edges actually added (not already present)
    deleted: int         # edges actually removed (were present)
    affected: int        # total edges locally re-peeled across the batch
    boundary: int        # total pinned schedule edges across the batch
    rounds: int          # level-filtered BFS passes executed
    changed: int         # current edges whose trussness is new or different
    seconds: float
    handle: object = None  # set by TrussEngine.update
    coalesced: int = 1   # queued batches merged into this repair (§12)
    insert_mode: str | None = None  # path insertions took (None: no inserts)


def compose_update_batches(batches) -> tuple[np.ndarray, np.ndarray]:
    """Collapse a sequence of update batches into one equivalent batch.

    One ``update`` batch maps ``E → (E − remove) ∪ add`` (set-wise, add
    wins on overlap).  Applying batches ``(a_1, r_1) … (a_k, r_k)`` in order
    equals applying the single batch ``(A, R)`` with ``A`` the surviving
    adds (each ``a_i`` minus every *later* remove) and ``R`` the union of
    all removes (DESIGN.md §12).

    Args:
        batches: iterable of ``(add_edges, remove_edges)`` pairs in arrival
            order; either element may be ``None`` or empty.

    Returns:
        ``(add, remove)`` int64 ``(k, 2)`` canonical edge arrays such that
        one ``update(add_edges=add, remove_edges=remove)`` produces the
        same graph as applying the batches sequentially.

    Raises:
        ValueError: any batch fails edge validation.
    """
    A: set[tuple[int, int]] = set()
    R: set[tuple[int, int]] = set()
    empty = np.zeros((0, 2), np.int64)
    for add, rem in batches:
        a = check_edge_array(add if add is not None else empty)
        r = check_edge_array(rem if rem is not None else empty)
        a_set = {(min(int(u), int(v)), max(int(u), int(v))) for u, v in a}
        r_set = {(min(int(u), int(v)), max(int(u), int(v))) for u, v in r}
        A -= r_set
        A |= a_set
        R |= r_set

    def to_arr(s):
        return np.array(sorted(s), np.int64) if s else empty

    return to_arr(A), to_arr(R)


# --------------------------------------------------------------- triangles --

def wedge_subtable(g: CSRGraph, anchors: np.ndarray) -> support_mod.WedgeTable:
    """Peel-phase wedge table restricted to ``anchors`` (sorted edge ids).

    Same layout and min-degree orientation policy as
    ``support.build_peel_table``, but only the anchor edges get entries; the
    ``off`` array still spans all ``m`` edges (non-anchors carry empty
    ranges).
    """
    anchors = np.asarray(anchors, dtype=np.int64)
    if anchors.size == 0 or g.m == 0:
        return support_mod.WedgeTable(
            e1=np.zeros(0, np.int32), cand_slot=np.zeros(0, np.int32),
            lo=np.zeros(0, np.int32), hi=np.zeros(0, np.int32),
            off=np.zeros(g.m + 1, np.int64))
    Es = g.Es.astype(np.int64)
    deg = Es[1:] - Es[:-1]
    u = g.El[anchors, 0].astype(np.int64)
    v = g.El[anchors, 1].astype(np.int64)
    swap = deg[u] > deg[v]
    cand = np.where(swap, v, u)          # scan this side's full adjacency
    prob = np.where(swap, u, v)          # binary-search this side
    cnt = deg[cand]
    off = np.zeros(g.m + 1, np.int64)
    off[anchors + 1] = cnt
    np.cumsum(off, out=off)
    e1 = np.repeat(anchors, cnt)
    intra = np.arange(int(off[-1]), dtype=np.int64) - off[e1]
    cand_rep = np.repeat(cand, cnt)
    prob_rep = np.repeat(prob, cnt)
    return support_mod.WedgeTable(
        e1=e1.astype(np.int32),
        cand_slot=(Es[cand_rep] + intra).astype(np.int32),
        lo=Es[prob_rep].astype(np.int32),
        hi=Es[prob_rep + 1].astype(np.int32),
        off=off,
    )


def _probe_iters(g: CSRGraph) -> int:
    dmax = int(g.degrees.max(initial=1))
    return max(1, int(np.ceil(np.log2(dmax + 1))) + 1)


def triangles_through(g: CSRGraph,
                      anchors: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Every triangle through each anchor edge, as (anchor, e2, e3) id rows.

    A triangle through an anchor is reported exactly once *per anchor it
    contains*.  Runs on the host (``probe_np``), as in the reference: update
    batches probe small tables of a new shape every call.
    """
    anchors = np.asarray(anchors, dtype=np.int64)
    if anchors.size == 0 or g.m == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    tab = wedge_subtable(g, anchors)
    if tab.size == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    hit, safe = wedge_common.probe_np(
        g.N, tab.cand_slot.astype(np.int64), tab.lo, tab.hi,
        iters=_probe_iters(g))
    return (tab.e1[hit].astype(np.int64),
            g.Eid[tab.cand_slot[hit]].astype(np.int64),
            g.Eid[safe[hit]].astype(np.int64))


def edge_triangles(g: CSRGraph, e: int) -> tuple[np.ndarray, np.ndarray]:
    """The other two edges of every triangle through edge ``e``, as
    ``triangles_through(g, [e])`` gives them (by the third vertex), found
    by intersecting the two endpoints' sorted adjacency rows: work
    O(deg u + deg v), where ``triangles_through`` lays out arrays over all
    ``m`` edges for its table."""
    u, v = int(g.El[e, 0]), int(g.El[e, 1])
    ru = slice(int(g.Es[u]), int(g.Es[u + 1]))
    rv = slice(int(g.Es[v]), int(g.Es[v + 1]))
    _, iu, iv = np.intersect1d(g.N[ru], g.N[rv], assume_unique=True,
                               return_indices=True)
    return (g.Eid[ru][iu].astype(np.int64), g.Eid[rv][iv].astype(np.int64))


def _triangle_rows(g: CSRGraph, device: torch.device) -> torch.Tensor:
    """``triangle_list`` as an int64 (T, 3) tensor on ``device``."""
    if g.m == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=device)
    tri = _triangles_dev(g, device)
    if tri.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=device)
    rows = torch.sort(tri.to(torch.int64), dim=1).values
    El = g.device_arrays(device)["El"].to(torch.int64)
    ua, va = El[rows[:, 0], 0], El[rows[:, 0], 1]
    ub, vb = El[rows[:, 1], 0], El[rows[:, 1], 1]
    w = torch.where((ub == ua) | (ub == va), vb, ub)
    # by (a, w): a stable sort by w, then a stable sort by a
    order = torch.sort(w, stable=True).indices
    order = order[torch.sort(rows[order, 0], stable=True).indices]
    return rows[order]


def triangle_list(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """All triangles of ``g``, each exactly once, as a (T, 3) edge-id array.

    Rows are sorted, and ordered as the reference's list: the reference
    probes the full-adjacency wedge table anchored at every edge and keeps
    each triangle at its lowest member id, so its rows come by that anchor
    ``a`` and, within it, by the scanned third vertex ``w`` (the CSR row
    of the anchor's scan side is sorted).  Here the triangles are
    enumerated on ``device`` (the oriented support-table probe of
    ``core.triangle_list``) and sorted by ``(a, w)``, which is unique per
    triangle.  ``device`` is "cuda" (the default; raises when no card is
    present) or "cpu".
    """
    return _triangle_rows(g, resolve_device(device)).cpu().numpy()


def _ids(x, device: torch.device) -> torch.Tensor:
    """A host id array as an int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(
        device)


def _on(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor on ``device``, dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x) -> np.ndarray:
    """A tensor or a host array as a host array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _where(device: torch.device) -> str:
    """A span's ``on``: "host" for the CPU, else the device's type."""
    return "host" if device.type == "cpu" else device.type


def _distinct(x: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.unique(x)`` for ids in ``[0, n)``: a mark over the ``n``
    slots read back in order where ``x`` is long against ``n`` (no sort of
    ``x``), else the sort.  The switch is not tuned: over 3.8 M slots on an
    H100 either takes under 0.15 ms from 10^4 ids to 10^6."""
    if x.numel() * 16 < n:
        return torch.unique(x)
    mark = torch.zeros(n, dtype=torch.bool, device=x.device)
    mark[x] = True
    return torch.nonzero(mark).view(-1)


def _member(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Whether each of ``q`` is one of the sorted ``keys``."""
    if keys.numel() == 0 or q.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return keys[pos] == q


def _caps(ceiling, K: torch.Tensor, n: int) -> torch.Tensor | None:
    """Each key of ``K``'s trussness under ``ceiling`` (``(n, keys,
    T)``), -1 where the ceiling lacks the key; ``None`` where there is no
    ceiling over the vertex space ``n``."""
    if ceiling is None or ceiling[0] != n or ceiling[1].numel() == 0:
        return None
    _, keys, T = ceiling
    pos = torch.searchsorted(keys, K).clamp_(max=keys.numel() - 1)
    return torch.where(keys[pos] == K, T[pos], -1)


def _merge(a: torch.Tensor, b: torch.Tensor):
    """The sorted union of two disjoint sorted key tensors, and the
    position in it of each key of ``a`` and of ``b``."""
    dev = a.device
    at_a = torch.arange(a.numel(), device=dev) + torch.searchsorted(b, a)
    at_b = torch.arange(b.numel(), device=dev) + torch.searchsorted(a, b)
    K = torch.empty(a.numel() + b.numel(), dtype=torch.int64, device=dev)
    K[at_a] = a
    K[at_b] = b
    return K, at_a, at_b


@dataclasses.dataclass
class _Batch:
    """One update batch's edge-key algebra, on the handle's device.

    ``old`` holds the committed graph's keys (sorted, as its edge ids
    are), ``I`` the keys inserted (not in ``old``) and ``D`` the keys
    deleted (in ``old``, not added back), both sorted.  The phases fill in
    the id maps as they build the graphs: ``keep`` (the old edges that
    stay), ``mid_of_old`` (old id → id after the deletions, -1 where
    deleted), ``new_of_mid`` and ``ins_new`` (mid and inserted ids → ids
    in the new graph) with the new keys ``K``.
    """

    n: int
    old: torch.Tensor
    I: torch.Tensor
    D: torch.Tensor
    keep: torch.Tensor | None = None
    mid_of_old: torch.Tensor | None = None
    K: torch.Tensor | None = None
    new_of_mid: torch.Tensor | None = None
    ins_new: torch.Tensor | None = None

    @classmethod
    def plan(cls, g: CSRGraph, add: np.ndarray, rem: np.ndarray, n: int,
             device: torch.device) -> "_Batch":
        """``E → (E − rem) ∪ add`` over ``g``'s keys: an edge in both
        batches ends up present."""
        dev = g.device_arrays(device)
        old = prep.edge_keys(dev["u"], dev["v"], n)
        add_k = _ids(IncrementalTruss._batch_keys(add, n), device)
        rem_k = _ids(IncrementalTruss._batch_keys(rem, n), device)
        rem_k = rem_k[~_member(add_k, rem_k)]
        return cls(n=n, old=old, I=add_k[~_member(old, add_k)],
                   D=rem_k[_member(old, rem_k)])

    def delete(self) -> torch.Tensor:
        """Fill ``keep`` and ``mid_of_old``; returns the mid keys."""
        keep = torch.ones(self.old.numel(), dtype=torch.bool,
                          device=self.old.device)
        keep[torch.searchsorted(self.old, self.D)] = False
        self.keep = keep
        self.mid_of_old = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
        return self.old[keep]

    def merge(self) -> torch.Tensor:
        """Fill ``K``, ``new_of_mid`` and ``ins_new``; returns ``K``."""
        if self.K is None:
            mid = self.old if self.keep is None else self.old[self.keep]
            self.K, self.new_of_mid, self.ins_new = _merge(mid, self.I)
        return self.K

    def old_to_new(self) -> torch.Tensor:
        """Each old edge's id in the new graph, -1 where deleted."""
        ids = (torch.arange(self.old.numel(), device=self.old.device)
               if self.mid_of_old is None else self.mid_of_old)
        if self.new_of_mid is None:
            return ids
        return torch.where(ids >= 0, self.new_of_mid[ids.clamp(min=0)], -1)


class _Incidence:
    """Edge → triangle-row CSR over a fixed (T, 3) triangle tensor.

    Built and read on the triangle tensor's device: ``off`` (m+1,) and
    ``idx`` (3T,) group the members by a stable sort, the same permutation
    as the reference's host ``argsort(kind="stable")``: each edge's rows in
    ascending order.  A live handle carries it across its batches without
    sorting again: ``deleted``, ``remapped`` and ``appended`` derive the
    incidence of the triangle list each phase builds, equal to a fresh one.
    """

    def __init__(self, tri: torch.Tensor, m: int):
        self.tri = tri
        dev = tri.device
        self.off = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        if tri.numel() == 0:
            self.idx = torch.zeros(0, dtype=torch.int64, device=dev)
            return
        flat = tri.reshape(-1)
        self.off[1:] = torch.cumsum(torch.bincount(flat, minlength=m), 0)
        self.idx = torch.sort(flat, stable=True).indices // 3

    @classmethod
    def _of(cls, tri: torch.Tensor, off: torch.Tensor,
            idx: torch.Tensor) -> "_Incidence":
        inc = cls.__new__(cls)
        inc.tri, inc.off, inc.idx = tri, off, idx
        return inc

    def counts(self) -> torch.Tensor:
        """Each edge's number of rows."""
        return self.off[1:] - self.off[:-1]

    @staticmethod
    def _offsets(cnt: torch.Tensor) -> torch.Tensor:
        off = torch.zeros(cnt.shape[0] + 1, dtype=torch.int64,
                          device=cnt.device)
        off[1:] = torch.cumsum(cnt, 0)
        return off

    def deleted(self, lost: torch.Tensor, keep: torch.Tensor,
                tri: torch.Tensor) -> "_Incidence":
        """The incidence of ``tri``: this list without the ``lost`` rows
        (a mask), renumbered in order, over the edges ``keep`` marks (no
        kept row holds a dropped edge), renumbered in order."""
        row = torch.cumsum(~lost, 0) - 1
        idx = row[self.idx[~lost[self.idx]]]
        gone = torch.bincount(self.tri[lost].reshape(-1),
                              minlength=keep.shape[0])
        return _Incidence._of(tri, self._offsets((self.counts() - gone)[keep]),
                              idx)

    def remapped(self, new_of_old: torch.Tensor, m: int,
                 tri: torch.Tensor) -> "_Incidence":
        """The incidence of ``tri``: the same rows with edge ``e`` renamed
        ``new_of_old[e]`` (increasing) in a space of ``m`` edges."""
        cnt = torch.zeros(m, dtype=torch.int64, device=self.off.device)
        cnt[new_of_old] = self.counts()
        return _Incidence._of(tri, self._offsets(cnt), self.idx)

    def appended(self, side: torch.Tensor, tri: torch.Tensor) -> "_Incidence":
        """The incidence of ``tri``: this list followed by the ``side``
        rows.  Each edge's side rows come after its own (their indices are
        larger), so every entry moves up by the side entries of the edges
        before its own."""
        if side.numel() == 0:
            return _Incidence._of(tri, self.off, self.idx)
        dev = self.off.device
        m = self.off.shape[0] - 1
        flat = side.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        s_edge = flat[order]
        s_cnt = torch.bincount(flat, minlength=m)
        cnt = self.counts()
        off = self._offsets(cnt + s_cnt)
        n_old = self.idx.shape[0]
        owner = torch.repeat_interleave(torch.arange(m, device=dev), cnt,
                                        output_size=n_old)
        idx = torch.empty(n_old + flat.shape[0], dtype=torch.int64,
                          device=dev)
        idx[torch.arange(n_old, device=dev)
            + (off[:-1] - self.off[:-1])[owner]] = self.idx
        rank = torch.arange(flat.shape[0], device=dev) \
            - (torch.cumsum(s_cnt, 0) - s_cnt)[s_edge]
        idx[off[s_edge] + cnt[s_edge] + rank] = \
            self.tri.shape[0] + order // 3
        return _Incidence._of(tri, off, idx)

    def rows_of(self, edges: torch.Tensor) -> torch.Tensor:
        """Triangle-row indices incident to any of ``edges`` (with repeats),
        each edge's rows in ascending order."""
        if edges.numel() == 0 or self.idx.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.off.device)
        start = self.off[edges]
        cnt = self.off[edges + 1] - start
        total = int(cnt.sum())
        pos = torch.repeat_interleave(start - (torch.cumsum(cnt, 0) - cnt),
                                      cnt, output_size=total)
        return self.idx[pos + torch.arange(total, device=pos.device)]


def _tri_bfs(inc: _Incidence, side: torch.Tensor, seeds: torch.Tensor,
             allowed: torch.Tensor) -> torch.Tensor:
    """Edges triangle-reachable from ``seeds`` through ``allowed`` edges.

    Traversal steps through triangles (static ``inc`` rows plus the ``side``
    rows of the in-flight insertion phase) *all three* of whose edges are
    allowed.  Returns the sorted reached edge ids (seeds outside
    ``allowed`` are dropped).  All tensors on one device.
    """
    visited = torch.zeros_like(allowed)
    frontier = _distinct(seeds[allowed[seeds]], allowed.shape[0])
    visited[frontier] = True
    while frontier.numel():
        rows = inc.tri[_distinct(inc.rows_of(frontier), inc.tri.shape[0])]
        if side.numel():
            hit = torch.isin(side, frontier).any(dim=1)
            rows = torch.cat([rows, side[hit]])
        if rows.numel() == 0:
            break
        cand = rows[allowed[rows].all(dim=1)].reshape(-1)
        cand = _distinct(cand[~visited[cand]], visited.shape[0])
        visited[cand] = True
        frontier = cand
    return torch.nonzero(visited).view(-1)


def _partner_min(inc: _Incidence, tau: torch.Tensor, work: torch.Tensor):
    """For each triangle of each edge in ``work``: its owner's index in
    ``work`` and the lower ``tau`` of the other two edges.  Returns
    ``(owner, cnt, pmin)``, ``cnt`` each edge's number of triangles."""
    cnt = inc.off[work + 1] - inc.off[work]
    owner = torch.repeat_interleave(
        torch.arange(work.shape[0], device=work.device), cnt)
    rows = inc.tri[inc.rows_of(work)]
    if rows.numel() == 0:
        return owner, cnt, torch.zeros(0, dtype=tau.dtype, device=tau.device)
    e = work[owner]
    t0, t1, t2 = tau[rows[:, 0]], tau[rows[:, 1]], tau[rows[:, 2]]
    pmin = torch.where(
        rows[:, 0] == e, torch.minimum(t1, t2),
        torch.where(rows[:, 1] == e, torch.minimum(t0, t2),
                    torch.minimum(t0, t1)))
    return owner, cnt, pmin


def _h_values(inc: _Incidence, tau: torch.Tensor,
              work: torch.Tensor) -> torch.Tensor:
    """Truss h-operator for each edge in ``work``: 2 + (largest s such that
    the edge is in >= s triangles whose other two edges both have current
    value >= s + 2).  Vectorized over the incidence structure."""
    h = torch.zeros(work.shape[0], dtype=torch.int64, device=work.device)
    if work.numel() == 0:
        return h
    owner, cnt, pmin = _partner_min(inc, tau, work)
    if pmin.numel():
        # partner-min in rho (= tau - 2) space, per membership
        val = pmin - 2
        # by owner, each owner's values descending (a stable sort by -val,
        # then a stable sort by owner); the order among equal values does
        # not change the maximum below
        order = torch.sort(-val, stable=True).indices
        order = order[torch.sort(owner[order], stable=True).indices]
        owner_s, val_s = owner[order], val[order]
        first = (torch.cumsum(cnt, 0) - cnt)[owner_s]
        rank = torch.arange(owner_s.shape[0], device=work.device) - first
        score = torch.minimum(val_s, rank + 1).clamp(min=0)
        h.scatter_reduce_(0, owner_s, score, reduce="amax")
    return h + 2


def _below(inc: _Incidence, tau: torch.Tensor,
           work: torch.Tensor) -> torch.Tensor:
    """Whether each edge in ``work`` has its h-operator value below its
    ``tau``: fewer than ``tau − 2`` of its triangles have both other edges
    at ``tau`` or above.  A count, where ``_h_values`` sorts."""
    if work.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=work.device)
    owner, _, pmin = _partner_min(inc, tau, work)
    tw = tau[work]
    n_ok = torch.bincount(owner[pmin >= tw[owner]], minlength=work.shape[0])
    return n_ok < tw - 2


def _h_descent(inc: _Incidence, tau: torch.Tensor, seeds: torch.Tensor,
               totals, limit: float) -> bool:
    """Chaotic descent of the truss h-operator from a valid upper bound.

    Exact when ``tau`` starts pointwise >= the true decomposition, which
    holds for pure deletions.  Work is proportional to the edges that
    actually drop plus their triangle neighborhoods.  Mutates ``tau``;
    returns False (request the full-recompute fallback) once more than
    ``limit`` edges have dropped — the local_frac policy.

    A pass counts which of its edges drop (``_below``) and evaluates the
    h-operator for those alone.  It re-evaluates only the dropped edges'
    triangle partners whose
    value lies above the lowest value a dropped edge fell to: a partner
    dropping from ``t`` to ``t' >= tau[f]`` still counts for ``f`` at
    every level up to ``tau[f]``, so ``f`` stays.  Where that leaves no
    edge, the pass that would have found nothing to lower is counted
    all the same, so ``rounds`` reads as without the filter.
    """
    changed = torch.zeros(tau.shape[0], dtype=torch.bool, device=tau.device)
    work = _distinct(seeds, tau.shape[0])
    while work.numel():
        totals["passes"] += 1
        # the h-operator (a sort) only for the edges that drop (a count)
        dropped = work[_below(inc, tau, work)]
        if dropped.numel() == 0:
            break
        h = _h_values(inc, tau, dropped)
        tau[dropped] = h
        changed[dropped] = True
        n_changed = int(changed.sum())
        if n_changed > limit:
            totals["affected"] += n_changed
            return False
        rows = inc.tri[_distinct(inc.rows_of(dropped), inc.tri.shape[0])]
        near = _distinct(rows.reshape(-1), tau.shape[0])
        work = near[tau[near] > h.min()]
        if near.numel() and not work.numel():
            totals["passes"] += 1
            break
    totals["affected"] += int(changed.sum())
    return True


def _klevel_region(inc: _Incidence, side: torch.Tensor, e0: int,
                   T: torch.Tensor, UB: torch.Tensor, totals,
                   limit: float) -> torch.Tensor | None:
    """The edges whose trussness the insertion of ``e0`` can raise, and
    ``e0``: the k-level region (Huang et al., SIGMOD 2014).

    One insertion raises a trussness by at most one, and an edge at level
    ``k = T`` rises only into the new (k+1)-truss H.  A component of such
    risers that touches no triangle of ``e0`` would, with the old
    (k+1)-truss, already have been a (k+1)-truss, so every riser is
    reached from ``e0`` through triangles of H stepping only through
    risers at its own level.  The search follows that: from ``e0``'s
    triangles (``side`` rows) onto each partner at its level k, then
    through any triangle (``inc`` rows and ``side`` rows) whose three
    edges all have ``UB >= k + 1`` (the bound ``min(S + 2, T + 1)``,
    ``e0``'s its h-operator cap, 0 for absent edges: H's triangles pass)
    onto partners with ``T == k``.  Same-level steps keep the levels
    apart, so one traversal serves every level.  A frontier edge is kept
    and expanded only if k − 1 of its triangles pass at its level, as an
    edge of H has k − 1 triangles in H; an edge that fails cannot rise,
    and no triangle through it is one of H's.

    The graph's top level is taken whole instead, where ``e0`` reaches it:
    no edge lies above it, so the search there can only walk the class
    (in a Graph500 scale-18 graph 223,585 edges, one dense component,
    about 17 rounds), while the re-peel settles it as well from the whole
    class, a superset of its risers.

    Returns the region's sorted edge ids (``e0`` among them) on ``T``'s
    device, or ``None`` once it holds more than ``limit`` edges.  Counts
    its rounds in ``totals["passes"]``.
    """
    dev = T.device
    seen = torch.zeros(T.shape[0], dtype=torch.bool, device=dev)
    seen[e0] = True
    region = seen.clone()
    size = 1
    rows0 = side[(side == e0).any(dim=1)]
    cand = rows0.reshape(-1)
    cross = UB[rows0].amin(dim=1).repeat_interleave(3) >= T[cand] + 1
    frontier = _distinct(cand[cross & ~seen[cand]], T.shape[0])
    top = T.max()
    at_top = T[frontier] == top
    if bool(at_top.any()):
        level = T == top
        region |= level
        seen |= level
        size += int(level.sum())
        if size > limit:
            return None
        frontier = frontier[~at_top]
    while frontier.numel():
        totals["passes"] += 1
        seen[frontier] = True
        cnt = inc.off[frontier + 1] - inc.off[frontier]
        owner = torch.repeat_interleave(
            torch.arange(frontier.numel(), device=dev), cnt)
        rows = inc.tri[inc.rows_of(frontier)]
        if side.numel():
            si, sj = torch.nonzero(torch.isin(side, frontier), as_tuple=True)
            rows = torch.cat([rows, side[si]])
            owner = torch.cat([owner,
                               torch.searchsorted(frontier, side[si, sj])])
        k = T[frontier]
        ok = UB[rows].amin(dim=1) >= k[owner] + 1
        riser = torch.bincount(owner[ok], minlength=frontier.numel()) >= k - 1
        region[frontier[riser]] = True
        size += int(riser.sum())
        if size > limit:
            return None
        step = ok & riser[owner]
        cand = rows[step].reshape(-1)
        level = k[owner[step]].repeat_interleave(3)
        frontier = _distinct(cand[(T[cand] == level) & ~seen[cand]],
                             T.shape[0])
    return torch.nonzero(region).view(-1)


# -------------------------------------------------------------- local peel --

def _host_peel(n_loc: int, tri_loc: np.ndarray, S0: np.ndarray,
               live0: np.ndarray, pinned: np.ndarray) -> np.ndarray:
    """Host-numpy mirror of the peel's sub-level fixed point.

    Operates on a compact local edge space (``n_loc`` slots): ``tri_loc``
    holds the region's triangles as local-id rows, ``S0`` the start support
    (pinned edges: their death level), ``live0`` the live slots.  Same
    decrement formulas and tie-break as ``core.pkt``'s peel; the final
    values agree because the peel fixed point is schedule-independent.
    """
    S = S0.astype(np.int64).copy()
    processed = ~live0.copy()
    if tri_loc.size:
        e1 = tri_loc.ravel()
        oth = np.stack([tri_loc[:, [1, 2]], tri_loc[:, [0, 2]],
                        tri_loc[:, [0, 1]]], axis=1).reshape(-1, 2)
        e2, e3 = oth[:, 0], oth[:, 1]
    else:
        e1 = e2 = e3 = np.zeros(0, np.int64)
    while not processed.all():
        l = S[~processed].min()
        inCurr = ~processed & (S == l)
        while inCurr.any():
            valid = inCurr[e1] & ~processed[e2] & ~processed[e3]
            dec2 = valid & (S[e2] > l) & (~inCurr[e3] | (e1 < e3)) \
                & ~pinned[e2]
            dec3 = valid & (S[e3] > l) & (~inCurr[e2] | (e1 < e2)) \
                & ~pinned[e3]
            dec = np.bincount(e2[dec2], minlength=n_loc) \
                + np.bincount(e3[dec3], minlength=n_loc)
            S = np.where(~processed & ~inCurr & (dec > 0),
                         np.maximum(S - dec, l), S)
            processed = processed | inCurr
            inCurr = ~processed & (S == l)
    return S


# --------------------------------------------------------------- the state --

class IncrementalTruss:
    """A decomposed graph that absorbs edge insertions/deletions in place.

    State held across updates: the CSR graph, per-edge trussness *and*
    support (both aligned to ``g.El`` row order, which is canonical-key
    order), the triangle list, and the vertex-id space ``n`` (grows
    monotonically as updates introduce new vertex ids).

    ``update(add_edges=…, remove_edges=…)`` applies one batch:
    ``E_new = (E_old − remove) ∪ add`` (set-wise; an edge in both batches
    ends up present).  Returns :class:`UpdateStats`.

    Args:
        edges: initial (k, 2) integer edge array.
        n: vertex-space size (default: max id + 1; grows with updates).
        mode: peel executor (``core.pkt.PEEL_MODES``; "kernel" — K2 — by
            default) of full rebuilds and of device region peels.
        support_mode: support executor ("kernel" — K1 — by default).
        table_mode: where the torch executors' wedge tables are built.
        hier_mode: community-index builder ("device" / "host", §11).
        insert_mode: insertion repair strategy ("batched" / "sequential" /
            "klevel", §13); bitwise-identical trussness and support.
        chunk: peel chunk size of the torch executors (pow2); ``None``
            derives it from the table size.
        local_frac: affected-region fraction above which an update falls
            back to full recompute.
        host_peel_max: region size ceiling for the host re-peel; larger
            regions run ``peel_live_subset`` on the device.
        compact_frac: live-edge compaction threshold (``None`` disables).
        compact_min: minimum live-edge count for compaction.
        device: "cuda" (the default; raises when no card is present) or
            "cpu", where every "kernel" executor runs its plain version.

    Raises:
        ValueError: unknown mode axis, invalid edge array, or
            out-of-range ``local_frac``.
        RuntimeError: ``device`` is CUDA and no card is present.
    """

    def __init__(self, edges, *, n: int | None = None, mode: str = "kernel",
                 support_mode: str = "kernel", table_mode: str = "device",
                 hier_mode: str = "device", insert_mode: str = "batched",
                 chunk: int | None = None,
                 local_frac: float = 0.25, host_peel_max: int = 4096,
                 compact_frac: float | None = _COMPACT_FRAC,
                 compact_min: int = _COMPACT_MIN, device="cuda"):
        self._configure(mode=mode, support_mode=support_mode,
                        table_mode=table_mode, hier_mode=hier_mode,
                        insert_mode=insert_mode, chunk=chunk,
                        local_frac=local_frac, host_peel_max=host_peel_max,
                        compact_frac=compact_frac, compact_min=compact_min,
                        device=device)
        E, n_seen = prep.canonical(edges, self.device)
        self.n = max(int(n or 0), n_seen)
        self._full_rebuild(E)

    def _configure(self, *, mode, support_mode, table_mode, hier_mode,
                   insert_mode, chunk, local_frac, host_peel_max,
                   compact_frac, compact_min, device) -> None:
        """Validate and store the handle's options (shared by both
        constructors)."""
        check_axis("mode", mode, PEEL_MODES)
        check_axis("support_mode", support_mode, support_mod.SUPPORT_MODES)
        check_axis("table_mode", table_mode, support_mod.TABLE_MODES)
        check_axis("hier_mode", hier_mode, HIER_MODES)
        check_axis("insert_mode", insert_mode, INSERT_MODES)
        if chunk is not None and chunk < 1:
            raise ValueError("chunk must be positive")
        if not 0.0 <= local_frac <= 1.0:
            raise ValueError("local_frac must be in [0, 1]")
        self.device = resolve_device(device)
        self.mode = mode
        self.support_mode = support_mode
        self.table_mode = table_mode
        self.hier_mode = hier_mode
        self.insert_mode = insert_mode
        self._hier: TrussHierarchy | None = None
        #: ``(n, keys, T)``: the last decomposed graph that holds every
        #: current edge, as sorted keys over ``n`` vertices and their
        #: trussness (``_set_ceiling``)
        self._ceiling = None
        self.compact_frac = compact_frac
        self.compact_min = int(compact_min)
        self.chunk = (None if chunk is None
                      else wedge_common.next_pow2(chunk))
        self.local_frac = float(local_frac)
        self.host_peel_max = int(host_peel_max)
        self.stats = {"updates": 0, "local": 0, "full": 0, "noop": 0,
                      "update_seconds": 0.0, "last": None}
        #: region peels by rung: "host" (at or below ``host_peel_max``)
        #: and "device" (``peel_live_subset``)
        self.region_peels = {"host": 0, "device": 0}
        self.open_phases: dict = {}

    @classmethod
    def from_state(cls, edges, trussness, support, triangles, *,
                   n: int | None = None, **options) -> "IncrementalTruss":
        """A handle over an already-decomposed state, with no decomposition.

        Takes the arrays another handle exposes — for example the JAX
        package's ``IncrementalTruss`` (``edges``, ``trussness``,
        ``support``, ``triangles``, ``n``), passed as numpy — so two
        handles can start from one state and take the same batches.
        ``edges`` must be canonical (``u < v`` rows in key order, as
        ``edges`` returns them); ``options`` are the constructor's keyword
        arguments.

        Raises:
            ValueError: non-canonical edges, or arrays whose shapes or
                ids do not fit the edge list.
        """
        inc = cls.__new__(cls)
        inc._configure(**{**dict(
            mode="kernel", support_mode="kernel", table_mode="device",
            hier_mode="device", insert_mode="batched", chunk=None,
            local_frac=0.25, host_peel_max=4096, compact_frac=_COMPACT_FRAC,
            compact_min=_COMPACT_MIN, device="cuda"), **options})
        E = check_edge_array(edges)
        inc.n = max(int(n or 0), int(E.max(initial=-1)) + 1)
        g = build_csr(E, inc.n)
        if not np.array_equal(g.El, E):
            raise ValueError("edges must be canonical: u < v rows, unique, "
                             "in key order")
        T = np.array(trussness, np.int64)        # copies: the handle owns
        S = np.array(support, np.int32)          # its state
        tri = np.asarray(triangles, np.int64).reshape(-1, 3)
        if T.shape != (g.m,) or S.shape != (g.m,):
            raise ValueError(f"trussness and support must be ({g.m},), got "
                             f"{T.shape} and {S.shape}")
        if tri.size and (int(tri.min()) < 0 or int(tri.max()) >= g.m):
            raise ValueError("triangle rows reference edge ids beyond m")
        inc._commit(g, T, S, _ids(tri, inc.device))
        inc._set_ceiling()
        return inc

    # ------------------------------------------------------------ queries --
    @property
    def m(self) -> int:
        """Current canonical edge count."""
        return self.g.m

    @property
    def edges(self) -> np.ndarray:
        """Current canonical (m, 2) int64 edge list (key-sorted)."""
        return self.g.El.astype(np.int64)

    @property
    def trussness(self) -> np.ndarray:
        """Per-edge trussness aligned to ``edges`` rows (int64)."""
        return self.T.copy()

    @property
    def support(self) -> np.ndarray:
        """Per-edge triangle count aligned to ``edges`` rows (int32)."""
        return self.S.copy()

    @property
    def triangles(self) -> np.ndarray:
        """Current (T, 3) triangle list (edge-id rows, each once).  The
        handle keeps it on its device; this is a host copy."""
        return self.tri.to("cpu", copy=True).numpy()

    def edge_ids(self, edges) -> np.ndarray:
        """Canonical row ids of specific edges, aligned to the given rows.

        Rows may be endpoint-swapped or duplicated; an edge not currently in
        the graph raises the descriptive ``align_to_input`` ValueError.
        """
        rows = check_edge_array(edges)
        if rows.size == 0:
            return np.zeros(0, np.int64)
        lo = np.minimum(rows[:, 0], rows[:, 1])
        hi = np.maximum(rows[:, 0], rows[:, 1])
        if int(rows.max()) >= self.n:
            i = int(np.argmax(hi >= self.n))
            raise ValueError(
                f"edge ({int(lo[i])}, {int(hi[i])}) not present in the "
                f"graph's edge list (vertex id beyond the graph)")
        return align_to_input(np.arange(self.g.m, dtype=np.int64), self.g,
                              None, self.n, keys=edge_keys(lo, hi, self.n))

    def query(self, edges) -> np.ndarray:
        """Trussness for specific edges, aligned to the given rows."""
        return self.T[self.edge_ids(edges)]

    def hierarchy(self, *, mode: str | None = None) -> TrussHierarchy:
        """The community index over the current decomposition (lazy, cached).

        Built from the handle's own trussness + maintained triangle list on
        first access; levels materialize lazily inside the index.  The
        cache survives *local* ``update`` batches (untouched levels are
        id-remapped, repaired levels come back dirty — see
        ``_hier_update``) and is dropped whole by full rebuilds.  ``mode``
        overrides the handle's ``hier_mode``: a *different* mode returns a
        standalone (uncached) index, so parity-oracle reads never evict the
        serving cache.
        """
        mode = self.hier_mode if mode is None else mode
        check_axis("mode", mode, HIER_MODES)
        if mode != self.hier_mode:
            return TrussHierarchy(self.T, self.triangles, mode=mode,
                                  device=self.device)
        if self._hier is None:
            self._hier = TrussHierarchy(self.T, self.triangles, mode=mode,
                                        device=self.device)
        return self._hier

    # ------------------------------------------------------------- update --
    def update_many(self, batches, *,
                    insert_mode: str | None = None) -> UpdateStats:
        """Apply several update batches as one composed repair.

        Args:
            batches: iterable of ``(add_edges, remove_edges)`` pairs in
                arrival order (either element may be ``None``).
            insert_mode: per-call override of the handle's insertion
                strategy (``None``: use the handle default).

        Returns:
            The :class:`UpdateStats` of the single composed ``update``,
            with ``coalesced`` set to the number of merged batches.  The
            final state is bitwise-identical to applying the batches one
            at a time (see :func:`compose_update_batches`).

        Raises:
            ValueError: any batch fails edge validation.
        """
        batches = list(batches)
        add, rem = compose_update_batches(batches)
        st = self.update(add_edges=add, remove_edges=rem,
                         insert_mode=insert_mode)
        st = dataclasses.replace(st, coalesced=max(1, len(batches)))
        self.stats["last"] = st
        return st

    def update(self, add_edges=None, remove_edges=None, *,
               insert_mode: str | None = None) -> UpdateStats:
        """Apply one insert/delete batch: ``E → (E − remove) ∪ add``.

        Args:
            add_edges: ``(k, 2)`` integer edge array to insert (either
                endpoint order; duplicates collapse; inserting a present
                edge is a no-op for that row).  ``None`` means none.
            remove_edges: ``(k, 2)`` integer edge array to delete (removing
                an absent edge is a no-op for that row).  An edge in both
                batches ends up present.
            insert_mode: per-call override of the handle's insertion
                strategy (``None``: use the handle default).

        Returns:
            :class:`UpdateStats` — ``mode`` reports whether the batch was
            absorbed by local repair (``"local"``), fell back to a full
            recompute (``"full"``), or changed nothing (``"noop"``).

        Raises:
            ValueError: edge arrays fail validation, or unknown
                ``insert_mode``.
            IntegrityError: the region re-peel broke its replay invariant
                (the committed state is left untouched).
        """
        t0 = time.perf_counter()
        imode = self.insert_mode if insert_mode is None else insert_mode
        check_axis("insert_mode", imode, INSERT_MODES)
        add = check_edge_array(add_edges if add_edges is not None
                               else np.zeros((0, 2), np.int64))
        rem = check_edge_array(remove_edges if remove_edges is not None
                               else np.zeros((0, 2), np.int64))
        hi_seen = max(int(add.max(initial=-1)), int(rem.max(initial=-1)))
        if hi_seen >= self.n:
            self.n = hi_seen + 1          # vertex space grows monotonically
        with trace.span("inc.update", insert_mode=imode):
            st = self._update(add, rem, imode, t0)
            trace.set(mode=st.mode, inserted=st.inserted, deleted=st.deleted,
                      affected=st.affected, boundary=st.boundary,
                      rounds=st.rounds)
        return st

    def _update(self, add, rem, imode, t0) -> UpdateStats:
        """``update`` on checked rows, inside its ``inc.update`` span."""
        dev = self.device
        m_before = self.g.m
        with trace.span("inc.csr", on=_where(dev)):
            batch = _Batch.plan(self.g, add, rem, self.n, dev)
            n_ins, n_del = batch.I.numel(), batch.D.numel()
        totals = {"affected": 0, "boundary": 0, "passes": 0}
        T_old_np = self.T       # for the changed count (old-id space)

        def done(mode, T_new=None):
            changed = 0
            if mode != "noop":
                with trace.span("inc.csr", on=_where(dev)):
                    old_to_new = batch.old_to_new()
                    ok = old_to_new >= 0
                    T_new = _on(self.T if T_new is None else T_new, dev)
                    changed = int((T_new[old_to_new[ok]] != T_old[ok]).sum()
                                  ) + n_ins
                    if mode == "local" and self._hier is not None:
                        self._hier_update(
                            _host(old_to_new), T_old_np,
                            _host(batch.ins_new) if n_ins
                            else np.zeros(0, np.int64))
            st = UpdateStats(
                mode=mode, m_before=m_before, m_after=self.g.m,
                inserted=n_ins, deleted=n_del,
                affected=totals["affected"], boundary=totals["boundary"],
                rounds=totals["passes"], changed=changed,
                seconds=time.perf_counter() - t0,
                insert_mode=imode if (n_ins and mode != "noop") else None)
            self.stats["updates"] += 1
            self.stats[mode] += 1
            self.stats["update_seconds"] += st.seconds
            self.stats["last"] = st
            return st

        if n_ins == 0 and n_del == 0:
            return done("noop")

        limit = self.local_frac * max(1, m_before - n_del + n_ins)
        T_old, S_old = self._device_state()

        def fallback():
            with trace.span("inc.csr", on=_where(dev)):
                K = batch.merge()
                E_new = _host(torch.stack([K // batch.n, K % batch.n], 1))
            self._full_rebuild(E_new)
            return done("full")

        # Both phases build the next state off to the side and it is
        # committed exactly once, after the whole batch has succeeded — an
        # exception mid-repair leaves the handle untouched (§13).
        state = (self.g, T_old, S_old, self.tri, self._incidence())

        # ---------------- phase D: all deletions as one exact batch -------
        if n_del:
            with trace.span("inc.delete"):
                state = self._apply_deletions(batch, T_old, S_old, limit,
                                              totals)
            if state is None:
                return fallback()

        # ---------------- phase I: insertions -----------------------------
        if n_ins:
            state = self._apply_insertions(state, batch, limit, totals,
                                           imode)
            if state is None:
                return fallback()

        self._commit(*state)
        if n_ins:
            caps = _caps(self._ceiling, batch.I, batch.n)
            if caps is None or bool((caps < 0).any()):
                self._set_ceiling()     # an edge from outside it
        return done("local", state[1])

    # ------------------------------------------------------- deletion phase --
    def _apply_deletions(self, batch: _Batch, T_old, S_old, limit, totals):
        """G → G − D, built off to the side (committed state untouched).

        Returns the repaired ``(g, T, S, tri, incidence)`` state tuple
        (``T``, ``S`` and ``tri`` on the handle's device), or ``None`` to
        request full fallback.  The id maps, the CSR build, the triangle
        list's passes, its incidence (derived from the committed one) and
        the h-descent run on the handle's device.
        """
        tri_old = self.tri
        dev = self.device
        with trace.span("inc.csr", on=_where(dev)):
            g_mid = prep.csr_graph(batch.delete(), batch.n, dev)
        keep, mid_of_old = batch.keep, batch.mid_of_old
        m_mid = g_mid.m

        # triangle list and support delta (each lost row exactly once)
        lost_mask = (~keep)[tri_old].any(dim=1)
        lost = tri_old[lost_mask]
        tri_mid = mid_of_old[tri_old[~lost_mask]]
        S_mid = S_old[keep]
        seeds = torch.zeros(0, dtype=torch.int64, device=dev)
        if lost.numel():
            members = lost.reshape(-1)
            seeds = mid_of_old[members[keep[members]]]
            S_mid = S_mid - torch.bincount(seeds, minlength=m_mid)
        T_mid = T_old[keep]
        inc_mid = self._incidence().deleted(lost_mask, keep, tri_mid)

        # Deletions only lower trussness, so the old values bound the new
        # decomposition from above and the local h-index descent repairs
        # exactly, discovering the affected set lazily.
        if seeds.numel():
            if torch.unique(seeds).numel() > limit:
                return None         # repair would touch too much: recompute
            if not _h_descent(inc_mid, T_mid, seeds, totals, limit):
                return None         # descent cascaded past local_frac
        return g_mid, T_mid, S_mid, tri_mid, inc_mid

    # ------------------------------------------------------ insertion phase --
    def _apply_insertions(self, state, batch: _Batch, limit, totals,
                          insert_mode):
        """G → G + I, built off to the side (committed state untouched).

        Builds the one new CSR, maps the mid-state values into the new edge
        space, and dispatches on ``insert_mode``.  Returns the repaired
        ``(g, T, S, tri, incidence)`` state tuple, or ``None`` to request
        full fallback.
        """
        _, T_mid, S_mid, tri_mid, inc_mid = state
        dev = self.device
        with trace.span("inc.csr", on=_where(dev)):
            g_new = prep.csr_graph(batch.merge(), batch.n, dev)
        new_of_mid, ins_new = batch.new_of_mid, batch.ins_new
        m_new = g_new.m

        T_cur = torch.full((m_new,), -1, dtype=torch.int64, device=dev)
        T_cur[new_of_mid] = T_mid
        S_cur = torch.zeros(m_new, dtype=torch.int64, device=dev)
        S_cur[new_of_mid] = S_mid
        present = torch.zeros(m_new, dtype=torch.bool, device=dev)
        present[new_of_mid] = True

        tri_static = new_of_mid[tri_mid]
        inc_static = inc_mid.remapped(new_of_mid, m_new, tri_static)
        if insert_mode == "klevel":
            side_rows = self._insert_klevel(
                g_new, inc_static, ins_new, T_cur, S_cur, present, limit,
                totals, _caps(self._ceiling, batch.K, batch.n))
        else:
            insert = (self._insert_batched if insert_mode == "batched"
                      else self._insert_sequential)
            T_cur, S_cur = _host(T_cur), _host(S_cur)
            side_rows = insert(g_new, inc_static, _host(ins_new), T_cur,
                               S_cur, _host(present), limit, totals)
        if side_rows is None:
            return None
        side_rows = _on(side_rows, dev)
        tri_new = torch.cat([tri_static, side_rows])
        return (g_new, T_cur, S_cur, tri_new,
                inc_static.appended(side_rows, tri_new))

    def _level_regions(self, inc_static, side, seeds, T_cur, UB, present,
                       k_cap, limit, totals):
        """The level-filtered candidate region of an insertion step: for
        each level k up to ``k_cap`` (ascending), the edges at level k that
        the BFS from ``seeds`` reaches through ``{UB >= k+1}``.  Returns
        the candidate mask, or ``None`` once it passes ``limit``."""
        dev = self.device
        side_t, seeds_t = _ids(side, dev), _ids(seeds, dev)
        cand = np.zeros(T_cur.shape[0], bool)
        with trace.span("inc.search", levels=0, region=0):
            for k in np.unique(T_cur[present & (T_cur >= 2)]):
                if k > k_cap:
                    break
                allowed = torch.from_numpy(UB >= k + 1).to(dev)
                totals["passes"] += 1
                reach = _tri_bfs(inc_static, side_t, seeds_t,
                                 allowed).cpu().numpy()
                cand[reach[T_cur[reach] == k]] = True
                size = int(cand.sum())
                trace.set(levels=int(k), region=size)
                if size > limit:
                    return None
        return cand

    def _h_cap(self, side: np.ndarray, edges: np.ndarray, UB: np.ndarray,
               m: int) -> np.ndarray:
        """Upper bounds on the inserted edges' new trussness: each one's
        h-operator value under the per-edge upper bounds ``UB`` (h is
        monotone in partner values, so this dominates the true value).  An
        inserted edge sits in no static triangle, only in ``side`` rows."""
        dev = self.device
        return _h_values(_Incidence(_ids(side, dev).reshape(-1, 3), m),
                         _ids(UB, dev), _ids(edges, dev)).cpu().numpy()

    def _insert_sequential(self, g_new, inc_static, ins_new, T_cur, S_cur,
                           present, limit, totals):
        """One pinned-boundary re-peel per inserted edge (the parity oracle).

        Mutates ``T_cur``/``S_cur``/``present`` in the new edge space;
        returns the accumulated new triangle rows, or ``None`` to request
        full fallback.
        """
        side_rows = np.zeros((0, 3), np.int64)

        for e_i in ins_new:
            present[e_i] = True
            # triangles gained by this one insertion (partners must already
            # be present — triangles with a not-yet-inserted edge are born
            # later, at that edge's own step)
            p2, p3 = edge_triangles(g_new, e_i)
            keep = present[p2] & present[p3]
            p2, p3 = p2[keep], p3[keep]
            S_cur[e_i] += p2.shape[0]
            np.add.at(S_cur, p2, 1)
            np.add.at(S_cur, p3, 1)
            if p2.size:
                rows = np.sort(np.stack(
                    [np.full(p2.shape[0], e_i, np.int64), p2, p3], axis=1),
                    axis=1)
                side_rows = np.concatenate([side_rows, rows])

            # affected region: one insertion moves any trussness by at most
            # one, so UB = min(S+2, T+1); the levels to scan are capped by
            # e_i's own h-operator value under UB.
            UB = np.where(T_cur >= 0,
                          np.minimum(S_cur + 2, T_cur + 1), S_cur + 2)
            UB[~present] = 0             # absent edges block every path
            k_cap = int(self._h_cap(side_rows, np.array([e_i]), UB,
                                    g_new.m)[0]) - 1
            cand = self._level_regions(inc_static, side_rows,
                                       np.array([e_i]), T_cur, UB, present,
                                       k_cap, limit, totals)
            if cand is None:
                return None
            cand[e_i] = True
            A = np.nonzero(cand)[0]
            if A.size > limit or totals["affected"] + A.size > limit:
                return None    # cumulative local work past paying: recompute
            tau = self._region_peel(g_new, inc_static, side_rows, A, S_cur,
                                    T_cur, totals, live_mask=present)
            T_cur[A] = tau

        return side_rows

    def _insert_klevel(self, g_new, inc_static, ins_new, T_cur, S_cur,
                       present, limit, totals, caps=None):
        """One insertion at a time, in key order, each against its k-level
        region (``_klevel_region``), on one shared batch state.

        Each inserted edge goes present, its triangles with present
        partners append as ``side`` rows and add to the support, as in
        ``_insert_sequential``; its bound is the single-insertion one, ``UB
        = min(S + 2, T + 1)``, its own capped by its h-operator value.
        ``caps`` (``_caps``: each new edge's trussness under the ceiling,
        -1 where it has none) caps every bound while the graph stays under
        the ceiling, up to the first insertion from outside it.  The
        region is re-peeled with its exterior pinned.  ``T_cur``, ``S_cur``
        and ``present`` are tensors on the handle's device and are mutated;
        returns the new triangle rows there (in ``_insert_sequential``'s
        order), or ``None`` to request full fallback.
        """
        dev = self.device
        m = g_new.m
        side = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        under = ([False] * ins_new.numel() if caps is None
                 else (caps[ins_new] >= 0).tolist())
        for e_i, capped in zip(ins_new.tolist(), under):
            # one edge from outside the ceiling lifts it for the batch
            caps = caps if capped else None
            present[e_i] = True
            p2, p3 = (_ids(x, dev) for x in edge_triangles(g_new, e_i))
            keep = present[p2] & present[p3]
            p2, p3 = p2[keep], p3[keep]
            S_cur[e_i] += p2.numel()
            S_cur.index_add_(0, p2, torch.ones_like(p2))
            S_cur.index_add_(0, p3, torch.ones_like(p3))
            rows = torch.sort(torch.stack([torch.full_like(p2, e_i), p2, p3],
                                          dim=1), dim=1).values
            side = torch.cat([side, rows])

            UB = torch.where(T_cur >= 0, torch.minimum(S_cur + 2, T_cur + 1),
                             S_cur + 2)
            if caps is not None:
                UB = torch.minimum(UB, caps)
            UB[~present] = 0             # absent edges block every path
            e_t = torch.tensor([e_i], device=dev)
            UB[e_i] = torch.minimum(_h_values(_Incidence(rows, m), UB, e_t),
                                    UB[e_t])[0]
            with trace.span("inc.search", levels=0, region=0):
                A = _klevel_region(inc_static, side, e_i, T_cur, UB, totals,
                                   limit)
                if A is not None:
                    trace.set(levels=int(torch.unique(T_cur[A]).numel()) - 1,
                              region=A.numel())
            if A is None or totals["affected"] + A.numel() > limit:
                return None    # cumulative local work past paying: recompute
            tau = self._region_peel(g_new, inc_static, side, A, S_cur, T_cur,
                                    totals, live_mask=present, settled=True)
            T_cur[A] = _ids(tau, dev)
        return side

    def _insert_batched(self, g_new, inc_static, ins_new, T_cur, S_cur,
                        present, limit, totals):
        """All insertions as one repair: one merged candidate region (§13).

        Every inserted edge goes present at once, the batch's new triangles
        land as one deduplicated support delta, and the per-edge
        level-filtered BFS regions merge by seeding every inserted edge into
        the *same* traversal under the batch bound ``UB = min(S + 2, T +
        b)``.  Mutates ``T_cur``/``S_cur``/``present``; returns the new
        triangle rows, or ``None`` to request full fallback.
        """
        present[ins_new] = True

        # triangles born with the batch, each exactly once (sort + unique
        # dedupes triangles with several inserted members)
        a, p2, p3 = triangles_through(g_new, ins_new)
        keep = present[p2] & present[p3]
        a, p2, p3 = a[keep], p2[keep], p3[keep]
        if a.size:
            side_rows = np.unique(
                np.sort(np.stack([a, p2, p3], axis=1), axis=1), axis=0)
            np.add.at(S_cur, side_rows[:, 0], 1)
            np.add.at(S_cur, side_rows[:, 1], 1)
            np.add.at(S_cur, side_rows[:, 2], 1)
        else:
            side_rows = np.zeros((0, 3), np.int64)

        b = int(ins_new.shape[0])
        UB = np.where(T_cur >= 0, np.minimum(S_cur + 2, T_cur + b), S_cur + 2)
        UB[~present] = 0
        k_cap = int(self._h_cap(side_rows, ins_new, UB, g_new.m)
                    .max(initial=2)) - 1
        cand = self._level_regions(inc_static, side_rows, ins_new, T_cur, UB,
                                   present, k_cap, limit, totals)
        if cand is None:
            return None
        cand[ins_new] = True
        A = np.nonzero(cand)[0]
        if A.size > limit or totals["affected"] + A.size > limit:
            return None        # merged region past paying: recompute
        tau = self._region_peel(g_new, inc_static, side_rows, A, S_cur,
                                T_cur, totals, live_mask=present)
        T_cur[A] = tau
        return side_rows

    # ------------------------------------------------------------ region peel --
    def _region_peel(self, g: CSRGraph, inc: _Incidence, side, A, S_vec,
                     T_fix, totals, live_mask=None, settled: bool = False):
        """Re-peel region ``A`` (sorted edge ids) with its exterior triangle
        partners pinned at their known death level.  Returns the new peel
        values + 2 for ``A`` (same order), a host array.  ``live_mask``
        masks absent edges (insertion phase).  ``side``, ``A``, ``S_vec``,
        ``T_fix`` and ``live_mask`` are host arrays or tensors; the rows,
        the boundary and the gathers run on the handle's device.  Regions
        up to ``host_peel_max`` edges (with their boundary) run the host
        mirror; larger ones ``peel_live_subset`` (the kernel executor on a
        card from ``prep.DEVICE_COMPACT_MIN_ROWS`` edges:
        ``pkt.peel_rows_device``, from the device's copies), K2 with the
        boundary pinned on the kernel path.  One ``inc.region_peel`` span
        (``on``, ``edges``, ``pinned``).

        With ``settled`` (an insertion, whose region's trussness can only
        rise from ``T_fix``), a triangle with an exterior edge of
        trussness below every region member's ``T_fix`` (2 for a new edge)
        is left out, and its members' start S lowered: that edge belongs
        to no truss that decides a member's value, so neither does the
        triangle, and the values come out the same with a smaller
        boundary."""
        m = g.m
        dev = self.device
        with trace.span("inc.region_peel"):
            A_t = _on(A, dev)
            in_A = torch.zeros(m, dtype=torch.bool, device=dev)
            in_A[A_t] = True
            rows = inc.tri[_distinct(inc.rows_of(A_t), inc.tri.shape[0])]
            side_t = _on(side, dev).reshape(-1, 3)
            if side_t.numel():
                rows = torch.cat([rows, side_t[in_A[side_t].any(dim=1)]])
            if live_mask is not None and rows.numel():
                rows = rows[_on(live_mask, dev)[rows].all(dim=1)]
            T_all = _on(T_fix, dev)
            S_all = _on(S_vec, dev)
            drop = None
            if settled and rows.numel():
                T_rows = T_all[rows]
                ext = ~in_A[rows]
                big = torch.iinfo(T_rows.dtype).max
                drop = (torch.where(ext, T_rows, big).amin(dim=1)
                        < torch.where(ext, big, T_rows.clamp(min=2))
                        .amin(dim=1))
            flat = (rows if drop is None else rows[~drop]).reshape(-1)
            boundary = _distinct(flat[~in_A[flat]], m)
            L = _distinct(torch.cat([A_t, boundary]), m)
            if drop is not None:
                # a left-out triangle whose edges all stay in the local edge
                # space is one of its triangles all the same (the device
                # rung peels every triangle among those edges): keep it
                in_L = torch.zeros(m, dtype=torch.bool, device=dev)
                in_L[L] = True
                drop &= ~in_L[rows].all(dim=1)
                gone = rows[drop][~ext[drop]]
                S_all = S_all - torch.bincount(gone, minlength=m)
                rows = rows[~drop]
            n_A, n_b, n_L = A_t.numel(), boundary.numel(), L.numel()
            totals["affected"] += n_A
            totals["boundary"] += n_b

            on_host = n_L <= self.host_peel_max
            trace.set(on="host" if on_host else dev.type, edges=n_A,
                      pinned=n_b)
            chaos = fault_point("region",
                                rung="host" if on_host else self.mode)
            pinned = ~in_A[L]
            T_L = T_all[L]
            S0 = torch.where(pinned, T_L - 2, S_all[L])
            pinned_np, L_np = _host(pinned), _host(L)
            if on_host:
                # compact host path: local ids preserve the global id order,
                # so the tie-break picks the same winners
                lmap = torch.full((m,), -1, dtype=torch.int64, device=dev)
                lmap[L] = torch.arange(n_L, device=dev)
                S_fin = _host_peel(n_L, _host(lmap[rows]), _host(S0),
                                   np.ones(n_L, bool), pinned_np)
            elif self.mode == "kernel" and prep.compacts_on_device(n_L, dev):
                # larger regions reuse the live-edge compaction machinery:
                # the region is gathered into a compacted edge space — work
                # bounded by |L|, not m — with boundary edges pinned at their
                # death level; built on the card from its copy of the edges
                S_fin = _pkt_mod.peel_rows_device(
                    g.device_arrays(dev)["El"][L].to(torch.int64), S0,
                    pinned, compact_frac=self.compact_frac,
                    compact_min=self.compact_min)
            else:
                S_fin = peel_live_subset(
                    g.El, L_np, _host(S0), pinned_np, chunk=self.chunk,
                    mode=self.mode, table_mode=self.table_mode,
                    compact_frac=self.compact_frac,
                    compact_min=self.compact_min, device=dev)
            tau_L = S_fin.astype(np.int64) + 2
            self.region_peels["host" if on_host else "device"] += 1
            if chaos == "corrupt" and n_b:
                # injected corruption (testing/chaos.py): bump one pinned
                # slot so the replay invariant below is guaranteed to trip,
                # without ever letting a wrong value reach committed state
                tau_L = tau_L.copy()
                tau_L[np.searchsorted(L_np, int(boundary[0]))] += 1
            # replay invariant: pinned edges must die exactly at their
            # schedule.  A real raise (not an assert, which -O strips): a
            # violation means the re-peel would commit corrupt trussness
            # into the handle.
            if not np.array_equal(tau_L[pinned_np], _host(T_L[pinned])):
                raise IntegrityError(
                    "incremental re-peel integrity violation: a pinned "
                    "boundary edge left its death level — please report "
                    "this graph")
            return tau_L[np.searchsorted(L_np, _host(A_t))]

    # ---------------------------------------------------------- internals --
    def _hier_update(self, old_to_new: np.ndarray, T_old: np.ndarray,
                     ins_new: np.ndarray) -> None:
        """Carry the community index across a *local* repair (DESIGN.md §11).

        ``old_to_new`` maps each old edge id to its new one (-1: deleted),
        ``ins_new`` holds the inserted edges' new ids.  ``k_hi`` is the
        maximum trussness involved in any insertion, deletion, or trussness
        change (old or new value).  Levels above ``k_hi`` keep their exact
        partition — only edge ids shifted — so they are remapped in O(m);
        levels at or below come back dirty and rebuild lazily on next
        query.
        """
        if self.g.m == 0 or self._hier is None:
            self._hier = None
            return
        ok = old_to_new >= 0
        k_hi = 1
        if (~ok).any():                      # deletions: old death levels
            k_hi = max(k_hi, int(T_old[~ok].max()))
        t_new = self.T[old_to_new[ok]]
        t_old = T_old[ok]
        diff = t_new != t_old
        if diff.any():                       # changed: both old and new
            k_hi = max(k_hi, int(t_old[diff].max()), int(t_new[diff].max()))
        if ins_new.size:                     # insertions: their new levels
            k_hi = max(k_hi, int(self.T[ins_new].max()))
        self._hier = self._hier.remapped(self.T, self.triangles, old_to_new,
                                         k_hi)

    @staticmethod
    def _batch_keys(batch: np.ndarray, n: int) -> np.ndarray:
        if batch.size == 0:
            return np.zeros(0, np.int64)
        lo = np.minimum(batch[:, 0], batch[:, 1])
        hi = np.maximum(batch[:, 0], batch[:, 1])
        return np.unique(edge_keys(lo, hi, n))

    def _commit(self, g_new: CSRGraph, T_new, S_new, tri_new: torch.Tensor,
                inc: _Incidence | None = None) -> None:
        """Make ``(g, T, S, tri)`` the handle's state.  ``T`` and ``S`` come
        as host arrays or tensors and are kept on the host; tensors on the
        handle's device are kept as its device copies too, which the next
        batch starts from (``check_invariants`` drops them, so the next
        batch starts from the host state it checked).  ``inc``, the
        incidence of ``tri``, is kept for the next batch."""
        self.g = g_new
        self.T = _host(T_new).astype(np.int64, copy=False)
        self.S = _host(S_new.to(torch.int32) if isinstance(
            S_new, torch.Tensor) else S_new).astype(np.int32, copy=False)
        #: the (T, 3) int64 triangle list, kept on the handle's device
        self.tri = tri_new.to(self.device, torch.int64)
        self._inc = inc if inc is not None and inc.tri is tri_new else None
        on_dev = (isinstance(T_new, torch.Tensor)
                  and T_new.device == self.device)
        self._dev_TS = ((T_new, S_new.to(torch.int64)) if on_dev
                        and isinstance(S_new, torch.Tensor) else None)

    def _set_ceiling(self) -> None:
        """Make the committed graph the handle's ceiling: its keys and a
        copy of its trussness on the handle's device.  Set at every full
        rebuild and after every batch that inserts an edge the ceiling
        lacks; deletions keep the graph under it."""
        arr = self.g.device_arrays(self.device)
        self._ceiling = (self.n, prep.edge_keys(arr["u"], arr["v"], self.n),
                         self._device_state()[0].clone())

    def _device_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Trussness and support as int64 tensors on the handle's device:
        the copies the last batch committed, or uploaded."""
        if self._dev_TS is None:
            self._dev_TS = (_ids(self.T, self.device),
                            torch.from_numpy(self.S).to(self.device).to(
                                torch.int64))
        return self._dev_TS

    def _incidence(self) -> _Incidence:
        """The edge → triangle-row incidence of the committed triangle
        list: the one the last batch derived, or built (a sort)."""
        if self._inc is None or self._inc.tri is not self.tri:
            self._inc = _Incidence(self.tri, self.g.m)
        return self._inc

    def _full_rebuild(self, E: np.ndarray) -> None:
        """From-scratch decomposition of the canonical key-sorted edges
        ``E`` through the one-shot path: ``prep.prepare`` (on the card from
        ``prep.DEVICE_PREP_MIN_ROWS`` rows), ``pkt`` (K1 and the fused loop
        on the card under the default executors) and ``prep.align``.  The
        handle's own CSR (vertex ids as given) is built where the
        preprocessing runs.  One ``inc.rebuild`` span (``m``)."""
        self._hier = None        # full rebuild: community index rebuilt lazily
        dev = self.device
        with trace.span("inc.rebuild", m=len(E)):
            t0 = time.perf_counter()
            if len(E) and prep.on_device(len(E), dev):
                E_t = _ids(E, dev)
                g = prep.csr_graph(prep.edge_keys(E_t[:, 0], E_t[:, 1],
                                                  self.n), self.n, dev)
            else:
                g = build_csr(E, self.n)
            if g.m == 0:
                self.open_phases = {}
                self._commit(g, np.zeros(0, np.int64), np.zeros(0, np.int32),
                             _triangle_rows(g, dev))
                self._set_ceiling()
                return
            # row_keys: each row of E (= g.El) in the relabelled id space
            gr, n, row_keys = prep.prepare(E, device=dev)
            t_prep = time.perf_counter() - t0
            res = _pkt_mod.pkt(
                gr, chunk=self.chunk, mode=self.mode,
                support_mode=self.support_mode, table_mode=self.table_mode,
                compact_frac=self.compact_frac, compact_min=self.compact_min,
                phase_timings=True, device=dev)
            T = prep.align(res.trussness, gr, n, row_keys, dev)
            S = prep.align(res.support, gr, n, row_keys, dev)
            t0 = time.perf_counter()
            tri = _triangle_rows(g, dev)
            synchronize(dev)
            #: phase breakdown of the most recent full (re)build: ``pkt``'s
            #: {tables, support, peel, compact} seconds, plus the
            #: preprocessing (the handle's CSR and ``prep.prepare``) and the
            #: triangle list
            self.open_phases = dict(res.phases or {}, preprocess=t_prep,
                                    triangle_list=time.perf_counter() - t0)
            self._commit(g, T, S.astype(np.int32), tri)
            self._set_ceiling()

    def check_invariants(self, *, sample: int = 64, seed: int = 0) -> int:
        """Cheap consistency check over a sampled edge set (DESIGN.md §15).

        Verifies, for a deterministic sample of ``sample`` edges (all edges
        when ``sample >= m``): the maintained support equals the edge's row
        count in the triangle list; ``2 <= T[e] <= S[e] + 2``; the truss
        h-operator fixpoint ``T[e] == h(T)[e]``; and sampled triangle rows
        are strictly increasing and in range.  It is *sampled*, not a
        proof: ``verify()`` remains the full oracle.  The next batch starts
        from the host trussness and support it checked.

        Returns:
            The number of edges checked.

        Raises:
            IntegrityError: any check fails (heal with :meth:`rebuild`).
        """
        m = self.g.m
        self._dev_TS = None     # the next batch starts from what is checked
        if m == 0:
            return 0
        if sample >= m:
            idx = np.arange(m, dtype=np.int64)
        else:
            # deterministic, seed-keyed sample without a bias toward low ids
            rng = np.random.default_rng(seed)
            idx = np.unique(rng.choice(m, size=sample, replace=False))
        dev = self.device
        idx_t = _ids(idx, dev)
        inc = _Incidence(self.tri, m)
        cnt = (inc.off[idx_t + 1] - inc.off[idx_t]).cpu().numpy()
        if not np.array_equal(cnt, self.S[idx].astype(np.int64)):
            raise IntegrityError(
                "invariant violation: maintained support disagrees with the "
                "triangle list on the sampled edges")
        if (self.T[idx] < 2).any() or (self.T[idx] > self.S[idx] + 2).any():
            raise IntegrityError(
                "invariant violation: trussness outside [2, support + 2] on "
                "the sampled edges")
        if not np.array_equal(
                _h_values(inc, _ids(self.T, dev), idx_t).cpu().numpy(),
                self.T[idx]):
            raise IntegrityError(
                "invariant violation: trussness is not an h-operator "
                "fixpoint on the sampled edges")
        rows = self.tri[inc.rows_of(idx_t)]
        if rows.numel() and not (
                bool((rows[:, 0] < rows[:, 1]).all())
                and bool((rows[:, 1] < rows[:, 2]).all())
                and int(rows.min()) >= 0 and int(rows.max()) < m):
            raise IntegrityError(
                "invariant violation: malformed triangle rows incident "
                "to the sampled edges")
        return int(idx.shape[0])

    def rebuild(self) -> None:
        """Self-healing hook: rediscover all state from the retained CSR.

        Discards trussness, support, triangle list, and the community-index
        cache, and recomputes them with a from-scratch ``pkt`` over the
        current edge list (DESIGN.md §15).  The edge set is kept exactly.
        """
        self._full_rebuild(self.edges)

    def verify(self) -> bool:
        """Does the maintained state match a from-scratch decomposition (the
        port's ``truss_pkt`` and ``compute_support`` on the handle's
        device)?"""
        if self.g.m == 0:
            return True
        ref = truss_pkt(self.edges, device=self.device)
        S_ref = support_mod.compute_support(self.g, device=self.device)
        if self.tri.numel():
            tri_ok = (self.tri.shape[0] == int(S_ref.sum()) // 3
                      and bool((self.tri[:, 0] < self.tri[:, 1]).all())
                      and bool((self.tri[:, 1] < self.tri[:, 2]).all()))
        else:
            tri_ok = int(S_ref.sum()) == 0
        return (np.array_equal(self.T, ref)
                and np.array_equal(self.S, S_ref) and bool(tri_ok))
