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
     bitwise parity oracle.
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
    an H100 machine (PERF.md).  Per-edge bookkeeping (bounds, candidate
    masks, the new CSR) stays host numpy.
  * ``triangle_list`` enumerates on the device (``core.triangle_list``'s
    oriented-table probe) and sorts the rows into the reference's order;
    the reference probes a full-adjacency table on the host.

``triangles_through`` (the batch's new triangles) and ``_host_peel`` (the
region peel at or below ``host_peel_max``) stay host numpy, as in the
reference.  The serving layer wraps this in ``TrussEngine.open / update /
close`` (``serve/truss_engine.py``); ``launch/truss.py --update-stream``
replays synthetic churn through it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import support as support_mod
from repro_torch.core.hierarchy import HIER_MODES, TrussHierarchy
from repro_torch.core.pkt import (_COMPACT_FRAC, _COMPACT_MIN, PEEL_MODES,
                                  peel_live_subset, pkt, truss_pkt)
from repro_torch.core.prep import (PREPROCESS_SPANS, align_to_input,
                                   order_and_build)
from repro_torch.core.support import check_axis
from repro_torch.core.triangle_list import _triangles_dev
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs.csr import (CSRGraph, build_csr,
                                    canonical_edges_with_rows,
                                    check_edge_array, edge_keys)
from repro_torch.kernels import wedge_common
from repro_torch.testing.chaos import fault_point

#: Insertion repair strategies (DESIGN.md §13): ``"batched"`` repairs the
#: whole insertion batch against one merged candidate region; ``"sequential"``
#: applies edges one at a time (the ±1 locality bound) and serves as the
#: bitwise parity oracle for the batched path.
INSERT_MODES = ("sequential", "batched")


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


class _Incidence:
    """Edge → triangle-row CSR over a fixed (T, 3) triangle tensor.

    Built and read on the triangle tensor's device: ``off`` (m+1,) and
    ``idx`` (3T,) group the members by a stable sort, the same permutation
    as the reference's host ``argsort(kind="stable")``.
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
    frontier = torch.unique(seeds[allowed[seeds]])
    visited[frontier] = True
    while frontier.numel():
        rows = inc.tri[torch.unique(inc.rows_of(frontier))]
        if side.numel():
            hit = torch.isin(side, frontier).any(dim=1)
            rows = torch.cat([rows, side[hit]])
        if rows.numel() == 0:
            break
        cand = rows[allowed[rows].all(dim=1)].reshape(-1)
        cand = torch.unique(cand[~visited[cand]])
        visited[cand] = True
        frontier = cand
    return torch.nonzero(visited).view(-1)


def _h_values(inc: _Incidence, tau: torch.Tensor,
              work: torch.Tensor) -> torch.Tensor:
    """Truss h-operator for each edge in ``work``: 2 + (largest s such that
    the edge is in >= s triangles whose other two edges both have current
    value >= s + 2).  Vectorized over the incidence structure."""
    h = torch.zeros(work.shape[0], dtype=torch.int64, device=work.device)
    if work.numel() == 0:
        return h
    cnt = inc.off[work + 1] - inc.off[work]
    owner = torch.repeat_interleave(
        torch.arange(work.shape[0], device=work.device), cnt)
    rows = inc.tri[inc.rows_of(work)]
    if rows.numel():
        e = work[owner]
        # partner-min in rho (= tau - 2) space, per membership
        t0, t1, t2 = tau[rows[:, 0]], tau[rows[:, 1]], tau[rows[:, 2]]
        val = torch.where(
            rows[:, 0] == e, torch.minimum(t1, t2),
            torch.where(rows[:, 1] == e, torch.minimum(t0, t2),
                        torch.minimum(t0, t1))) - 2
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


def _h_descent(inc: _Incidence, tau: torch.Tensor, seeds: torch.Tensor,
               totals, limit: float) -> bool:
    """Chaotic descent of the truss h-operator from a valid upper bound.

    Exact when ``tau`` starts pointwise >= the true decomposition, which
    holds for pure deletions.  Work is proportional to the edges that
    actually drop plus their triangle neighborhoods.  Mutates ``tau``;
    returns False (request the full-recompute fallback) once more than
    ``limit`` edges have dropped — the local_frac policy.
    """
    changed = torch.zeros(tau.shape[0], dtype=torch.bool, device=tau.device)
    work = torch.unique(seeds)
    while work.numel():
        totals["passes"] += 1
        h = _h_values(inc, tau, work)
        drop = h < tau[work]
        dropped = work[drop]
        tau[dropped] = h[drop]
        changed[dropped] = True
        if dropped.numel() == 0:
            break
        n_changed = int(changed.sum())
        if n_changed > limit:
            totals["affected"] += n_changed
            return False
        rows = inc.tri[torch.unique(inc.rows_of(dropped))]
        work = torch.unique(rows.reshape(-1))
    totals["affected"] += int(changed.sum())
    return True


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
        insert_mode: insertion repair strategy ("batched" / "sequential",
            §13); bitwise-identical results.
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
        E, _, _, n_seen = canonical_edges_with_rows(edges)
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
        T = np.asarray(trussness, np.int64)
        S = np.asarray(support, np.int32)
        tri = np.asarray(triangles, np.int64).reshape(-1, 3)
        if T.shape != (g.m,) or S.shape != (g.m,):
            raise ValueError(f"trussness and support must be ({g.m},), got "
                             f"{T.shape} and {S.shape}")
        if tri.size and (int(tri.min()) < 0 or int(tri.max()) >= g.m):
            raise ValueError("triangle rows reference edge ids beyond m")
        inc._commit(g, T, S, _ids(tri, inc.device))
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
        n = self.n
        m_before = self.g.m

        old_keys = edge_keys(self.g.El[:, 0].astype(np.int64),
                             self.g.El[:, 1].astype(np.int64), n)
        add_keys = self._batch_keys(add, n)
        rem_keys = self._batch_keys(rem, n)
        new_keys = np.union1d(
            np.setdiff1d(old_keys, rem_keys, assume_unique=True), add_keys)
        I_keys = np.setdiff1d(new_keys, old_keys, assume_unique=True)
        D_keys = np.setdiff1d(old_keys, new_keys, assume_unique=True)

        totals = {"affected": 0, "boundary": 0, "passes": 0}
        T_old_ref = self.T      # for the changed count (old-id space)

        def done(mode):
            m_after = self.g.m
            if mode == "noop":
                changed = 0
            else:
                posn = np.searchsorted(
                    edge_keys(self.g.El[:, 0].astype(np.int64),
                              self.g.El[:, 1].astype(np.int64), n), old_keys)
                safe = np.minimum(posn, max(m_after - 1, 0))
                ok = np.zeros(m_before, bool)
                if m_after:
                    kn = edge_keys(self.g.El[:, 0].astype(np.int64),
                                   self.g.El[:, 1].astype(np.int64), n)
                    ok = (posn < m_after) & (kn[safe] == old_keys)
                changed = int((self.T[posn[ok]] != T_old_ref[ok]).sum()) \
                    + int(I_keys.size)
                if mode == "local" and self._hier is not None:
                    self._hier_update(old_keys, I_keys, T_old_ref, posn, ok,
                                      kn if m_after else None)
            st = UpdateStats(
                mode=mode, m_before=m_before, m_after=m_after,
                inserted=int(I_keys.size), deleted=int(D_keys.size),
                affected=totals["affected"], boundary=totals["boundary"],
                rounds=totals["passes"], changed=changed,
                seconds=time.perf_counter() - t0,
                insert_mode=imode if (I_keys.size and mode != "noop")
                else None)
            self.stats["updates"] += 1
            self.stats[mode] += 1
            self.stats["update_seconds"] += st.seconds
            self.stats["last"] = st
            return st

        if I_keys.size == 0 and D_keys.size == 0:
            return done("noop")

        E_new = np.stack([new_keys // n, new_keys % n], axis=1)
        limit = self.local_frac * max(1, new_keys.shape[0])

        # Both phases build the next state off to the side and it is
        # committed exactly once, after the whole batch has succeeded — an
        # exception mid-repair leaves the handle untouched (§13).
        state = (self.g, self.T, self.S, self.tri)

        # ---------------- phase D: all deletions as one exact batch -------
        if D_keys.size:
            state = self._apply_deletions(old_keys, D_keys, n, limit, totals)
            if state is None:
                self._full_rebuild(E_new)
                return done("full")

        # ---------------- phase I: insertions (batched or sequential) -----
        if I_keys.size:
            state = self._apply_insertions(state, new_keys, I_keys, n, limit,
                                           totals, imode)
            if state is None:
                self._full_rebuild(E_new)
                return done("full")

        self._commit(*state)
        return done("local")

    # ------------------------------------------------------- deletion phase --
    def _apply_deletions(self, old_keys, D_keys, n, limit, totals):
        """G → G − D, built off to the side (committed state untouched).

        Returns the repaired ``(g, T, S, tri)`` state tuple, or ``None`` to
        request full fallback.  The triangle list's passes and the h-descent
        run on the handle's device.
        """
        g_old, T_old, S_old, tri_old = self.g, self.T, self.S, self.tri
        dev = self.device
        m_old = g_old.m
        del_old = np.searchsorted(old_keys, D_keys)
        is_del = np.zeros(m_old, bool)
        is_del[del_old] = True

        mid_keys = np.setdiff1d(old_keys, D_keys, assume_unique=True)
        E_mid = np.stack([mid_keys // n, mid_keys % n], axis=1)
        g_mid = build_csr(E_mid, n)
        m_mid = g_mid.m
        mid_of_old = np.full(m_old, -1, np.int64)
        mid_of_old[~is_del] = np.searchsorted(mid_keys, old_keys[~is_del])

        # triangle list and support delta (each lost row exactly once)
        is_del_t = torch.from_numpy(is_del).to(dev)
        mid_of_old_t = _ids(mid_of_old, dev)
        lost_mask = is_del_t[tri_old].any(dim=1)
        lost = tri_old[lost_mask]
        tri_mid = mid_of_old_t[tri_old[~lost_mask]]
        S_mid = S_old[~is_del].astype(np.int64)
        seeds = torch.zeros(0, dtype=torch.int64, device=dev)
        if lost.numel():
            members = lost.reshape(-1)
            seeds = mid_of_old_t[members[~is_del_t[members]]]
            S_mid -= torch.bincount(seeds, minlength=m_mid).cpu().numpy()
        S_mid = S_mid.astype(np.int32)
        T_mid = T_old[~is_del].copy()

        # Deletions only lower trussness, so the old values bound the new
        # decomposition from above and the local h-index descent repairs
        # exactly, discovering the affected set lazily.
        if seeds.numel():
            if torch.unique(seeds).numel() > limit:
                return None         # repair would touch too much: recompute
            tau = _ids(T_mid, dev)
            if not _h_descent(_Incidence(tri_mid, m_mid), tau, seeds,
                              totals, limit):
                return None         # descent cascaded past local_frac
            T_mid = tau.cpu().numpy()
        return g_mid, T_mid, S_mid, tri_mid

    # ------------------------------------------------------ insertion phase --
    def _apply_insertions(self, state, new_keys, I_keys, n, limit, totals,
                          insert_mode):
        """G → G + I, built off to the side (committed state untouched).

        Builds the one new CSR, maps the mid-state values into the new edge
        space, and dispatches on ``insert_mode``.  Returns the repaired
        ``(g, T, S, tri)`` state tuple, or ``None`` to request full
        fallback.
        """
        g_mid, T_mid, S_mid, tri_mid = state
        mid_keys = edge_keys(g_mid.El[:, 0].astype(np.int64),
                             g_mid.El[:, 1].astype(np.int64), n)
        E_new = np.stack([new_keys // n, new_keys % n], axis=1)
        g_new = build_csr(E_new, n)
        m_new = g_new.m
        new_of_mid = np.searchsorted(new_keys, mid_keys)
        ins_new = np.searchsorted(new_keys, I_keys)

        T_cur = np.full(m_new, -1, np.int64)
        T_cur[new_of_mid] = T_mid
        S_cur = np.zeros(m_new, np.int64)
        S_cur[new_of_mid] = S_mid
        present = np.zeros(m_new, bool)
        present[new_of_mid] = True

        tri_static = _ids(new_of_mid, self.device)[tri_mid]
        inc_static = _Incidence(tri_static, m_new)
        insert = (self._insert_batched if insert_mode == "batched"
                  else self._insert_sequential)
        side_rows = insert(g_new, inc_static, ins_new, T_cur, S_cur, present,
                           limit, totals)
        if side_rows is None:
            return None
        tri_new = torch.cat([tri_static, _ids(side_rows, self.device)])
        return g_new, T_cur, S_cur.astype(np.int32), tri_new

    def _level_regions(self, inc_static, side, seeds, T_cur, UB, present,
                       k_cap, limit, totals):
        """The level-filtered candidate region of an insertion step: for
        each level k up to ``k_cap`` (ascending), the edges at level k that
        the BFS from ``seeds`` reaches through ``{UB >= k+1}``.  Returns
        the candidate mask, or ``None`` once it passes ``limit``."""
        dev = self.device
        side_t, seeds_t = _ids(side, dev), _ids(seeds, dev)
        cand = np.zeros(T_cur.shape[0], bool)
        for k in np.unique(T_cur[present & (T_cur >= 2)]):
            if k > k_cap:
                break
            allowed = torch.from_numpy(UB >= k + 1).to(dev)
            totals["passes"] += 1
            reach = _tri_bfs(inc_static, side_t, seeds_t,
                             allowed).cpu().numpy()
            cand[reach[T_cur[reach] == k]] = True
            if int(cand.sum()) > limit:
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
            a, p2, p3 = triangles_through(g_new, np.array([e_i]))
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
    def _region_peel(self, g: CSRGraph, inc: _Incidence, side: np.ndarray,
                     A: np.ndarray, S_vec: np.ndarray, T_fix: np.ndarray,
                     totals, live_mask: np.ndarray | None = None):
        """Re-peel region ``A`` with its exterior triangle partners pinned
        at their known death level.  Returns the new peel values + 2 for
        ``A`` (same order).  ``live_mask`` masks absent edges (insertion
        phase).  Regions up to ``host_peel_max`` edges (with their
        boundary) run the host mirror; larger ones ``peel_live_subset`` on
        the device, K2 with the boundary pinned on the kernel path."""
        m = g.m
        dev = self.device
        A_t = _ids(A, dev)
        rows = inc.tri[torch.unique(inc.rows_of(A_t))]
        if side.size:
            side_t = _ids(side, dev)
            rows = torch.cat([rows, side_t[torch.isin(side_t, A_t)
                                           .any(dim=1)]])
        if live_mask is not None and rows.numel():
            rows = rows[torch.from_numpy(live_mask).to(dev)[rows].all(dim=1)]
        in_A = np.zeros(m, bool)
        in_A[A] = True
        flat = rows.reshape(-1)
        boundary = torch.unique(
            flat[~torch.from_numpy(in_A).to(dev)[flat]]).cpu().numpy()
        totals["affected"] += int(A.size)
        totals["boundary"] += int(boundary.size)

        L = np.union1d(A, boundary)
        on_host = L.shape[0] <= self.host_peel_max
        chaos = fault_point("region", rung="host" if on_host else self.mode)
        S0 = np.where(in_A[L], S_vec[L], T_fix[L] - 2)
        if on_host:
            # compact host path: local ids preserve the global id order, so
            # the tie-break picks the same winners
            lmap = np.full(m, -1, np.int64)
            lmap[L] = np.arange(L.shape[0])
            S_fin = _host_peel(L.shape[0], lmap[rows.cpu().numpy()],
                               S0, np.ones(L.shape[0], bool), ~in_A[L])
            tau_L = S_fin + 2
        else:
            # larger regions reuse the live-edge compaction machinery: the
            # region is gathered into a compacted edge space — work bounded
            # by |L|, not m — with boundary edges pinned at their death level
            S_fin = peel_live_subset(
                g.El, L, S0, ~in_A[L], chunk=self.chunk, mode=self.mode,
                table_mode=self.table_mode, compact_frac=self.compact_frac,
                compact_min=self.compact_min, device=dev)
            tau_L = S_fin.astype(np.int64) + 2
        self.region_peels["host" if on_host else "device"] += 1
        if chaos == "corrupt" and boundary.size:
            # injected corruption (testing/chaos.py): bump one pinned slot so
            # the replay invariant below is guaranteed to trip, without ever
            # letting a wrong value reach committed state
            tau_L = tau_L.copy()
            tau_L[np.searchsorted(L, boundary[0])] += 1
        # replay invariant: pinned edges must die exactly at their schedule.
        # A real raise (not an assert, which -O strips): a violation means
        # the re-peel would commit corrupt trussness into the handle.
        if not np.array_equal(tau_L[~in_A[L]], T_fix[boundary]):
            raise IntegrityError(
                "incremental re-peel integrity violation: a pinned boundary "
                "edge left its death level — please report this graph")
        return tau_L[np.searchsorted(L, A)]

    # ---------------------------------------------------------- internals --
    def _hier_update(self, old_keys, I_keys, T_old, posn, ok, kn) -> None:
        """Carry the community index across a *local* repair (DESIGN.md §11).

        ``k_hi`` is the maximum trussness involved in any insertion,
        deletion, or trussness change (old or new value).  Levels above
        ``k_hi`` keep their exact partition — only edge ids shifted — so
        they are remapped in O(m); levels at or below come back dirty and
        rebuild lazily on next query.
        """
        m_before = old_keys.shape[0]
        m_after = self.g.m
        if m_after == 0 or kn is None or self._hier is None:
            self._hier = None
            return
        k_hi = 1
        if (~ok).any():                      # deletions: old death levels
            k_hi = max(k_hi, int(T_old[~ok].max()))
        t_new = self.T[posn[ok]]
        t_old = T_old[ok]
        diff = t_new != t_old
        if diff.any():                       # changed: both old and new
            k_hi = max(k_hi, int(t_old[diff].max()), int(t_new[diff].max()))
        if I_keys.size:                      # insertions: their new levels
            k_hi = max(k_hi, int(self.T[np.searchsorted(kn, I_keys)].max()))
        old_to_new = np.full(m_before, -1, np.int64)
        old_to_new[np.nonzero(ok)[0]] = posn[ok]
        self._hier = self._hier.remapped(self.T, self.triangles, old_to_new,
                                         k_hi)

    @staticmethod
    def _batch_keys(batch: np.ndarray, n: int) -> np.ndarray:
        if batch.size == 0:
            return np.zeros(0, np.int64)
        lo = np.minimum(batch[:, 0], batch[:, 1])
        hi = np.maximum(batch[:, 0], batch[:, 1])
        return np.unique(edge_keys(lo, hi, n))

    def _commit(self, g_new: CSRGraph, T_new: np.ndarray, S_new: np.ndarray,
                tri_new: torch.Tensor) -> None:
        self.g = g_new
        self.T = T_new.astype(np.int64)
        self.S = S_new.astype(np.int32)
        #: the (T, 3) int64 triangle list, kept on the handle's device
        self.tri = tri_new.to(self.device, torch.int64)

    def _full_rebuild(self, E: np.ndarray) -> None:
        """From-scratch decomposition through the standard (KCO) pipeline:
        K1 and K2 on the card under the default executors."""
        self._hier = None        # full rebuild: community index rebuilt lazily
        with trace.collect() as recorded:
            g = build_csr(E, self.n)
            if g.m == 0:
                self.open_phases = {}
                self._commit(g, np.zeros(0, np.int64), np.zeros(0, np.int32),
                             _triangle_rows(g, self.device))
                return
            # keys: each row of g.El in the relabelled id space
            gr, keys = order_and_build(E, g.El[:, 0], g.El[:, 1], self.n,
                                       reorder=True)
        t_prep = trace.seconds(recorded, PREPROCESS_SPANS)
        res = pkt(gr, chunk=self.chunk, mode=self.mode,
                  support_mode=self.support_mode, table_mode=self.table_mode,
                  compact_frac=self.compact_frac,
                  compact_min=self.compact_min, phase_timings=True,
                  device=self.device)
        T = align_to_input(res.trussness, gr, None, self.n, keys=keys)
        S = align_to_input(res.support, gr, None, self.n, keys=keys)
        t0 = time.perf_counter()
        tri = _triangle_rows(g, self.device)
        synchronize(self.device)
        #: phase breakdown of the most recent full (re)build: ``pkt``'s
        #: {tables, support, peel, compact} seconds, plus the host
        #: preprocessing (the ``csr.*`` spans: CSR builds, degeneracy order,
        #: relabelling) and the triangle list
        self.open_phases = dict(res.phases or {}, preprocess=t_prep,
                                triangle_list=time.perf_counter() - t0)
        self._commit(g, T, S.astype(np.int32), tri)

    def check_invariants(self, *, sample: int = 64, seed: int = 0) -> int:
        """Cheap consistency check over a sampled edge set (DESIGN.md §15).

        Verifies, for a deterministic sample of ``sample`` edges (all edges
        when ``sample >= m``): the maintained support equals the edge's row
        count in the triangle list; ``2 <= T[e] <= S[e] + 2``; the truss
        h-operator fixpoint ``T[e] == h(T)[e]``; and sampled triangle rows
        are strictly increasing and in range.  It is *sampled*, not a
        proof: ``verify()`` remains the full oracle.

        Returns:
            The number of edges checked.

        Raises:
            IntegrityError: any check fails (heal with :meth:`rebuild`).
        """
        m = self.g.m
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
