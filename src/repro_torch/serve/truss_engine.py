"""Batched multi-graph truss engine — many small graphs per dispatch.

The serving story for truss decomposition is the opposite of the paper's
single-giant-graph benchmark: heavy traffic is a *stream* of modest graphs
(per-user ego nets, transaction neighborhoods, rolling windows) where the
per-dispatch overhead dominates if each graph is decomposed alone.  This
engine amortizes it:

  * **Bucketing** — every submission is preprocessed on the host
    (canonicalize, optional k-core reorder, CSR build) and assigned to a
    *size class*: all dimensions padded up to powers of two — the same
    ``SizeClass`` keys as the JAX package, so ``bucket_of`` and
    ``flush(only=...)`` route traffic the same way.  With the default
    ``table_mode="device"`` the wedge tables never exist on the host.
  * **Batching** — the JAX package decomposes a bucket with one
    ``jax.vmap`` over the stacked, padded operands.  The port has no vmap
    over its host-driven peel and custom kernels; instead a bucket is
    decomposed as **one disjoint-union graph** (``CSROperand``): the
    bucket's graphs side by side, vertex ids offset per graph.  Trussness
    and support are per-component properties, so one ``pkt`` over the union
    gives every graph its own result — one support launch and one
    peel-loop launch per peel segment for the whole bucket.  The per-graph ``levels`` /
    sub-level counters, which ``flush`` never returned, do not exist here.
  * **Order-aligned results** — ``submit`` returns a ticket; results are
    delivered aligned to each submission's own edge-row order regardless of
    bucket membership or flush timing.

Usage:

    eng = TrussEngine()               # on the card; device="cpu" for tests
    t1 = eng.submit(edges_a)          # queued
    t2 = eng.submit(edges_b)          # queued (maybe same bucket)
    trussness_b = eng.result(t2)      # flushes pending work once
    trussness_a = eng.result(t1)      # already computed

Submissions larger than ``max_edges`` canonical edges are rejected at
``submit`` time.

Persistent handles absorb edge churn by incremental repair (DESIGN.md §9,
``core/truss_inc.py``):

    h = eng.open(edges)                           # K1 + K2 on the card
    st = eng.update(h, add_edges=a, remove_edges=r)   # local or full repair
    h.communities(4)                              # the k-truss community index
    eng.close(h)
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np

from repro_torch import trace
from repro_torch.core import support as support_mod
from repro_torch.core.hierarchy import HIER_MODES, TrussHierarchy
from repro_torch.core.pkt import PEEL_MODES, pkt
from repro_torch.core.prep import align_to_input, order_and_build
from repro_torch.core.ref import truss_numpy
from repro_torch.core.support import check_axis
from repro_torch.core.truss_inc import (INSERT_MODES, IncrementalTruss,
                                        UpdateStats)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, canonical_edges_with_rows
from repro_torch.kernels import count_launches
from repro_torch.kernels.wedge_common import next_pow2 as _next_pow2
from repro_torch.testing.chaos import fault_point

_MIN_M_PAD = 8


class SizeClass(NamedTuple):
    """Bucket key: the padded shapes a graph's pipeline depends on."""

    m_pad: int        # padded edge count (pow2)
    sup_pad: int      # padded support-table length (pow2)
    peel_pad: int     # padded peel-table length (pow2)
    n_pad: int        # padded vertex count (pow2; 0 in table_mode="numpy")


class CSROperand(NamedTuple):
    """One bucket's disjoint-union graph: what a flush hands to ``pkt``.

    Graph ``i`` of the bucket owns the union's edge ids
    ``[edge_off[i], edge_off[i+1])`` in its own ``El`` row order: its
    vertices are offset past every earlier graph's, so the union's
    lexicographic edge order keeps each graph's rows contiguous and in
    order.
    """

    g: CSRGraph
    edge_off: np.ndarray    # (k+1,) int64


def disjoint_union(graphs: list[CSRGraph]) -> CSROperand:
    """Place CSR graphs side by side in one CSR graph, without re-sorting.

    Equal to ``build_csr`` of the concatenated, vertex-offset edge lists.
    """
    with trace.span("engine.union", graphs=len(graphs)):
        ns = np.array([g.n for g in graphs], np.int64)
        ms = np.array([g.m for g in graphs], np.int64)
        v_off = np.concatenate([[0], np.cumsum(ns)])
        e_off = np.concatenate([[0], np.cumsum(ms)])
        s_off = 2 * e_off
        n_tot, m_tot = int(v_off[-1]), int(e_off[-1])
        if (n_tot >= np.iinfo(np.int32).max
                or 2 * m_tot >= np.iinfo(np.int32).max):
            raise ValueError(f"bucket union of n={n_tot}, m={m_tot} "
                             f"overflows the int32 CSR layout")
        parts = list(zip(graphs, v_off[:-1], e_off[:-1], s_off[:-1]))

        def cat(fn):
            return np.concatenate([fn(*p) for p in parts]).astype(np.int32)

        u = CSRGraph(
            n=n_tot, m=m_tot,
            Es=np.append(cat(lambda g, vo, eo, so: g.Es[:-1] + so),
                         np.int32(2 * m_tot)),
            N=cat(lambda g, vo, eo, so: g.N + vo),
            Eid=cat(lambda g, vo, eo, so: g.Eid + eo),
            El=np.concatenate([g.El + vo for g, vo, _, _ in parts]).astype(
                np.int32).reshape(-1, 2),
            Eo=cat(lambda g, vo, eo, so: g.Eo + so),
        )
        return CSROperand(g=u, edge_off=e_off)


@dataclasses.dataclass
class _Pending:
    ticket: int
    g: CSRGraph
    n: int
    in_keys: np.ndarray       # per input row: canonical key in relabeled space
    key: SizeClass
    sup_size: int             # exact support-table rows
    peel_size: int            # exact peel-table rows
    E: np.ndarray             # canonical pre-relabel edges (handle promotion)


class TrussHandle:
    """Persistent decomposition state — the mutable sibling of a ticket.

    Returned by ``TrussEngine.open`` (or by promoting a still-pending
    ticket through ``TrussEngine.update``).  Unlike the single-read ticket
    API, a handle retains its graph, trussness, support and triangle list
    across ``update`` calls until ``TrussEngine.close`` releases it.
    """

    __slots__ = ("hid", "_inc", "closed")

    def __init__(self, hid: int, inc: IncrementalTruss):
        self.hid = hid
        self._inc = inc
        self.closed = False

    @property
    def edges(self) -> np.ndarray:
        """Current canonical (m, 2) edge list (key-sorted)."""
        return self._inc.edges

    @property
    def trussness(self) -> np.ndarray:
        """Per-edge trussness aligned to ``edges`` rows."""
        return self._inc.trussness

    @property
    def m(self) -> int:
        """Current number of (unique, canonical) edges."""
        return self._inc.m

    @property
    def n(self) -> int:
        """Vertex-space size (max id + 1 at open; grows with updates)."""
        return self._inc.n

    @property
    def insert_mode(self) -> str:
        """Insertion repair strategy this handle's updates take (§13)."""
        return self._inc.insert_mode

    def query(self, edges) -> np.ndarray:
        """Trussness for specific edges, aligned to the given rows."""
        return self._inc.query(edges)

    # --------------------------------------------- community queries (§11) --
    def hierarchy(self, *, mode: str | None = None) -> TrussHierarchy:
        """The handle's :class:`~repro_torch.core.hierarchy.TrussHierarchy`.

        Lazily built from the handle's maintained trussness + triangle list
        and cached; local ``TrussEngine.update`` batches carry it forward
        (untouched levels are id-remapped, repaired levels rebuild lazily),
        full rebuilds drop it.  ``mode`` in ``HIER_MODES`` overrides the
        engine's default ("device" label flood vs the "host" union-find
        oracle — bitwise-identical labels); a non-default mode returns a
        standalone index without touching the cache.
        """
        return self._inc.hierarchy(mode=mode)

    def communities(self, k: int, *,
                    hier_mode: str | None = None) -> list[np.ndarray]:
        """Every k-truss community as a (c, 2) array of edge endpoints.

        Communities are the *triangle-connected* components of the edges
        with trussness >= k (Wang & Cheng), ordered by their representative
        (minimum) edge id; an edge in no surviving triangle forms a
        singleton.  k above the graph's max trussness yields ``[]``.
        ``hier_mode`` overrides the index builder for this call: a
        non-default mode builds a standalone index, bypassing — and never
        evicting — the cached one, with bitwise-identical labels.
        """
        # the scheduler's hierarchy ladder (serve/scheduler.py:
        # _resilient_communities) passes ``hier_mode="host"`` on its
        # demoted rung
        E = self._inc.edges
        ids_per = self._inc.hierarchy(mode=hier_mode).communities(k)
        return [E[ids] for ids in ids_per]

    def community(self, edge_or_vertex, k: int):
        """The k-truss community around one edge — or all around one vertex.

        An ``(u, v)`` pair returns that edge's community as a (c, 2)
        endpoint array (empty when the edge's trussness is below ``k``; an
        edge not in the graph raises the descriptive alignment ValueError).
        A scalar vertex id returns a *list* of communities, one per distinct
        level-``k`` community among the vertex's incident edges.
        """
        h = self._inc.hierarchy()
        E = self._inc.edges
        q = np.asarray(edge_or_vertex)
        if q.ndim == 0:                       # vertex query
            v = int(q)
            inc_ids = np.nonzero((E[:, 0] == v) | (E[:, 1] == v))[0]
            labels = h.level_labels(k)[inc_ids]
            reps = np.unique(labels[labels >= 0])
            return [E[h.community_of(int(r), k)] for r in reps]
        eid = int(self._inc.edge_ids(q.reshape(1, 2))[0])
        return E[h.community_of(eid, k)]

    def __repr__(self):
        state = "closed" if self.closed else f"m={self._inc.m}"
        return f"TrussHandle({self.hid}, {state})"


class TrussEngine:
    """Queue API over the batched decomposition pipeline.

    Two traffic shapes share one engine: *single-read tickets*
    (``submit``/``flush``/``result``/``map``) decompose the graphs of one
    size class together, as one disjoint union, per flush; *persistent
    handles* (``open``/``update``/``update_many``/``close``) absorb edge
    churn by incremental repair (DESIGN.md §9).

    Args:
        mode: peel executor for every decomposition (see ``core.pkt.pkt``).
        support_mode: support executor (same axes as ``pkt``).
        table_mode: where the wedge tables are built — "device" on the
            device (§10); "numpy" is the host parity oracle.
        hier_mode: community-index builder for handles (§11).
        insert_mode: handle insertion repair strategy ("batched" /
            "sequential" / "klevel", §13); bitwise-identical trussness and
            support.
        chunk: peel chunk size (rounded up to pow2). ``None`` (default)
            derives it from the table size (``wedge_common.auto_chunk``).
        reorder: degeneracy-reorder each submission before decomposition.
        max_pending: auto-flush threshold — ``submit`` triggers a full
            ``flush`` once this many submissions are queued.
        max_edges: reject submissions beyond this many canonical edges.
        device: "cuda" (default; raises when no card is present) or "cpu".

    Raises:
        ValueError: unknown mode axis, or non-positive ``chunk`` /
            ``max_edges``.
    """

    def __init__(self, *, mode: str = "kernel", support_mode: str = "kernel",
                 table_mode: str = "device", hier_mode: str = "device",
                 insert_mode: str = "batched", chunk: int | None = None,
                 reorder: bool = True, max_pending: int = 32,
                 max_edges: int = 1 << 22, device="cuda"):
        check_axis("mode", mode, PEEL_MODES)
        check_axis("support_mode", support_mode, support_mod.SUPPORT_MODES)
        check_axis("table_mode", table_mode, support_mod.TABLE_MODES)
        check_axis("hier_mode", hier_mode, HIER_MODES)
        check_axis("insert_mode", insert_mode, INSERT_MODES)
        if chunk is not None and chunk < 1:
            raise ValueError("chunk must be positive")
        if max_edges < 1:
            raise ValueError("max_edges must be positive")
        self.device = resolve_device(device)
        self.mode = mode
        self.support_mode = support_mode
        self.table_mode = table_mode
        self.hier_mode = hier_mode
        self.insert_mode = insert_mode
        self.max_edges = max_edges
        self.chunk = None if chunk is None else _next_pow2(chunk)
        self.reorder = reorder
        self.max_pending = max_pending
        self._pending: list[_Pending] = []
        self._results: dict[int, np.ndarray] = {}
        self._next_ticket = 0
        self._handles: dict[int, TrussHandle] = {}
        self._next_handle = 0
        self.stats = {
            "submitted": 0, "flushes": 0, "batches": 0,
            "buckets": set(), "graph_seconds": 0.0, "graphs_done": 0,
            # warm_* counts only dispatches whose bucket was seen before —
            # the steady-state throughput basis
            "warm_seconds": 0.0, "warm_graphs": 0,
            # per size class: K1/K2 launches and plain-version calls of its
            # dispatches (which executor really ran)
            "bucket_launches": {},
            # handle lifecycle (incremental maintenance)
            "handles_opened": 0, "updates": 0, "updates_local": 0,
            "updates_full": 0, "update_seconds": 0.0,
        }

    # ------------------------------------------------------------- submit --
    def submit(self, edges: np.ndarray) -> int:
        """Queue one graph; returns a ticket for ``result``.

        ``edges`` is any (k, 2) integer array of undirected edges (either
        endpoint order; duplicate rows allowed; self-loops, negative vertex
        ids and ids beyond the int32 CSR / int64 key-packing bounds
        rejected).  The result is aligned to the input rows:
        ``result(t)[i]`` is the trussness of ``edges[i]``.
        """
        with trace.span("engine.submit", ticket=self._next_ticket):
            E, lo, hi, n = canonical_edges_with_rows(edges)
            trace.set(m=len(E))
            ticket = self._next_ticket
            self._next_ticket += 1
            self.stats["submitted"] += 1

            if E.size == 0:
                self._results[ticket] = np.zeros(0, np.int64)
                return ticket
            if E.shape[0] > self.max_edges:
                raise ValueError(
                    f"graph too large for this engine: m={E.shape[0]} "
                    f"canonical edges exceeds max_edges={self.max_edges}; "
                    f"decompose it directly with core.pkt.truss_pkt, or "
                    f"raise max_edges")

            # in_keys: each *input row*'s key in the relabeled space
            # (duplicate and endpoint-swapped rows map onto the same
            # canonical edge)
            g, in_keys = order_and_build(E, lo, hi, n, reorder=self.reorder)
            # tables never materialize on the host: bucket by their exact
            # entry counts (O(m) host math)
            sup_size = support_mod.support_table_size(g)
            peel_size = support_mod.peel_table_size(g)
            key = self._size_class(g, sup_size, peel_size)
            if self.table_mode == "device":
                # the kernel peel builds no table: only the support's pad
                # meets the int32 guard there
                support_mod._check_table_size(
                    key.sup_pad if self.mode == "kernel"
                    else max(key.sup_pad, key.peel_pad))
            self._pending.append(_Pending(
                ticket=ticket, g=g, n=n, in_keys=in_keys, key=key,
                sup_size=sup_size, peel_size=peel_size, E=E))
            if len(self._pending) >= self.max_pending:
                self.flush()
            return ticket

    def submit_many(self, graphs) -> list[int]:
        """Submit each graph; returns order-aligned tickets."""
        return [self.submit(e) for e in graphs]

    # ------------------------------------------------------------ results --
    def result(self, ticket: int) -> np.ndarray:
        """Trussness for one ticket, flushing pending work if needed.

        Single-read: each ticket's result is released when collected; a
        second read, or an unknown ticket, raises KeyError.
        """
        if ticket not in self._results:
            if any(p.ticket == ticket for p in self._pending):
                self.flush()
            else:
                raise KeyError(
                    f"unknown or already-collected ticket {ticket!r}")
        return self._results.pop(ticket)

    def map(self, graphs) -> list[np.ndarray]:
        """Submit a list of graphs, flush once, return order-aligned results."""
        tickets = self.submit_many(graphs)
        self.flush()
        return [self.result(t) for t in tickets]

    # ----------------------------------------------- incremental handles --
    def open(self, edges, *, local_frac: float = 0.25,
             insert_mode: str | None = None) -> TrussHandle:
        """Decompose ``edges`` into a *persistent* handle for ``update``.

        Unlike ``submit``'s single-read tickets, a handle retains the CSR
        graph, support, trussness and triangle list across arbitrarily many
        ``update`` batches until ``close`` releases it.  ``insert_mode``
        overrides the engine's insertion repair strategy for this handle
        (``None``: engine default, §13).
        """
        inc = IncrementalTruss(
            edges, mode=self.mode, support_mode=self.support_mode,
            table_mode=self.table_mode, hier_mode=self.hier_mode,
            insert_mode=(self.insert_mode if insert_mode is None
                         else insert_mode),
            chunk=self.chunk, local_frac=local_frac, device=self.device)
        h = TrussHandle(self._next_handle, inc)
        self._next_handle += 1
        self._handles[h.hid] = h
        self.stats["handles_opened"] += 1
        return h

    def update(self, ticket_or_handle, *, add_edges=None,
               remove_edges=None,
               insert_mode: str | None = None) -> UpdateStats:
        """Apply one insert/delete batch to a handle (or promote a ticket).

        Accepts a :class:`TrussHandle`, or an *int ticket* whose submission
        is still pending — the ticket is then consumed (it can no longer be
        redeemed through ``result``) and promoted to a fresh handle, which
        the returned stats carry in ``.handle``.  Tickets already flushed or
        collected cannot be promoted; re-``open`` the edges instead.

        Small batches are absorbed by local repair (affected-region re-peel,
        see ``core/truss_inc.py``); large ones fall back to a full
        recompute.  ``stats.mode`` reports which path ran.  ``insert_mode``
        overrides the handle's insertion strategy for this call (§13).
        """
        h = self._resolve_handle(ticket_or_handle)
        st = h._inc.update(add_edges=add_edges, remove_edges=remove_edges,
                           insert_mode=insert_mode)
        return self._count_update(st, h)

    def update_many(self, ticket_or_handle, batches, *,
                    insert_mode: str | None = None) -> UpdateStats:
        """Apply several queued update batches to one handle as one repair.

        ``batches`` is a sequence of ``(add_edges, remove_edges)`` pairs in
        arrival order; their set-wise composition
        (``core.truss_inc.compose_update_batches``) is applied as a
        *single* :meth:`IncrementalTruss.update` (DESIGN.md §12).

        Args:
            ticket_or_handle: a :class:`TrussHandle` (or promotable ticket,
                as in :meth:`update`).
            batches: iterable of ``(add_edges, remove_edges)`` pairs;
                either element may be ``None``.
            insert_mode: per-call override of the handle's insertion
                strategy (``None``: handle default, §13).

        Returns:
            One :class:`UpdateStats` for the composed repair, with
            ``coalesced`` set to the number of merged batches and
            ``handle`` set to the target handle.  The final state is
            bitwise-identical to applying the batches one at a time.

        Raises:
            ValueError: closed handle, or invalid edge arrays.
            KeyError: a ticket that is not promotable.
        """
        h = self._resolve_handle(ticket_or_handle)
        st = h._inc.update_many(batches, insert_mode=insert_mode)
        return self._count_update(st, h)

    def _count_update(self, st: UpdateStats, h: TrussHandle) -> UpdateStats:
        self.stats["updates"] += 1
        if st.mode == "full":
            self.stats["updates_full"] += 1
        elif st.mode == "local":
            self.stats["updates_local"] += 1
        self.stats["update_seconds"] += st.seconds
        return dataclasses.replace(st, handle=h)

    def close(self, handle: TrussHandle) -> None:
        """Release a handle's retained state; further use raises."""
        if handle.closed:
            return
        handle.closed = True
        self._handles.pop(handle.hid, None)
        handle._inc = None

    def _resolve_handle(self, ticket_or_handle) -> TrussHandle:
        if isinstance(ticket_or_handle, TrussHandle):
            if ticket_or_handle.closed:
                raise ValueError(
                    f"handle {ticket_or_handle.hid} is closed")
            return ticket_or_handle
        ticket = int(ticket_or_handle)
        for i, p in enumerate(self._pending):
            if p.ticket == ticket:
                del self._pending[i]
                return self.open(p.E)
        raise KeyError(
            f"ticket {ticket!r} cannot be promoted to a handle: it is not "
            f"pending (already decomposed, collected, or unknown) — "
            f"open() the edges to get an updatable handle")

    # ------------------------------------------------------------ internals --
    def _size_class(self, g: CSRGraph, sup_size: int,
                    peel_size: int) -> SizeClass:
        n_pad = _next_pow2(g.n + 1) if self.table_mode == "device" else 0
        return SizeClass(max(_MIN_M_PAD, _next_pow2(g.m)),
                         _next_pow2(max(1, sup_size)),
                         _next_pow2(max(1, peel_size)), n_pad)

    def discard(self, ticket: int) -> None:
        """Drop a ticket without computing or collecting it (scheduler hook).

        Unknown tickets are ignored; removes the pending submission or the
        materialized result.
        """
        self._pending = [p for p in self._pending if p.ticket != ticket]
        self._results.pop(ticket, None)

    def bucket_of(self, ticket: int) -> SizeClass | None:
        """Size-class key of a still-pending ticket, else ``None``."""
        for p in self._pending:
            if p.ticket == ticket:
                return p.key
        return None

    @staticmethod
    def _unions(group: list[_Pending], mode: str) -> list[list[_Pending]]:
        """Split a bucket into runs whose union tables fit the int32 layout.

        A union's tables hold the sum of its graphs' rows, padded to a power
        of two; each run stays within ``support._MAX_TABLE`` after padding.
        The kernel peel (``mode="kernel"``) builds no peel table, so there
        only the support rows count.
        """
        runs: list[list[_Pending]] = [[]]
        sup = peel = 0
        for p in group:
            p_peel = 0 if mode == "kernel" else p.peel_size
            sup2, peel2 = sup + p.sup_size, peel + p_peel
            if runs[-1] and _next_pow2(max(sup2, peel2, 1)) > \
                    support_mod._MAX_TABLE:
                runs.append([])
                sup2, peel2 = p.sup_size, p_peel
            runs[-1].append(p)
            sup, peel = sup2, peel2
        return runs

    def _dispatch(self, group: list[_Pending], *, mode: str,
                  support_mode: str) -> list[np.ndarray]:
        """Decompose one bucket's graphs as disjoint unions → per-graph
        trussness in ``g.El`` row order.  The unions' peel levels and
        sub-levels go on the innermost open span (``engine.dispatch``)."""
        out = []
        levels = sublevels = 0
        for run in self._unions(group, mode):
            op = disjoint_union([p.g for p in run])
            res = pkt(op.g, chunk=self.chunk, mode=mode,
                      support_mode=support_mode, table_mode=self.table_mode,
                      support_site=False, device=self.device)
            levels += res.levels
            sublevels += res.sublevels
            for i in range(len(run)):
                out.append(res.trussness[op.edge_off[i]:op.edge_off[i + 1]])
        trace.set(levels=levels, sublevels=sublevels)
        return out

    def flush(self, only=None, *, mode: str | None = None,
              support_mode: str | None = None) -> None:
        """Decompose pending graphs, bucket by bucket.

        Args:
            only: optional iterable of :class:`SizeClass` keys — flush only
                the pending submissions in those buckets.  ``None`` flushes
                everything.
            mode: per-call peel-executor override (``None``: the engine's
                configured mode); results are bitwise identical across
                modes.
            support_mode: per-call support-executor override, same contract.

        Ordering contract: each bucket's results are materialized (and its
        submissions removed from the pending queue) only after its dispatch
        succeeds, in submission order within the bucket.  If a dispatch
        raises, that bucket's submissions *and every bucket not yet
        dispatched* remain pending — their tickets stay redeemable by a
        later ``flush``/``result``.
        """
        eff_mode = self.mode if mode is None else mode
        eff_support = self.support_mode if support_mode is None \
            else support_mode
        check_axis("mode", eff_mode, PEEL_MODES)
        check_axis("support_mode", eff_support, support_mod.SUPPORT_MODES)
        if not self._pending:
            return
        by_key: dict[SizeClass, list[_Pending]] = {}
        keys = None if only is None else set(only)
        for p in self._pending:
            if keys is None or p.key in keys:
                by_key.setdefault(p.key, []).append(p)
        if not by_key:
            return

        with trace.span("engine.flush"):
            for key, group in by_key.items():
                with trace.span("engine.dispatch", graphs=len(group)):
                    self._flush_bucket(key, group, eff_mode, eff_support)
        self.stats["flushes"] += 1

    def _flush_bucket(self, key: SizeClass, group: list[_Pending],
                      mode: str, support_mode: str) -> None:
        """Dispatch one bucket, then align and deliver its results."""
        warm = key in self.stats["buckets"]
        t0 = time.perf_counter()
        fault_point("flush", rung=mode)
        with count_launches() as counted:
            truss_rows = self._dispatch(group, mode=mode,
                                        support_mode=support_mode)
        trace.set(launches=dict(counted))
        launches = self.stats["bucket_launches"].setdefault(
            key, dict.fromkeys(counted, 0))
        for k, n in counted.items():
            launches[k] += n
        with trace.span("engine.align"):
            for p, t in zip(group, truss_rows):
                self._results[p.ticket] = align_to_input(
                    t.astype(np.int64), p.g, None, p.n, keys=p.in_keys)
        # only now is the bucket done: drop its submissions from the
        # pending queue (a dispatch failure above leaves them — and
        # every bucket after them — pending and retryable)
        done = {p.ticket for p in group}
        self._pending = [p for p in self._pending if p.ticket not in done]
        dt = time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["buckets"].add(key)
        self.stats["graphs_done"] += len(group)
        self.stats["graph_seconds"] += dt
        if warm:
            self.stats["warm_seconds"] += dt
            self.stats["warm_graphs"] += len(group)

    def flush_host(self, only=None) -> None:
        """Host-numpy flush: resolves the selected pending submissions with
        the pure-numpy reference decomposition (``core.ref.truss_numpy``),
        no device work at all.  Results are bitwise identical to
        :meth:`flush`; the same exception-safety contract applies.

        Args:
            only: optional iterable of :class:`SizeClass` keys, as in
                :meth:`flush`.
        """
        if not self._pending:
            return
        keys = None if only is None else set(only)
        group = [p for p in self._pending
                 if keys is None or p.key in keys]
        if not group:
            return
        t0 = time.perf_counter()
        fault_point("flush", rung="host")
        out = [align_to_input(truss_numpy(p.g.El), p.g, None, p.n,
                              keys=p.in_keys) for p in group]
        # commit only after every graph decomposed (exception safety)
        for p, truss in zip(group, out):
            self._results[p.ticket] = truss
        done = {p.ticket for p in group}
        self._pending = [p for p in self._pending if p.ticket not in done]
        self.stats["flushes"] += 1
        self.stats["graphs_done"] += len(group)
        self.stats["graph_seconds"] += time.perf_counter() - t0

    @property
    def throughput(self) -> float:
        """Graphs decomposed per second of engine compute.

        Based on warm dispatches only (buckets dispatched before); falls
        back to the all-in rate until any bucket has gone warm.
        """
        if self.stats["warm_seconds"] > 0:
            return self.stats["warm_graphs"] / self.stats["warm_seconds"]
        secs = self.stats["graph_seconds"]
        return self.stats["graphs_done"] / secs if secs > 0 else 0.0


def truss_batched(graphs, *, mode: str = "kernel",
                  support_mode: str = "kernel", table_mode: str = "device",
                  chunk: int | None = None, reorder: bool = True,
                  device="cuda") -> list[np.ndarray]:
    """One-shot convenience: decompose a list of edge arrays, order-aligned."""
    graphs = list(graphs)
    eng = TrussEngine(mode=mode, support_mode=support_mode,
                      table_mode=table_mode, chunk=chunk, reorder=reorder,
                      max_pending=len(graphs) or 1, device=device)
    return eng.map(graphs)
