"""CSR graph container mirroring the paper's Figure 2 data structures.

The decomposition algorithms never touch an adjacency hash table; everything is
driven by these arrays (paper §3, "Unlike other k-core and k-truss algorithms,
we do not use a hash table"):

  Es  : (n+1,) int32   CSR row offsets
  N   : (2m,)  int32   CSR column indices (sorted per row)
  Eid : (2m,)  int32   edge id of each adjacency slot (both slots of an edge
                       share one id in [0, m))
  El  : (m, 2) int32   edge endpoints, El[e] = (u, v) with u < v
  Eo  : (n,)   int32   first slot j in [Es[u], Es[u+1]) with N[j] > u
  S   : (m,)   int32   edge support (filled by support computation)

Persistent footprint with 4-byte ints: (n+1) + 2m + 2m + 2m + n = 28m + 8n
bytes, matching the paper's accounting.

The arrays stay host numpy, as in the JAX package; ``device_arrays(device)``
hands out torch copies, uploaded once per graph and device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import trace


#: Largest vertex-id space for which ``lo * n + hi`` key packing stays inside
#: int64: floor(sqrt(2**63 - 1)).  The CSR arrays themselves are int32, so the
#: effective vertex-id bound is the tighter ``_MAX_N`` below — but any caller
#: packing keys with a caller-supplied ``n`` must respect this one too.
MAX_PACK_N = 3_037_000_499
#: CSR layout bound: vertex ids live in int32 columns (Fig. 2 arrays).
_MAX_N = np.iinfo(np.int32).max


def check_edge_array(edges) -> np.ndarray:
    """Validate a user-supplied edge array; returns it as (k, 2) int64.

    Rejects (with a descriptive ValueError) anything the downstream key
    packing or CSR build would otherwise silently corrupt: non-integer
    dtypes, shapes other than (k, 2), negative vertex ids (which corrupt the
    ``lo * n + hi`` packing), vertex ids beyond the int32 CSR layout, and
    self-loop rows.  Empty inputs of any shape pass through as (0, 2).
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        return np.zeros((0, 2), np.int64)
    if not np.issubdtype(edges.dtype, np.integer):
        raise ValueError(
            f"edges must have an integer dtype, got {edges.dtype}")
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (k, 2), got shape {edges.shape}")
    edges = edges.astype(np.int64, copy=False)
    vmin, vmax = int(edges.min()), int(edges.max())
    if vmin < 0:
        bad = edges[(edges < 0).any(axis=1)][0]
        raise ValueError(
            f"negative vertex ids are not allowed (e.g. edge "
            f"({bad[0]}, {bad[1]})): they corrupt the lo*n+hi key packing")
    if vmax >= _MAX_N:
        raise ValueError(
            f"vertex id {vmax} exceeds the int32 CSR layout bound "
            f"({_MAX_N - 1}); relabel vertices to a compact id space "
            f"(key packing itself overflows int64 beyond n={MAX_PACK_N})")
    if (edges[:, 0] == edges[:, 1]).any():
        v = int(edges[edges[:, 0] == edges[:, 1]][0, 0])
        raise ValueError(f"self-loops are not allowed (vertex {v})")
    return edges


def edge_keys(lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """Pack canonical (lo < hi) endpoint pairs into unique int64 keys.

    The single blessed home for the ``lo * n + hi`` packing (trusslint
    J003): operands are widened to int64 *before* the multiply and both
    the pack space and the ids are bounds-checked, so a key can never
    wrap silently — ``n <= MAX_PACK_N`` implies ``n*n - 1 < 2**63``.
    """
    n = int(n)
    if n > MAX_PACK_N:
        raise ValueError(
            f"n={n} overflows int64 lo*n+hi key packing (max {MAX_PACK_N})")
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    if lo.size:
        vmin = min(int(lo.min()), int(hi.min()))
        vmax = max(int(lo.max()), int(hi.max()))
        if vmin < 0 or vmax >= n:
            raise ValueError(
                f"vertex ids must lie in [0, n={n}) for lo*n+hi key "
                f"packing; got range [{vmin}, {vmax}] — keys would "
                f"collide or wrap")
    return lo.astype(np.int64) * n + hi


def canonical_edges_with_rows(edges) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray, int]:
    """Validate + canonicalize, keeping per-input-row endpoint order.

    Returns ``(E, lo, hi, n)``: ``E`` the unique canonical (u < v) edge array
    sorted by key, ``lo``/``hi`` the canonical endpoints of every *input row*
    (so callers can map deduped results back to their own row order), and
    ``n`` the vertex-id space.  The validation of ``check_edge_array``
    applies (self-loops, negatives, huge ids all rejected).
    """
    with trace.span("csr.canonical"):
        edges = check_edge_array(edges)
        trace.set(m=len(edges))
        if edges.size == 0:
            return (np.zeros((0, 2), np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), 0)
        n = int(edges.max()) + 1
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        uniq = np.unique(edge_keys(lo, hi, n))
        E = np.stack([uniq // n, uniq % n], axis=1)
        return E, lo, hi, n


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected simple graph in the paper's array layout (host numpy)."""

    n: int
    m: int
    Es: np.ndarray   # (n+1,) int32
    N: np.ndarray    # (2m,) int32
    Eid: np.ndarray  # (2m,) int32
    El: np.ndarray   # (m, 2) int32
    Eo: np.ndarray   # (n,) int32
    #: lazy per-graph, per-device cache of tensor copies (``device_arrays``); a
    #: mutable field on a frozen dataclass so repeated decompositions of one
    #: graph share uploads without the graph itself becoming mutable
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def device_arrays(self, device) -> dict:
        """Torch copies of the CSR arrays on ``device``, uploaded once.

        Every decomposition entry point (``pkt``, ``compute_support``, the
        engine) gathers against ``N``/``Eid`` and builds its wedge tables
        from ``Es``/``Eo``/``El`` on the device; the cache keeps repeated
        calls on one graph from uploading the same arrays again.  Keys:
        ``N, Eid, Es, Eo, El`` plus ``u, v`` (the two columns of ``El`` as
        contiguous vectors).  Cached per device, so a graph can serve a CPU
        test and a GPU run in one process.
        """
        key = str(torch.device(device))
        if key not in self._dev:
            dev = torch.device(device)

            def up(a):
                return torch.tensor(np.ascontiguousarray(a), device=dev)  # a copy

            self._dev[key] = dict(
                N=up(self.N), Eid=up(self.Eid), Es=up(self.Es), Eo=up(self.Eo),
                El=up(self.El), u=up(self.El[:, 0]), v=up(self.El[:, 1]))
        return self._dev[key]

    @property
    def degrees(self) -> np.ndarray:
        """Vertex degrees (int32)."""
        return (self.Es[1:] - self.Es[:-1]).astype(np.int32)

    @property
    def dplus(self) -> np.ndarray:
        """Out-degree under the id orientation: |{w in N(u) : w > u}|."""
        return (self.Es[1:] - self.Eo).astype(np.int32)

    def wedge_count(self) -> int:
        """Number of wedges (paths of length two) in the graph."""
        d = self.degrees.astype(np.int64)
        return int((np.sum(d * d) - 2 * self.m) // 2)

    def work_estimate_oriented(self) -> int:
        """Sum of d+(v)^2 — the ordering-aware work estimate of Table 2."""
        dp = self.dplus.astype(np.int64)
        return int(np.sum(dp * dp))

    def work_estimate_oblivious(self) -> int:
        """Sum of d(v)^2 — the ordering-oblivious work estimate of Table 2."""
        d = self.degrees.astype(np.int64)
        return int(np.sum(d * d))

    def validate(self) -> None:
        """Check the Fig. 2 layout invariants (tiny graphs: O(n) Python loop)."""
        assert self.Es.shape == (self.n + 1,)
        assert self.Es[0] == 0 and self.Es[-1] == 2 * self.m
        assert self.N.shape == (2 * self.m,)
        assert self.Eid.shape == (2 * self.m,)
        assert self.El.shape == (self.m, 2)
        assert self.Eo.shape == (self.n,)
        # per-row sorted, no self loops, no duplicates
        for u in range(self.n):
            row = self.N[self.Es[u]:self.Es[u + 1]]
            assert np.all(np.diff(row) > 0), f"row {u} not strictly sorted"
            assert not np.any(row == u), f"self loop at {u}"
        assert np.all(self.El[:, 0] < self.El[:, 1])


def edges_from_arrays(src: np.ndarray, dst: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """Canonicalize a (possibly directed, loopy, duplicated) edge array.

    Returns unique undirected edges as an (m, 2) int64 array with u < v —
    the paper's preprocessing ("made undirected ... removed self loops and
    duplicate edges").
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    if n is None:
        n = int(max(lo.max(initial=-1), hi.max(initial=-1)) + 1) if lo.size else 0
    key = np.unique(edge_keys(lo, hi, n))
    return np.stack([key // n, key % n], axis=1)


def build_csr(edges: np.ndarray, n: Optional[int] = None) -> CSRGraph:
    """Build the full Fig. 2 structure from canonical (m,2) u<v edges."""
    with trace.span("csr.build", m=len(edges)):
        edges = np.asarray(edges)
        if edges.size == 0:
            n = int(n or 0)
            return CSRGraph(
                n=n, m=0,
                Es=np.zeros(n + 1, np.int32), N=np.zeros(0, np.int32),
                Eid=np.zeros(0, np.int32), El=np.zeros((0, 2), np.int32),
                Eo=np.zeros(n, np.int32),
            )
        assert edges.ndim == 2 and edges.shape[1] == 2
        assert np.all(edges[:, 0] < edges[:, 1]), \
            "edges must be canonical u < v"
        if n is None:
            n = int(edges.max() + 1)
        m = edges.shape[0]

        # Edge ids follow lexicographic (u, v) order so that "lower edge id"
        # is a stable total order (the tie-break used in concurrent
        # triangle processing).
        order = np.lexsort((edges[:, 1], edges[:, 0]))
        El = edges[order].astype(np.int32)

        # Symmetrize with edge ids attached to both directions.
        eid = np.arange(m, dtype=np.int32)
        src = np.concatenate([El[:, 0], El[:, 1]])
        dst = np.concatenate([El[:, 1], El[:, 0]])
        ids = np.concatenate([eid, eid])

        # CSR by (src, dst) sort.
        perm = np.lexsort((dst, src))
        src, dst, ids = src[perm], dst[perm], ids[perm]
        counts = np.bincount(src, minlength=n).astype(np.int64)
        Es = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=Es[1:])

        # Eo: first slot with neighbor > row vertex (adjacency sorted
        # ascending): the row's start plus its neighbors below it
        Eo = Es[:-1] + np.bincount(src[dst < src], minlength=n)

        g = CSRGraph(
            n=n, m=m,
            Es=Es.astype(np.int32),
            N=dst.astype(np.int32),
            Eid=ids.astype(np.int32),
            El=El,
            Eo=Eo.astype(np.int32),
        )
        return g


def relabel(edges: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Relabel endpoints by perm (old id -> new id) and re-canonicalize.

    Used for k-core ordering (KCO): perm[v] = rank of v in increasing coreness
    order, so after relabel the id orientation coincides with core orientation.
    """
    with trace.span("csr.relabel", m=len(edges)):
        e = perm[edges]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        return np.stack([lo, hi], axis=1)


def degree_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Degree-based vertex permutation (cheaper alternative ordering)."""
    deg = np.bincount(edges.ravel(), minlength=n)
    order = np.lexsort((np.arange(n), deg))
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm
