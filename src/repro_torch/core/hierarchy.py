"""Truss community index — the nested triangle-connected k-truss hierarchy.

The port of the JAX package's ``core/hierarchy.py`` (DESIGN.md §11).  A
*k-truss community* is a triangle-connected component of the edges with
trussness >= k (Wang & Cheng): two edges belong together iff a chain of
triangles, every edge of which survives at level k, links them.  The
components nest as k grows (Sariyuce et al.), so the serving structure is
one index per decomposition, queried many times:

  * **Per-level labels** — for each level k in [2, k_max], every live edge
    (trussness >= k) carries the id of the *minimum edge in its
    triangle-connected component*.  The min-id representative makes the
    labeling canonical: any correct builder produces bitwise-identical
    arrays, which is what the device/host parity checks compare.
  * **Parent links** — level-k communities refine level-(k-1) communities,
    so each community's parent is the (k-1)-label of its representative.
  * **Two builders, one contract**: ``mode="device"`` floods min-labels over
    the triangle rows with torch ops on the device (gather, three
    ``scatter_reduce_(…, "amin")``, pointer jump, looped to the fixed
    point); ``build_all`` sweeps the levels finest first, each warm-started
    from the next-finer labels, and a host pre-check skips the dispatch
    when the warm labels are already the fixed point (DESIGN.md §16).
    ``mode="host"`` is the independent union-find oracle (union-by-min
    over triangles sorted by level, shared across levels top-down).

The flood differs from the JAX package's in one way that changes no label.
The reference pads the label array and the level-sorted triangle table to
size classes (to bound XLA's compile cache) and sends masked rows to a
spare sink slot; on the GPU one address collecting masked updates
serializes the card.  Here each flood runs on exactly the rows that entered
between the warm level and this one — a slice of the level-sorted table,
every row active — with no padding and no sink.  Rows finer than the slice
already share one flat warm label and are no-ops; the fixed point is the
component minima from any in-component lower bound, whatever rows the
flood visits (DESIGN.md §16).  ``flood_rounds`` counts the rounds (one host
read each).

Triangle connectivity comes from the decomposition's triangle list
(``core.truss_inc.triangle_list``), which incremental handles maintain
across updates; ``core/truss_inc.py`` keeps a handle's index alive across
``update`` batches through ``TrussHierarchy.remapped``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.support import check_axis
from repro_torch.device import resolve_device
from repro_torch.testing.chaos import fault_point

#: where per-level labels are computed: the label flood on the device (the
#: serving path) or the independent host union-find (the parity oracle)
HIER_MODES = ("device", "host")


# ------------------------------------------------------- device label flood --

def _labelprop(tri: torch.Tensor, L0: torch.Tensor) -> tuple[torch.Tensor,
                                                             int]:
    """Min-label flood over the *representative graph* to the fixed point.

    ``tri`` (w, 3) edge ids on the device — every row active at this level;
    ``L0`` (m,) int64 initial labels on the same device (live edges: any
    in-component id <= their own; dead edges: themselves).  Each round
    gathers every row's representatives ``r = L[tri]``, scatter-mins the
    row's 3-way representative-label minimum into ``L[r]`` (the union step
    on the component graph), then pointer-jumps ``L <- min(L, L[L])``.
    Labels only decrease and always point at in-component ids, so the fixed
    point is the flat component-minimum labeling.  Returns ``(L, rounds)``;
    each round costs one host read (the loop test).
    """
    L = L0
    rounds = 0
    while True:
        r = L[tri]
        lm = L[r].amin(dim=1)
        L2 = L.clone()
        L2.scatter_reduce_(0, r.reshape(-1),
                           lm.repeat_interleave(3), reduce="amin")
        L2 = torch.minimum(L2, L2[L2])
        rounds += 1
        if torch.equal(L2, L):
            return L2, rounds
        L = L2


# Host-side flood seeding: active sets up to _SEED_ROWS_MAX rows run up to
# _SEED_ROUNDS of the flood body on the host, skipping the device dispatch
# entirely when the rounds reach the flood's fixed point.  Larger levels with
# a small *fresh* stratum still get one host round folded into their warm
# start.
_SEED_ROWS_MAX = 4096
_SEED_ROUNDS = 2


# ------------------------------------------------------ host union-find oracle

def _uf_find(parent: np.ndarray, x: int) -> int:
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return int(x)


def _uf_union_min(parent: np.ndarray, a: int, b: int) -> None:
    """Union with the *smaller root winning* — the component root is then
    always the component's minimum edge id, the canonical representative."""
    ra, rb = _uf_find(parent, a), _uf_find(parent, b)
    if ra != rb:
        if ra < rb:
            parent[rb] = ra
        else:
            parent[ra] = rb


def _uf_roots(parent: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Vectorized root lookup for an index array (no mutation needed for
    correctness; unions keep doing their own path compression)."""
    r = parent[idx]
    while True:
        rr = parent[r]
        if np.array_equal(rr, r):
            return r
        r = rr


def host_level_labels(m: int, trussness: np.ndarray, tri: np.ndarray,
                      tri_lvl: np.ndarray, k: int) -> np.ndarray:
    """One level's labels by a fresh union-find — the standalone oracle."""
    labels = np.full(m, -1, np.int64)
    live = np.nonzero(trussness >= k)[0]
    if live.size == 0:
        return labels
    parent = np.arange(m, dtype=np.int64)
    for a, b, c in tri[tri_lvl >= k]:
        _uf_union_min(parent, int(a), int(b))
        _uf_union_min(parent, int(a), int(c))
    labels[live] = _uf_roots(parent, live)
    return labels


# --------------------------------------------------------------- the index --

class TrussHierarchy:
    """Nested k-truss community index over one finished decomposition.

    Construct from per-edge ``trussness`` (aligned to the graph's canonical
    edge rows) and the (T, 3) triangle list in the same edge-id space.
    Levels are k = 2 .. ``k_max``; each builds lazily on first access and is
    cached.  ``stats`` counts the work done (levels built per mode, levels
    carried across updates by remap, levels skipped as converged or closed
    by host seed rounds); ``flood_rounds`` counts the device flood's rounds.

    Args:
        trussness: (m,) per-edge trussness.
        triangles: (T, 3) edge-id rows.
        mode: label builder, one of ``HIER_MODES``.
        device: where the device flood runs: "cuda" (the default; raises
            when no card is present) or "cpu".

    Raises:
        ValueError: unknown ``mode`` or a triangle row beyond ``m``.
        RuntimeError: ``device`` is CUDA and no card is present.
    """

    def __init__(self, trussness: np.ndarray, triangles: np.ndarray, *,
                 mode: str = "device", device="cuda"):
        check_axis("mode", mode, HIER_MODES)
        self.mode = mode
        self.device = resolve_device(device)
        self.T = np.asarray(trussness, dtype=np.int64)
        self.m = int(self.T.shape[0])
        tri = np.asarray(triangles, dtype=np.int64)
        if tri.size == 0:
            tri = np.zeros((0, 3), np.int64)
        if tri.size and int(tri.max()) >= self.m:
            raise ValueError(
                f"triangle row references edge id {int(tri.max())} beyond "
                f"m={self.m}")
        self.tri = tri
        self.tri_lvl = (self.T[tri].min(axis=1) if tri.size
                        else np.zeros(0, np.int64))
        self.k_max = int(self.T.max(initial=1))
        self._labels: list[np.ndarray | None] = \
            [None] * max(0, self.k_max - 1)
        self._dev = None          # level-sorted triangle table, both sides
        self._uf = None           # (parent, order, ptr, k_at) host UF state
        self.stats = {"device_levels": 0, "host_levels": 0,
                      "remapped_levels": 0, "converged_levels": 0,
                      "seeded_levels": 0}
        self.flood_rounds = 0

    # ---------------------------------------------------------- level access

    @property
    def levels(self) -> range:
        """The populated levels: k = 2 .. k_max (empty when m == 0)."""
        return range(2, self.k_max + 1)

    def level_labels(self, k: int) -> np.ndarray:
        """(m,) int64 labels at level ``k``: for each edge with trussness
        >= k the minimum edge id of its triangle-connected component, else
        -1.  Built lazily (and cached) by the configured ``mode``."""
        k = int(k)
        if k < 2 or k > self.k_max:
            return np.full(self.m, -1, np.int64)
        li = k - 2
        if self._labels[li] is None:
            self._labels[li] = (self._build_device(k) if self.mode == "device"
                                else self._build_host(k))
        return self._labels[li]

    def build_all(self) -> "TrussHierarchy":
        """Materialize every level eagerly, finest (highest k) first.

        Device mode warm-starts every level from the next-finer labels and
        skips the dispatch when the convergence pre-check proves the warm
        start is already the fixed point; host mode extends the shared
        top-down union-find with exactly each level's own triangle stratum.
        """
        for k in sorted(self.levels, reverse=True):
            if self._labels[k - 2] is None:
                self.level_labels(k)
        return self

    # ------------------------------------------------------------- queries --

    def communities(self, k: int) -> list[np.ndarray]:
        """Sorted edge-id arrays of every level-``k`` community, ordered by
        representative (= minimum member) edge id."""
        labels = self.level_labels(k)
        live = np.nonzero(labels >= 0)[0]
        if live.size == 0:
            return []
        order = np.argsort(labels[live], kind="stable")
        live = live[order]
        cuts = np.nonzero(np.diff(labels[live]))[0] + 1
        return np.split(live, cuts)

    def community_of(self, edge_id: int, k: int) -> np.ndarray:
        """Edge ids of the level-``k`` community containing ``edge_id``
        (empty when the edge is below level k)."""
        labels = self.level_labels(k)
        edge_id = int(edge_id)
        if not 0 <= edge_id < self.m or labels[edge_id] < 0:
            return np.zeros(0, np.int64)
        return np.nonzero(labels == labels[edge_id])[0].astype(np.int64)

    def parents(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(reps, parent_reps): each level-``k`` community's representative
        and the representative of the level-(k-1) community containing it.
        At k == 2 the parents array equals the reps (no coarser level)."""
        labels = self.level_labels(k)
        reps = np.unique(labels[labels >= 0])
        if k <= 2 or reps.size == 0:
            return reps, reps.copy()
        return reps, self.level_labels(k - 1)[reps]

    # ------------------------------------------------------- device builder --

    def _tables(self):
        """The triangle table sorted by level *descending* (stable), built
        once per hierarchy: ``(tri_dev, tri_host, n_ge)``.  The rows active
        at level ``k`` are the prefix ``[0, n_ge[k])``, and the rows that
        enter between a warm level ``j`` and ``k`` the slice
        ``[n_ge[j], n_ge[k])``.  The sort runs on the device; the host copy
        serves the pre-check and the seed rounds."""
        if self._dev is None:
            lvl = torch.from_numpy(self.tri_lvl).to(self.device)
            order = torch.sort(-lvl, stable=True).indices
            tri_dev = torch.from_numpy(
                np.ascontiguousarray(self.tri)).to(self.device)[order]
            tri_host = tri_dev.cpu().numpy()
            hist = np.bincount(self.tri_lvl, minlength=self.k_max + 2)
            # n_ge[k] = rows with level >= k, for k = 0 .. k_max + 1
            n_ge = np.cumsum(hist[::-1])[::-1]
            self._dev = (tri_dev.to(torch.int32), tri_host, n_ge)
        return self._dev

    def _n_ge(self, k: int) -> int:
        """Triangle rows with level >= ``k`` (0 above ``k_max``)."""
        if self.tri.shape[0] == 0 or k > self.k_max:
            return 0
        return int(self._tables()[2][k])

    def _warm_level(self, k: int) -> int:
        """Nearest already-built level finer than ``k`` (``k_max + 1`` when
        nothing finer is built — the cold, finest-level case)."""
        for jj in range(k + 1, self.k_max + 1):
            if self._labels[jj - 2] is not None:
                return jj
        return self.k_max + 1

    def _init_labels(self, k: int, j: int) -> np.ndarray:
        """Initial (m,) int64 labels for level ``k`` warm-started from
        level ``j`` (see ``_warm_level``): live edges take the finer
        level's labels where defined (in-component ids, so the flood only
        has fewer rounds to run); dead slots point at themselves."""
        L0 = np.arange(self.m, dtype=np.int64)
        if j <= self.k_max:
            warm = self._labels[j - 2]
            fine = warm >= 0
            L0[fine] = warm[fine]
        dead = self.T < k
        L0[dead] = np.nonzero(dead)[0]
        return L0

    def _build_device(self, k: int) -> np.ndarray:
        fault_point("hierarchy", rung="device")
        j = self._warm_level(k)
        lo, hi = self._n_ge(j), self._n_ge(k)
        if hi == lo:
            # Empty-stratum shortcut: no triangle enters between j and k,
            # so no merge is possible — level k's labels are level j's plus
            # self-labels for the newly live (triangle-isolated at k) edges.
            self.stats["converged_levels"] += 1
            if j <= self.k_max:
                labels = self._labels[j - 2].copy()
                newly = (self.T >= k) & (labels < 0)
            else:
                labels = np.full(self.m, -1, np.int64)
                newly = self.T >= k
            labels[newly] = np.nonzero(newly)[0]
            return labels
        L0 = self._init_labels(k, j)
        tri_dev, tri_host, _ = self._tables()
        if hi <= _SEED_ROWS_MAX:
            # Tiny active sets pay more in per-round dispatch latency than
            # their arithmetic is worth, so run up to _SEED_ROUNDS of the
            # *exact* flood body on the host, checking the flood's own
            # fixed-point condition between rounds (every active row's
            # representative labels homogeneous, L0 flat under the jump).
            # When the check passes the flood would return L0 unchanged;
            # when the rounds run out the seeded L0 goes to the device
            # flood, which converges to the canonical component minima from
            # any in-component lower bound (§16).
            tra = tri_host[:hi]
            for seeds in range(_SEED_ROUNDS + 1):
                r = L0[tra]
                rl = L0[r]
                lm = rl.min(axis=1)
                if (bool((lm == rl.max(axis=1)).all())
                        and bool((L0[L0] >= L0).all())):
                    key = "seeded_levels" if seeds else "converged_levels"
                    self.stats[key] += 1
                    return self._finish(L0, k)
                if seeds == _SEED_ROUNDS:
                    break
                np.minimum.at(L0, r.ravel(), np.repeat(lm, 3))
                np.minimum(L0, L0[L0], out=L0)
        else:
            # Convergence pre-check (host, O(rows newly active since the
            # warm level)): rows active at the warm level j share one warm
            # component minimum; if every *newly* active row is also
            # label-homogeneous under L0, the scatter-min pass cannot change
            # any label, and L0 is flat by construction, so L0 is the
            # flood's exact fixed point and the dispatch is skipped.
            rows = L0[tri_host[lo:hi]]
            if bool((rows.min(axis=1) == rows.max(axis=1)).all()):
                self.stats["converged_levels"] += 1
                return self._finish(L0, k)
            if rows.shape[0] <= _SEED_ROWS_MAX:
                # fold one flood round over the fresh stratum into the warm
                # start (spares the device its first merge round)
                rl = L0[rows]
                lm = rl.min(axis=1)
                np.minimum.at(L0, rows.ravel(), np.repeat(lm, 3))
                np.minimum(L0, L0[L0], out=L0)
        # Flood the fresh stratum [lo, hi) only: every row in it is active
        # at k, rows finer than it already share a flat warm label (no-ops),
        # and rows coarser than it are not active — no mask, no sink.  A
        # cold level (j = k_max + 1) has lo = 0: the whole active prefix.
        L, rounds = _labelprop(tri_dev[lo:hi],
                               torch.from_numpy(L0).to(self.device))
        self.flood_rounds += rounds
        self.stats["device_levels"] += 1
        return self._finish(L.cpu().numpy(), k)

    def _finish(self, L: np.ndarray, k: int) -> np.ndarray:
        labels = L[: self.m].astype(np.int64)
        labels[self.T < k] = -1
        return labels

    # --------------------------------------------------------- host builder --

    def _build_host(self, k: int) -> np.ndarray:
        """Shared top-down union-find: triangles sorted by level descending
        are unioned once in total across all levels; each level snapshot is
        a vectorized root lookup.  The shared state is only valid while
        requests descend — a request *above* the frontier answers from a
        fresh single-level union-find instead."""
        fault_point("hierarchy", rung="host")
        self.stats["host_levels"] += 1
        if self._uf is not None and k > self._uf["k_at"]:
            return host_level_labels(self.m, self.T, self.tri,
                                     self.tri_lvl, k)
        if self._uf is None:
            order = np.argsort(-self.tri_lvl, kind="stable")
            self._uf = {"parent": np.arange(self.m, dtype=np.int64),
                        "order": order, "ptr": 0,
                        "k_at": self.k_max + 1}
        uf = self._uf
        parent, order = uf["parent"], uf["order"]
        ptr = uf["ptr"]
        while ptr < order.size and self.tri_lvl[order[ptr]] >= k:
            a, b, c = self.tri[order[ptr]]
            _uf_union_min(parent, int(a), int(b))
            _uf_union_min(parent, int(a), int(c))
            ptr += 1
        uf["ptr"] = ptr
        uf["k_at"] = k
        labels = np.full(self.m, -1, np.int64)
        live = np.nonzero(self.T >= k)[0]
        if live.size:
            labels[live] = _uf_roots(parent, live)
        return labels

    # -------------------------------------------------- update survival ------

    def remapped(self, trussness: np.ndarray, triangles: np.ndarray,
                 old_to_new: np.ndarray, k_hi: int) -> "TrussHierarchy":
        """The index after a *local* repair touched nothing above ``k_hi``.

        ``old_to_new`` maps this index's edge ids to the post-update ids
        (-1 for deleted edges).  Levels k > ``k_hi`` keep their edge set and
        active-triangle set, so their partition survives verbatim and only
        the ids are translated; the surviving edges keep their relative
        order under the key-sorted id space, so the old component minimum
        maps onto the new one.  Levels <= ``k_hi`` come back dirty and
        rebuild lazily.
        """
        h = TrussHierarchy(trussness, triangles, mode=self.mode,
                           device=self.device)
        old_to_new = np.asarray(old_to_new, dtype=np.int64)
        for k in range(max(int(k_hi) + 1, 2), h.k_max + 1):
            old = (self._labels[k - 2]
                   if k - 2 < len(self._labels) else None)
            if old is None:
                continue
            src = np.nonzero(old >= 0)[0]
            dst = old_to_new[src]
            if dst.size and dst.min(initial=0) < 0:
                # defensive: a live-above-k_hi edge vanished — the caller's
                # k_hi was wrong; fall back to a dirty level
                continue
            lab = np.full(h.m, -1, np.int64)
            lab[dst] = old_to_new[old[src]]
            h._labels[k - 2] = lab
            h.stats["remapped_levels"] += 1
        return h


def hierarchy_from_graph(g, trussness: np.ndarray, *, mode: str = "device",
                         device="cuda") -> TrussHierarchy:
    """Index a plain (graph, trussness) pair — enumerates the triangle list
    first (on ``device``).  Handles (``TrussEngine.open``) skip this: they
    already maintain the triangle list incrementally."""
    from repro_torch.core.truss_inc import triangle_list

    return TrussHierarchy(trussness, triangle_list(g, device=device),
                          mode=mode, device=device)
