"""Parallel edge-support computation — the AM4 (Algorithm 3) adaptation.

The paper orients edges by increasing k-core vertex order and counts each
triangle once in canonical order, using a thread-local scratch array for
O(1) membership tests.  The port keeps the JAX package's adaptation
(DESIGN.md §2):

  * a *flat oriented wedge table*: one row per (oriented edge (u→v),
    candidate w ∈ N⁺(v)) pair — exactly the wedges the AM4 loop nest
    inspects;
  * a *ranged binary search* of w in N⁺(u) (sorted CSR rows) — the
    membership test;
  * integer scatter-adds into S — the three AtomicAdds, exact in any order.

Two executors (``compute_support(mode=...)``), bitwise identical:

  mode="kernel" (default): ``kernels/support.py`` — the hand-written CUDA
      kernel on the card, its plain PyTorch version on CPU tensors.  It
      reads the wedges from the CSR; no table is built.
  mode="torch": the torch-op port of the JAX package's flat jnp executor
      over the wedge table, walked in slices of ``wedge_common.SLICE_ROWS``
      rows.

and, for the torch executor, two places to build the table
(``table_mode``): "device" builds the rows on the device from the CSR
arrays (DESIGN.md §10), "numpy" on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels import wedge_common
from repro_torch.kernels.wedge_common import (chunk_layout, next_pow2,
                                              pad_chunked, pow2_chunk, probe)

#: executors for the support phase; "kernel" = kernels/support.py
SUPPORT_MODES = ("torch", "kernel")

#: where wedge tables are constructed: "numpy" on the host (kept as the
#: parity oracle), "device" by the torch functions below
TABLE_MODES = ("numpy", "device")


def check_axis(name: str, value, allowed: tuple) -> None:
    """Raise ``ValueError`` unless the executor-axis argument ``name`` is
    one of ``allowed`` (``PEEL_MODES``, ``SUPPORT_MODES``, ...)."""
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class WedgeTable:
    """Flat (edge, candidate-slot) table + per-query search ranges."""

    e1: np.ndarray       # (Nw,) int32 — edge id of (u, v)
    cand_slot: np.ndarray  # (Nw,) int32 — CSR slot of w (gives w and Eid e2)
    lo: np.ndarray       # (Nw,) int32 — probe range start in N
    hi: np.ndarray       # (Nw,) int32 — probe range end in N
    off: np.ndarray      # (m+1,) int64 — entries of edge e at [off[e], off[e+1])

    @property
    def size(self) -> int:
        """Number of wedge entries (Nw)."""
        return int(self.e1.shape[0])


def build_support_table(g: CSRGraph) -> WedgeTable:
    """Oriented wedge table: for edge (u,v), candidates w ∈ N⁺(v), probe N⁺(u)."""
    u = g.El[:, 0].astype(np.int64)
    v = g.El[:, 1].astype(np.int64)
    Es = g.Es.astype(np.int64)
    Eo = g.Eo.astype(np.int64)
    cnt = Es[v + 1] - Eo[v]                      # |N⁺(v)| per edge
    off = np.zeros(g.m + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    Nw = int(off[-1])
    e1 = np.repeat(np.arange(g.m, dtype=np.int64), cnt)
    intra = np.arange(Nw, dtype=np.int64) - off[e1]
    cand_slot = Eo[v[e1]] + intra
    lo = Eo[u[e1]]
    hi = Es[u[e1] + 1]
    return WedgeTable(
        e1=e1.astype(np.int32),
        cand_slot=cand_slot.astype(np.int32),
        lo=lo.astype(np.int32),
        hi=hi.astype(np.int32),
        off=off,
    )


def build_peel_table(g: CSRGraph) -> WedgeTable:
    """Full-adjacency wedge table used by the peel phase.

    For edge e=(u,v): candidates w from the *smaller*-degree endpoint's full
    adjacency, probed against the other endpoint's full adjacency — the
    ProcessSubLevel loop nest of Algorithm 5 with the cheap side chosen.
    """
    u = g.El[:, 0].astype(np.int64)
    v = g.El[:, 1].astype(np.int64)
    Es = g.Es.astype(np.int64)
    deg = (Es[1:] - Es[:-1])
    swap = deg[u] > deg[v]
    cand = np.where(swap, v, u)                  # scan this side
    probe_v = np.where(swap, u, v)               # binary-search this side
    cnt = deg[cand]
    off = np.zeros(g.m + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    Nw = int(off[-1])
    e1 = np.repeat(np.arange(g.m, dtype=np.int64), cnt)
    intra = np.arange(Nw, dtype=np.int64) - off[e1]
    cand_slot = Es[cand[e1]] + intra
    lo = Es[probe_v[e1]]
    hi = Es[probe_v[e1] + 1]
    return WedgeTable(
        e1=e1.astype(np.int32),
        cand_slot=cand_slot.astype(np.int32),
        lo=lo.astype(np.int32),
        hi=hi.astype(np.int32),
        off=off,
    )


# --- device-side table construction (DESIGN.md §10) -------------------------
#
# The torch mirrors below build the same rows on the device from the CSR
# arrays alone: per-edge candidate counts, segment offsets via cumsum, and
# the row→edge assignment as one ``searchsorted`` over the offset array.
# Rows are materialized to a pow2-padded ``size`` with the inert-padding
# contract of ``wedge_common.pad_chunked``: anchor sentinel ``m``, empty
# probe range ``lo == hi == 0``.  Every intermediate is int32, as in the
# JAX package (``cumsum`` and ``searchsorted`` are asked for int32 output).

#: device tables carry int32 offsets; reject anything larger outright
_MAX_TABLE = np.iinfo(np.int32).max


def support_table_size(g: CSRGraph) -> int:
    """Exact entry count of ``build_support_table(g)`` — O(m) host work."""
    if g.m == 0:
        return 0
    v = g.El[:, 1].astype(np.int64)
    return int((g.Es.astype(np.int64)[v + 1] - g.Eo.astype(np.int64)[v]).sum())


def peel_table_size(g: CSRGraph) -> int:
    """Exact entry count of ``build_peel_table(g)`` — O(m) host work."""
    if g.m == 0:
        return 0
    Es = g.Es.astype(np.int64)
    deg = Es[1:] - Es[:-1]
    return int(np.minimum(deg[g.El[:, 0]], deg[g.El[:, 1]]).sum())


def _check_table_size(size: int) -> None:
    """Guard the int32 device-table layout.

    ``size`` must be the number of rows the table build will *materialize* —
    the padded size, not the raw entry count.
    """
    if size > _MAX_TABLE:
        raise ValueError(
            f"wedge table of {size} (padded) entries exceeds the int32 "
            f"device-table layout; use table_mode='numpy' (int64 host "
            f"offsets)")


def _expand_segments(off: torch.Tensor, size: int, m: int, start: int = 0):
    """Row → segment assignment for a cumsum offset array ``off`` (m+1,).

    Returns ``(e1, e1c, intra, valid)`` for the ``size`` rows from row
    ``start`` on: the owning segment of each row (``m`` for rows beyond
    ``off[m]``), a clamped variant safe as a gather index, the offset within
    the segment, and the validity mask.
    """
    idx = torch.arange(start, start + size, dtype=torch.int32,
                       device=off.device)
    e1 = torch.searchsorted(off[1:], idx, right=True, out_int32=True)
    e1c = e1.clamp(max=m - 1)
    valid = idx < off[m]
    intra = idx - off[e1c]
    del idx
    e1 = torch.where(valid, e1, m)
    return e1, e1c, intra, valid


def _offsets(cnt: torch.Tensor) -> torch.Tensor:
    """(m+1,) int32 exclusive-prefix offsets of per-edge counts."""
    off = torch.zeros(cnt.shape[0] + 1, dtype=torch.int32, device=cnt.device)
    torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
    return off


def _build_support_table_dev(u, v, Es, Eo, m_real: int, *, m: int,
                             size: int, start: int = 0):
    """Device mirror of ``build_support_table`` at padded ``size``.

    ``u``/``v``: (m,) edge endpoints (rows >= ``m_real`` are inert padding);
    ``Es``: (n_pad+1,) CSR offsets; ``Eo``: (n_pad,).  Returns
    ``(e1, cand_slot, lo, hi, off)`` with the pad_chunked sentinel contract;
    ``start`` builds only rows ``[start, start + size)`` (one rank's slice).
    """
    ar = torch.arange(m, dtype=torch.int32, device=u.device)
    cnt = torch.where(ar < m_real, Es[v + 1] - Eo[v], 0)
    off = _offsets(cnt)
    e1, e1c, intra, valid = _expand_segments(off, size, m, start)
    cand = torch.where(valid, Eo[v[e1c]] + intra, 0)
    del intra
    uc = u[e1c]
    del e1c
    lo = torch.where(valid, Eo[uc], 0)
    hi = torch.where(valid, Es[uc + 1], 0)
    return e1, cand, lo, hi, off


def _build_peel_table_dev(u, v, Es, m_real: int, *, m: int, size: int,
                          chunk: int, start: int = 0):
    """Device mirror of ``build_peel_table`` + per-edge chunk-range metadata.

    Same row semantics as ``build_peel_table``; also emits the ``chunk_ranges``
    bookkeeping for ``chunk`` so the peel's chunk skipping needs no host
    pass.  Returns ``(e1, cand_slot, lo, hi, off, c_start, c_end,
    has_entries)``; ``start`` builds only rows ``[start, start + size)``
    (one rank's slice; the chunk metadata stays global).
    """
    deg = Es[1:] - Es[:-1]
    swap = deg[u] > deg[v]
    cand_v = torch.where(swap, v, u)              # scan this side
    prob_v = torch.where(swap, u, v)              # binary-search this side
    ar = torch.arange(m, dtype=torch.int32, device=u.device)
    cnt = torch.where(ar < m_real, deg[cand_v], 0)
    off = _offsets(cnt)
    e1, e1c, intra, valid = _expand_segments(off, size, m, start)
    cand = torch.where(valid, Es[cand_v[e1c]] + intra, 0)
    del intra
    pc = prob_v[e1c]
    del e1c
    lo = torch.where(valid, Es[pc], 0)
    hi = torch.where(valid, Es[pc + 1], 0)
    has = off[1:] > off[:-1]
    c_start = torch.div(off[:-1], chunk, rounding_mode="floor")
    c_end = torch.div((off[1:] - 1).clamp(min=0), chunk, rounding_mode="floor")
    return e1, cand, lo, hi, off, c_start, c_end, has


def _support_device(g: CSRGraph, *, mode: str, chunk: int | None,
                    device: torch.device):
    """Support phase on the device; returns (m,) int32 on ``device`` (no
    host round-trip — ``pkt`` feeds it to the peel).

    ``mode="kernel"`` reads the CSR (``kernels/support.py``) and builds no
    table; ``mode="torch"`` builds the oriented table on the device and runs
    the torch executor over it.  Both refuse the graphs whose padded table
    would overflow the int32 layout, as the JAX package does.
    """
    size = support_table_size(g)
    if size == 0:
        return torch.zeros(g.m, dtype=torch.int32, device=device)
    size_pad = next_pow2(size)
    _check_table_size(size_pad)
    dev = g.device_arrays(device)
    if mode == "kernel":
        from repro_torch.kernels.support import support_accumulate

        chunk_eff = pow2_chunk(size_pad, chunk, size=size)
        S, _ = support_accumulate(
            dev["u"], dev["v"], dev["Es"], dev["Eo"], dev["N"], dev["Eid"],
            m=g.m, chunk=chunk_eff, n_chunks=size_pad // chunk_eff)
        S = S[:g.m]
    else:
        e1, cand, lo, hi, _ = _build_support_table_dev(
            dev["u"], dev["v"], dev["Es"], dev["Eo"], g.m, m=g.m,
            size=size_pad)
        S = _support_torch(dev["N"], dev["Eid"], e1, cand, lo, hi,
                           _search_iters(g, oriented=True), g.m)
    return S


def _search_iters(g: CSRGraph, *, oriented: bool = False) -> int:
    """Binary-search iteration bound = log2(max probe-range length).

    The support path probes only N⁺(u) ranges, whose length is bounded by
    the degeneracy after the coreness relabeling — where the paper's
    ordering win lands in this adaptation.  The peel path probes full
    adjacencies."""
    d = g.dplus if oriented else g.degrees
    dmax = int(d.max(initial=1))
    return max(1, int(np.ceil(np.log2(dmax + 1))) + 1)


def _support_torch(N, Eid, e1, cand_slot, lo, hi, iters: int, m: int):
    """The torch-op support executor (the JAX package's ``_support_jit``)."""
    S = torch.zeros(m, dtype=torch.int32, device=N.device)
    for start, stop in wedge_common.row_slices(e1.shape[0]):
        c = cand_slot[start:stop]
        hit, safe = probe(N, c, lo[start:stop], hi[start:stop], iters=iters)
        # the hits only: a miss (or a padding row, anchor m) adds nothing,
        # where the JAX package adds its 0 to one slot
        idx = torch.nonzero(hit)[:, 0]
        ones = torch.ones(idx.shape[0], dtype=torch.int32, device=N.device)
        S.index_add_(0, e1[start:stop][idx], ones)
        S.index_add_(0, Eid[c[idx]], ones)
        S.index_add_(0, Eid[safe[idx]], ones)
    return S


def _support_ros_torch(N, e1, cand_slot, lo, hi, iters: int, m: int):
    """The torch-op Ros executor (the JAX package's ``_support_ros_jit``):
    each hit adds 1 at its anchor only."""
    S = torch.zeros(m, dtype=torch.int32, device=N.device)
    for start, stop in wedge_common.row_slices(e1.shape[0]):
        hit, _ = probe(N, cand_slot[start:stop], lo[start:stop],
                       hi[start:stop], iters=iters)
        sel = e1[start:stop][hit]
        S.index_add_(0, sel, torch.ones_like(sel))
    return S


def compute_support(g: CSRGraph, table: WedgeTable | None = None, *,
                    mode: str = "kernel", chunk: int | None = None,
                    table_mode: str | None = None,
                    device="cuda") -> np.ndarray:
    """Edge support (triangles per edge) via the AM4 adaptation. Returns (m,).

    ``mode`` selects the executor (``SUPPORT_MODES``, see the module
    docstring); ``chunk`` the table chunk size (auto-derived from the table
    size when None).  ``table_mode`` selects where the torch executor's
    wedge table is built (``TABLE_MODES``): "device" (the default when no
    prebuilt ``table`` is passed) or "numpy"; the kernel executor reads the
    CSR and ignores ``table`` and ``table_mode``.  ``device`` is where the
    executor runs: "cuda" by
    default (raises when no card is present), "cpu" on request.
    """
    check_axis("mode", mode, SUPPORT_MODES)
    if table_mode is None:
        table_mode = "numpy" if table is not None else "device"
    check_axis("table_mode", table_mode, TABLE_MODES)
    device = resolve_device(device)
    if g.m == 0:
        return np.zeros(0, np.int32)
    if mode == "kernel" or (table_mode == "device" and table is None):
        # the kernel reads the CSR: no table, wherever it would be built
        S = _support_device(g, mode=mode, chunk=chunk, device=device)
        return S.cpu().numpy()
    if table is None:
        table = build_support_table(g)
    if table.size == 0:
        # triangle-free under the orientation (e.g. stars): nothing to probe
        return np.zeros(g.m, np.int32)
    chunk_eff, n_chunks = chunk_layout(table.size, chunk)
    arrays = pad_chunked(table.e1, table.cand_slot, table.lo, table.hi,
                         m=g.m, chunk=chunk_eff, n_chunks=n_chunks)
    e1, cand, lo, hi = (torch.tensor(a, device=device) for a in arrays)
    dev = g.device_arrays(device)
    S = _support_torch(dev["N"], dev["Eid"], e1, cand, lo, hi,
                       _search_iters(g, oriented=True), g.m)
    return S.cpu().numpy()


# --- Ros (Algorithm 2) support computation: edge-based, unordered -----------
#
# For each edge (u,v) the FULL adjacencies are intersected (no orientation),
# so every triangle is counted once *per edge* (3x total work vs AM4 — the
# paper's Σ d(v)^2 vs Σ d⁺(v)^2 gap). Kept as the baseline for Table 2/3.

def compute_support_ros(g: CSRGraph, table: WedgeTable | None = None, *,
                        device="cuda") -> np.ndarray:
    """Ros-style support: per-edge full intersection (work ∝ Σ d(v)^2).

    Probes the peel table (``build_peel_table``'s rows), built on the device
    unless a host ``table`` is given, and adds each hit at its anchor edge.
    ``device`` is "cuda" (the default; raises when no card is present) or
    "cpu".
    """
    device = resolve_device(device)
    if g.m == 0:
        return np.zeros(0, np.int32)
    dev = g.device_arrays(device)
    if table is None:
        size = peel_table_size(g)
        if size == 0:
            return np.zeros(g.m, np.int32)
        _check_table_size(size)
        e1, cand, lo, hi, *_ = _build_peel_table_dev(
            dev["u"], dev["v"], dev["Es"], g.m, m=g.m, size=size, chunk=size)
    else:
        e1, cand, lo, hi = (torch.tensor(a, device=device) for a in
                            (table.e1, table.cand_slot, table.lo, table.hi))
    S = _support_ros_torch(dev["N"], e1, cand, lo, hi, _search_iters(g), g.m)
    return S.cpu().numpy()


def triangle_count(g: CSRGraph, *, device="cuda") -> int:
    """Total triangles = sum(S)/3."""
    S = compute_support(g, device=device)
    return int(S.sum()) // 3
