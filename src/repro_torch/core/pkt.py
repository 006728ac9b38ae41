"""PKT — level-synchronous parallel truss decomposition (paper Algorithms 4+5).

The PyTorch port of the JAX package's ``core/pkt.py`` (see DESIGN.md §2 for
the mapping from the OpenMP original):

  * SCAN            → dense masked compare over the support vector S
  * curr/next       → boolean frontier vectors (inCurr/processed); the "next"
                      buffer is recovered as  alive ∧ (S == l)  after update
  * atomicSub+clamp → per-wedge decrements folded with integer adds, then
                      S ← max(S − dec, l)  (identical fixed point, bitwise
                      deterministic)
  * tie-break       → the paper's "lowest frontier edge id processes the
                      triangle" predicate, evaluated per wedge hit
  * dynamic sched.  → a work list of the frontier's wedges (kernel), or
                      chunk skipping over the flat peel wedge table (torch)

Three peel executors (``mode`` / ``peel_mode``), bitwise identical:
  mode="kernel" (default): ``kernels/peel.py`` — hand-written CUDA
                 kernels on the card, their plain PyTorch versions on CPU
                 tensors.  Per sub-level: the decrement fold over the
                 frontier's work list, which reads the wedges from the CSR
                 (no peel table exists) and lists the edges it touches,
                 then the sparse state update that visits the old frontier
                 and those edges and forms the next frontier's work list
                 on the device; a dense pass starts each level.  On the
                 card a whole segment of levels is one launch.
  mode="chunked": torch ops over the rows of the table chunks that hold
                 frontier edges (``_active_chunk_mask``).
  mode="dense":  torch ops over the whole table every sub-level, masked.

The support phase has its own executor axis (``support_mode`` ∈
``core.support.SUPPORT_MODES``: "kernel", "torch").

**Where the loops run.**  The JAX package keeps the level and sub-level
loops on the device (``lax.while_loop``).  So does the kernel executor on
the card: one cooperative launch (``kernels/peel.py: peel_loop``) runs a
whole compaction segment — each level's start, its folds and sparse
updates, the level and segment tests — and the host reads
``[levels, sublevels, n_done, status]`` once at its end, then copies the
results.  On CPU tensors the same loop runs from the host
(``kernels/peel.py: host_loop``) and reads ``[#frontier, #processed]``
once per sub-level, as the torch executors (``mode="chunked"|"dense"``)
also do.  The level value ``l`` never leaves the device.

The peel runs over *extended* edge state: slot ``m`` is the sentinel, and
any edge slot marked processed in ``processed0`` with sentinel support in
``S_ext0`` is inert padding (compacted subproblems use this).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import prep
from repro_torch.core import support as support_mod
# ``preprocess`` and ``align_to_input`` are imported by name from here too
from repro_torch.core.prep import (align, align_to_input,  # noqa: F401
                                   prepare, preprocess)
from repro_torch.core.support import check_axis
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs.csr import CSRGraph, build_csr
from repro_torch.kernels import peel as peel_kernel
from repro_torch.kernels import wedge_common
from repro_torch.testing.chaos import fault_point

_SENTINEL_S = peel_kernel.SENTINEL_S

PEEL_MODES = ("chunked", "dense", "kernel")


class PeelCSR(NamedTuple):
    """What the kernel executor reads instead of a peel table: the edge
    endpoints and CSR offsets (pow2-padded in compacted subproblems), the
    size of the frontier work list, and the rows the peel table would
    hold."""

    u: torch.Tensor          # (m_out,) int32, padding slots 0
    v: torch.Tensor          # (m_out,) int32, padding slots 0
    Es: torch.Tensor         # (n_pad+1,) int32 CSR offsets
    work_cap: int            # work items the largest frontier can make
    peel_rows: int = 0       # the peel table's rows (none is built)


class PeelTables(NamedTuple):
    """Device-resident static tables for the peel phase (padded to chunks)."""

    e1: torch.Tensor         # (n_chunks*C,) int32, sentinel m
    cand_slot: torch.Tensor  # (n_chunks*C,) int32, sentinel 0
    lo: torch.Tensor         # (n_chunks*C,) int32, sentinel 0
    hi: torch.Tensor         # (n_chunks*C,) int32, sentinel 0  (lo==hi → miss)
    c_start: torch.Tensor    # (m,) int32   first chunk containing edge e
    c_end: torch.Tensor      # (m,) int32   last chunk containing edge e (incl.)
    has_entries: torch.Tensor  # (m,) bool


@dataclasses.dataclass(frozen=True)
class PKTResult:
    """Full output of one ``pkt`` decomposition, with phase accounting."""

    trussness: np.ndarray   # (m,) int32, >= 2
    support: np.ndarray     # (m,) int32 initial support
    levels: int             # number of peel levels executed
    sublevels: int          # total sub-level iterations (paper's S)
    compactions: int = 0    # live-edge compactions performed (DESIGN.md §10)
    #: phase wall-times {tables, support, peel, compact} — populated only
    #: when ``pkt(..., phase_timings=True)``, from the call's own spans
    #: (each phase is synced before its span ends, so attribution is honest
    #: but adds barriers)
    phases: dict | None = None


#: ``pkt``'s spans by the phase of ``PKTResult.phases`` they count in
PHASE_SPANS = {"tables": ("pkt.peel_csr", "pkt.tables"),
               "support": ("pkt.support",),
               "peel": ("pkt.loop", "pkt.readback"),
               "compact": ("pkt.compact",)}


def phase_seconds(spans) -> dict:
    """``{phase: seconds}`` of ``pkt``'s spans among ``spans`` (phases
    with no span left out)."""
    return {phase: trace.seconds(spans, names)
            for phase, names in PHASE_SPANS.items()
            if any(sp.name in names for sp in spans)}


def chunk_ranges(off: np.ndarray, chunk: int,
                 m_out: int | None = None) -> tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Per-edge chunk-range bookkeeping from a wedge-table offset array.

    Returns (has_entries, c_start, c_end), each of length ``m_out`` (edges
    beyond ``off``'s m are inert padding: no entries, range 0).
    """
    m = off.shape[0] - 1
    m_out = m if m_out is None else m_out
    has = np.zeros(m_out, bool)
    c_start = np.zeros(m_out, np.int32)
    c_end = np.zeros(m_out, np.int32)
    if m == 0 or off[-1] == 0:
        # empty graph, or a table with no entries (triangle-free
        # orientation): every edge has an empty chunk range
        return has, c_start, c_end
    has[:m] = off[1:] > off[:-1]
    c_start[:m] = off[:-1] // chunk
    c_end[:m] = np.maximum(off[1:] - 1, 0) // chunk
    return has, c_start, c_end


def _host_tables(e1, cand, lo, hi, has, c_start, c_end,
                 device: torch.device) -> PeelTables:
    """Upload host-built peel-table arrays."""
    def up(a):
        return torch.tensor(a, device=device)

    return PeelTables(e1=up(e1), cand_slot=up(cand), lo=up(lo), hi=up(hi),
                      c_start=up(c_start), c_end=up(c_end),
                      has_entries=up(has))


def prepare_peel(tab: support_mod.WedgeTable, m: int, chunk: int | None, *,
                 device="cuda") -> tuple[PeelTables, int, int]:
    """Clamp ``chunk`` to the table, pad, and upload; returns
    ``(tables, chunk, n_chunks)``.

    The chunk layout policy lives in ``kernels.wedge_common.chunk_layout``:
    a chunk larger than the table, zero, or negative is clamped so that
    ``n_chunks >= 1``.  A table with no entries at all (the empty graph, or
    a triangle-free orientation) takes an explicit early exit: one
    all-padding chunk of size 1, every edge marked entry-less.
    """
    device = resolve_device(device)
    if tab.size == 0:
        return _empty_peel_tables(m, device), 1, 1
    chunk, n_chunks = wedge_common.chunk_layout(tab.size, chunk)
    e1, cand, lo, hi = wedge_common.pad_chunked(
        tab.e1, tab.cand_slot, tab.lo, tab.hi,
        m=m, chunk=chunk, n_chunks=n_chunks)
    has, c_start, c_end = chunk_ranges(tab.off, chunk)
    tabs = _host_tables(e1, cand, lo, hi, has, c_start, c_end, device)
    return tabs, chunk, n_chunks


def _empty_peel_tables(m: int, device: torch.device) -> PeelTables:
    """One all-padding chunk of size 1; every edge entry-less."""
    return PeelTables(
        e1=torch.full((1,), m, dtype=torch.int32, device=device),
        cand_slot=torch.zeros(1, dtype=torch.int32, device=device),
        lo=torch.zeros(1, dtype=torch.int32, device=device),
        hi=torch.zeros(1, dtype=torch.int32, device=device),
        c_start=torch.zeros(m, dtype=torch.int32, device=device),
        c_end=torch.zeros(m, dtype=torch.int32, device=device),
        has_entries=torch.zeros(m, dtype=torch.bool, device=device),
    )


def prepare_peel_device(g: CSRGraph, chunk: int | None, *,
                        m_out: int | None = None, m_real: int | None = None,
                        device="cuda") -> tuple[PeelTables, int, int]:
    """Device-built peel tables for ``g``, pow2-padded (DESIGN.md §10).

    The table entry count is bounded on the host (O(m)), rows are
    materialized on the device to the next power of two, and the chunk-range
    metadata is computed alongside.  ``m_out`` (default ``g.m``) sizes the
    edge state space (compacted subproblems pad it to a pow2 bucket);
    ``m_real`` marks how many leading edge slots are real.
    """
    device = resolve_device(device)
    m_out = g.m if m_out is None else m_out
    m_real = g.m if m_real is None else m_real
    size = support_mod.peel_table_size(g)
    if size == 0:
        return _empty_peel_tables(m_out, device), 1, 1
    size_pad = wedge_common.next_pow2(size)
    support_mod._check_table_size(size_pad)
    chunk_eff = wedge_common.pow2_chunk(size_pad, chunk, size=size)
    n_chunks = size_pad // chunk_eff
    u, v, Es = _peel_operands(g, m_out, device)
    e1, cand, lo, hi, _off, c_start, c_end, has = \
        support_mod._build_peel_table_dev(u, v, Es, m_real, m=m_out,
                                          size=size_pad, chunk=chunk_eff)
    tabs = PeelTables(e1=e1, cand_slot=cand, lo=lo, hi=hi, c_start=c_start,
                      c_end=c_end, has_entries=has)
    return tabs, chunk_eff, n_chunks


def _peel_operands(g: CSRGraph, m_out: int, device: torch.device):
    """``(u, v, Es)`` on ``device`` for an edge space of ``m_out`` slots.

    A pow2 bucket (``m_out != g.m``, compacted callers) pads the edge and
    vertex arrays as the JAX package does: padding edges are ``(0, 0)`` and
    the offsets past ``n`` are ``2m``, so the rows and sentinels come out
    identical.
    """
    if m_out == g.m:
        dev = g.device_arrays(device)
        return dev["u"], dev["v"], dev["Es"]
    u = torch.tensor(wedge_common.pad1(g.El[:, 0], m_out, 0), device=device)
    v = torch.tensor(wedge_common.pad1(g.El[:, 1], m_out, 0), device=device)
    n_es = wedge_common.next_pow2(g.n + 1)
    Es = torch.tensor(wedge_common.pad1(g.Es, n_es, 2 * g.m), device=device)
    return u, v, Es


def prepare_peel_csr(g: CSRGraph, *, m_out: int | None = None,
                     device="cuda") -> PeelCSR:
    """The kernel executor's operands for ``g`` — no table is built.

    The table executors' int32 guard does not apply, so the port accepts
    graphs that ``prepare_peel_device`` and the JAX package refuse: those
    whose padded peel table would pass 2^31 - 1 rows.  The kernel path's
    largest count is its work list, ``m`` plus the rows over ``WORK_SLICE``;
    a graph is refused only when that passes the int32 layout.  ``m_out``
    (default ``g.m``) sizes the edge state space, as in
    ``prepare_peel_device``.
    """
    device = resolve_device(device)
    m_out = g.m if m_out is None else m_out
    size = support_mod.peel_table_size(g)
    work_cap = _work_capacity(g.m, size)
    u, v, Es = _peel_operands(g, m_out, device)
    return PeelCSR(u=u, v=v, Es=Es, work_cap=work_cap, peel_rows=size)


def _work_capacity(m: int, peel_rows: int) -> int:
    """``peel_kernel.work_capacity``, refused past the int32 layout."""
    work_cap = peel_kernel.work_capacity(m, peel_rows)
    if work_cap > np.iinfo(np.int32).max:
        raise ValueError(f"peel work list of {work_cap} items exceeds the "
                         f"int32 layout")
    return work_cap


def _active_chunk_mask(inCurr, tabs: PeelTables, m: int, n_chunks: int):
    """Chunks overlapping any frontier edge's wedge-entry range (bool mask).

    A difference array over chunk ids: +1 at each frontier edge's first
    chunk, −1 after its last, prefix-summed — all on the device.  Every
    edge adds (0 when it is off the frontier) at its *own* chunks: routing
    the zeros to one spare slot, as the JAX package's ``where(curr, c,
    n_chunks)`` does, sends nearly all m atomic adds to a single address,
    which serialized this function into most of the peel's device time on
    the H100 (PERF.md, section 5).
    """
    curr_edges = (inCurr[:m] & tabs.has_entries).to(torch.int32)
    delta = torch.zeros(n_chunks + 1, dtype=torch.int32, device=inCurr.device)
    delta.index_add_(0, tabs.c_start, curr_edges)
    delta.index_add_(0, tabs.c_end + 1, -curr_edges)
    return torch.cumsum(delta[:n_chunks], 0, dtype=torch.int32) > 0


def _decrements(mode: str, N, Eid, S_ext, processed, inCurr, l, tabs, *,
                pinned, m: int, chunk: int, n_chunks: int, iters: int):
    """One sub-level's (m+1,) int32 decrement vector, by a torch executor."""
    dec = torch.zeros(m + 1, dtype=torch.int32, device=S_ext.device)
    if mode == "dense":
        # every row of the table, every sub-level, frontier-masked
        for start, stop in wedge_common.row_slices(n_chunks * chunk):
            peel_kernel.decrement_rows(
                dec, tabs.e1[start:stop], tabs.cand_slot[start:stop],
                tabs.lo[start:stop], tabs.hi[start:stop], N, Eid, S_ext,
                processed, inCurr, pinned, l, iters=iters)
        return dec
    # chunked: visit only the chunks overlapping the frontier (one host
    # sync for the chunk list); of their rows, probe the frontier anchors
    ids = torch.nonzero(_active_chunk_mask(inCurr, tabs, m, n_chunks))[:, 0]
    per = max(1, wedge_common.SLICE_ROWS // chunk)
    offs = torch.arange(chunk, device=S_ext.device, dtype=torch.int64)
    for i in range(0, ids.shape[0], per):
        rows = (ids[i:i + per, None] * chunk + offs).reshape(-1)
        rows = rows[inCurr[tabs.e1[rows]]]
        peel_kernel.decrement_rows(
            dec, tabs.e1[rows], tabs.cand_slot[rows], tabs.lo[rows],
            tabs.hi[rows], N, Eid, S_ext, processed, inCurr, pinned, l,
            iters=iters)
    return dec


def _peel_loop(N, Eid, S_ext0, processed0, tabs, *, m: int,
               chunk: int | None, n_chunks: int | None, iters: int,
               mode: str, pinned=None, stop_live: int = 0, span=None):
    """Full level/sub-level peel over extended (m+1,) edge state.

    ``tabs`` is a :class:`PeelCSR` for ``mode="kernel"`` and a
    :class:`PeelTables` (with its ``chunk``/``n_chunks``) for the torch
    executors.  The inputs are not modified.

    ``S_ext0``/``processed0`` define which slots are live: slot m must be the
    processed sentinel, and callers may pre-mark extra padding slots as
    processed.  Returns (S_ext, processed, levels, sublevels, live) — the
    full extended state, so segmented callers can resume, and the number of
    its unprocessed slots, which the loop knows without another read.

    ``pinned`` (optional (m+1,) bool) marks *schedule* edges: they enter the
    frontier and process their triangles at exactly their initial support
    level, but never receive decrements themselves.  Slot m must be False.

    ``stop_live`` is the live-edge compaction early exit (DESIGN.md §10):
    the level loop returns once the number of unprocessed edges drops to or
    below it — always at a level boundary, so the caller can gather the
    survivors into a compacted edge space and continue bitwise identically.

    ``span`` (the recorded ``pkt.loop`` span, or None) gets the kernel
    executor's ``host_reads`` and ``wait_ns``, its blocking reads of the
    device's counts and the host ns spent in them, and ``blocks``, the fused
    launch's grid (0 where the host drives the loop).
    """
    S_ext, processed = S_ext0.clone(), processed0.clone()
    if mode == "kernel":
        # one call of the fused loop: on the card one launch runs the
        # segment and the host reads the card once; on CPU tensors its
        # plain version drives the steps and reads once per sub-level
        res = peel_kernel.peel_loop(S_ext, processed, tabs.u, tabs.v, tabs.Es,
                                    N, Eid, pinned, m=m,
                                    work_cap=tabs.work_cap,
                                    stop_live=stop_live)
        if span is not None:
            span.attrs.update(host_reads=res.host_reads, wait_ns=res.wait_ns,
                              blocks=res.blocks)
        return S_ext, processed, res.levels, res.sublevels, res.live
    todo = (m + 1) - int(processed.sum())
    levels = subs = 0
    while todo > stop_live:
        alive_S = torch.where(processed, _SENTINEL_S, S_ext)
        l = alive_S.min()  # skip ahead to the next populated level; stays on device
        inCurr = ~processed & (S_ext == l)
        inCurr[m] = False
        levels += 1
        # the frontier of a level's first sub-level is never empty: some
        # live edge holds the minimum support
        while True:
            dec = _decrements(mode, N, Eid, S_ext, processed, inCurr, l, tabs,
                              pinned=pinned, m=m, chunk=chunk,
                              n_chunks=n_chunks, iters=iters)
            inCurr = peel_kernel.apply_decrements(dec, S_ext, processed,
                                                  inCurr, l, m)
            subs += 1
            n_front, n_done = torch.stack(
                [inCurr.sum(), processed.sum()]).tolist()
            if not n_front:
                break
        todo = (m + 1) - n_done
    return S_ext, processed, levels, subs, todo


# --- live-edge compaction (DESIGN.md §10) -----------------------------------
#
# Segments of the peel run under a live-edge early exit; between segments
# the surviving edges are gathered into a compacted edge space — vertices
# rank-relabeled, CSR rebuilt, the peel table rebuilt over only live edges
# at the next pow2 size, and the (S, processed, pinned) state remapped.  The
# relabeling is order-preserving, so the lowest-edge-id tie-break picks the
# same winners and the continuation is bitwise identical: levels,
# sub-levels and the fixed point all match the uncompacted run.  The kernel
# executor rebuilds on a CUDA device from ``prep.DEVICE_COMPACT_MIN_ROWS``
# survivors (``_make_subproblem_device``, sorts and scans); every other
# rebuild runs on the host (``_make_subproblem``).

#: default compaction policy: compact when the live fraction drops below
#: ``_COMPACT_FRAC``, but never bother below ``_COMPACT_MIN`` live edges
_COMPACT_FRAC = 0.25
_COMPACT_MIN = 1 << 11
_MIN_M_PAD = 8


def _make_subproblem(El_rows: np.ndarray, ids: np.ndarray,
                     S_rows: np.ndarray, pinned_rows: np.ndarray | None, *,
                     chunk_req: int | None, table_mode: str, mode: str,
                     device: torch.device) -> dict:
    """Compact ``El_rows`` (live edges, ascending original order) into a
    fresh pow2-bucketed peel problem.

    ``ids`` maps each row to the caller's output slot; ``S_rows`` carries
    the live supports (the continuation state), ``pinned_rows`` the pinned
    schedule marks (or None).  Vertex ids are rank-relabeled —
    order-preserving, so ``build_csr``'s lexicographic edge ids keep the
    input row order and the peel tie-break is unchanged.  The kernel
    executor (``mode="kernel"``) gets the padded CSR and no table; the
    torch executors get a table built where ``table_mode`` says.
    """
    m_sub = El_rows.shape[0]
    verts = np.unique(El_rows)
    E_sub = np.searchsorted(verts, El_rows).astype(np.int64)
    g_sub = build_csr(E_sub, verts.shape[0])
    m_pad = max(_MIN_M_PAD, wedge_common.next_pow2(m_sub))

    if mode == "kernel":
        tabs = prepare_peel_csr(g_sub, m_out=m_pad, device=device)
        chunk_eff = n_chunks = None
    elif table_mode == "device":
        tabs, chunk_eff, n_chunks = prepare_peel_device(
            g_sub, chunk_req, m_out=m_pad, m_real=m_sub, device=device)
    else:
        tab = support_mod.build_peel_table(g_sub)
        if tab.size == 0:
            tabs, chunk_eff, n_chunks = _empty_peel_tables(m_pad, device), 1, 1
        else:
            size_pad = wedge_common.next_pow2(tab.size)
            chunk_eff = wedge_common.pow2_chunk(size_pad, chunk_req,
                                                size=tab.size)
            n_chunks = size_pad // chunk_eff
            e1, cand, lo, hi = wedge_common.pad_chunked(
                tab.e1, tab.cand_slot, tab.lo, tab.hi,
                m=m_pad, chunk=chunk_eff, n_chunks=n_chunks)
            has, c_start, c_end = chunk_ranges(tab.off, chunk_eff,
                                               m_out=m_pad)
            tabs = _host_tables(e1, cand, lo, hi, has, c_start, c_end, device)

    S_ext0 = np.full(m_pad + 1, _SENTINEL_S, np.int32)
    S_ext0[:m_sub] = S_rows
    processed0 = np.ones(m_pad + 1, bool)
    processed0[:m_sub] = False
    ids_pad = np.full(m_pad, -1, np.int64)
    ids_pad[:m_sub] = ids
    pinned = None
    pinned_np = None
    if pinned_rows is not None and pinned_rows.any():
        pinned_np = np.zeros(m_pad + 1, bool)
        pinned_np[:m_sub] = pinned_rows
        pinned = torch.tensor(pinned_np, device=device)
    return dict(
        N=torch.tensor(wedge_common.pad1(g_sub.N, 2 * m_pad,
                                         wedge_common.PAD_N), device=device),
        Eid=torch.tensor(wedge_common.pad1(g_sub.Eid, 2 * m_pad, m_pad),
                         device=device),
        tabs=tabs, chunk=chunk_eff, n_chunks=n_chunks,
        iters=int(np.ceil(np.log2(2 * m_pad + 1))) + 1, m=m_pad, live=m_sub,
        S_ext0=torch.tensor(S_ext0, device=device),
        processed0=torch.tensor(processed0, device=device),
        pinned=pinned, pinned_np=pinned_np, El=g_sub.El, ids=ids_pad)


def _pad(t: torch.Tensor, size: int, fill) -> torch.Tensor:
    """``t`` followed by ``fill`` up to ``size`` entries, its dtype kept
    (``wedge_common.pad1`` on the device)."""
    out = t.new_full((size,), fill)
    out[:t.shape[0]] = t
    return out


def _slots(problem: dict, device: torch.device) -> torch.Tensor:
    """``problem``'s output slots (``ids``) as an int64 tensor on
    ``device``: uploaded where a host build made them, ``arange(m)`` for
    the whole graph's problem (``ids=None``: slot ``e`` is edge ``e``)."""
    ids = problem["ids"]
    if ids is None:
        return torch.arange(problem["m"], device=device)
    return torch.as_tensor(ids, device=device)


def _make_subproblem_device(problem: dict, S_ext: torch.Tensor,
                            processed: torch.Tensor) -> dict:
    """``_make_subproblem`` for the kernel executor, on the device: the
    survivors of ``problem``'s segment (``S_ext``/``processed`` at its end)
    in a fresh pow2-bucketed problem, equal to the host build field for
    field, built without a download.

    The survivors' rows come from the segment's ``u``/``v`` in ascending
    edge order, with their S, output slots and pinned marks;
    ``_device_problem`` builds the rest.
    """
    m, tabs = problem["m"], problem["tabs"]
    live = torch.nonzero(~processed[:m])[:, 0]
    pinned = problem["pinned"]
    # every vertex id of the segment lies below its offsets' length
    return _device_problem(
        tabs.u[live].to(torch.int64), tabs.v[live].to(torch.int64),
        S_ext[live], _slots(problem, S_ext.device)[live],
        None if pinned is None else pinned[live], tabs.Es.shape[0])


def _device_problem(u: torch.Tensor, v: torch.Tensor, S: torch.Tensor,
                    ids: torch.Tensor, pinned: torch.Tensor | None,
                    n_ids: int) -> dict:
    """The kernel executor's pow2-bucketed problem of the canonical edges
    ``(u[i], v[i])`` (int64, in ascending edge order, every id below
    ``n_ids``) with start S ``S``, output slots ``ids`` and pinned marks
    ``pinned`` (or None), built on their device: ``_make_subproblem`` with
    ``mode="kernel"``, equal to it field for field.

    A vertex's new id is its rank among the edges' endpoints (a mark and a
    running sum), which preserves order, so the keys stay sorted and the
    tie-break is unchanged; ``prep.csr_arrays`` builds the CSR.  The last
    of its reads, queued after every other step, is the peel rows that
    size the work list (with whether an edge is pinned), so a span around
    the call ends after its device work.
    """
    dev = u.device
    k = u.shape[0]
    seen = torch.zeros(n_ids, dtype=torch.int32, device=dev)
    seen[u] = 1
    seen[v] = 1
    rank = torch.cumsum(seen, 0) - 1
    n = int(rank[-1]) + 1
    lo, hi = rank[u], rank[v]
    t = prep.csr_arrays(lo, hi, n)
    deg = (t["Es"][1:] - t["Es"][:-1]).to(torch.int64)
    m_pad = max(_MIN_M_PAD, wedge_common.next_pow2(k))
    # the offsets pad as ``_peel_operands`` pads them: only in a bucket
    # larger than the edges
    n_es = n + 1 if m_pad == k else wedge_common.next_pow2(n + 1)
    processed0 = torch.ones(m_pad + 1, dtype=torch.bool, device=dev)
    processed0[:k] = False
    reads = [torch.minimum(deg[lo], deg[hi]).sum()]
    if pinned is not None:
        pinned = _pad(pinned, m_pad + 1, False)
        reads.append(pinned.any().to(torch.int64))
    sub = dict(
        N=_pad(t["N"], 2 * m_pad, int(wedge_common.PAD_N)),
        Eid=_pad(t["Eid"], 2 * m_pad, m_pad), chunk=None, n_chunks=None,
        iters=int(np.ceil(np.log2(2 * m_pad + 1))) + 1, m=m_pad, live=k,
        S_ext0=_pad(S.to(torch.int32), m_pad + 1, _SENTINEL_S),
        processed0=processed0, pinned_np=None, El=None,
        ids=_pad(ids, m_pad, -1))
    u_pad, v_pad, Es = (_pad(t["u"], m_pad, 0), _pad(t["v"], m_pad, 0),
                        _pad(t["Es"], n_es, 2 * k))
    peel_rows, *pinned_any = torch.stack(reads).tolist()
    sub["tabs"] = PeelCSR(u=u_pad, v=v_pad, Es=Es,
                          work_cap=_work_capacity(k, peel_rows),
                          peel_rows=peel_rows)
    sub["pinned"] = pinned if any(pinned_any) else None
    return sub


def _host_rows(problem: dict, S_ext, processed, host) -> tuple:
    """The survivors' ``(rows, ids, S, pinned)`` on the host for
    ``_make_subproblem``: picked from ``host``, the readback's ``(S,
    processed)``, where there is one; else, for a problem built on the
    device, gathered there and downloaded."""
    if host is None:
        live = torch.nonzero(~processed[:problem["m"]])[:, 0]
        tabs, pinned = problem["tabs"], problem["pinned"]
        rows = torch.stack([tabs.u[live], tabs.v[live]], dim=1)
        return (rows.cpu().numpy(), problem["ids"][live].cpu().numpy(),
                S_ext[live].cpu().numpy(),
                None if pinned is None else pinned[live].cpu().numpy())
    S_np, proc_np = host
    live = np.nonzero(~proc_np)[0]
    ids, pinned = problem["ids"], problem["pinned_np"]
    return (problem["El"][live], live if ids is None else ids[live],
            S_np[live], None if pinned is None else pinned[live])


def _segmented_peel(problem: dict, out: np.ndarray, *, mode: str,
                    table_mode: str, compact_frac: float | None,
                    compact_min: int, chunk_req: int | None,
                    device: torch.device,
                    sync: bool = False) -> tuple[int, int, int]:
    """Run ``problem`` to the fixed point, compacting between segments.

    Each segment peels until ≤ ``compact_frac · m`` edges remain live (or to
    completion when compaction is off / the problem is below
    ``compact_min``); finished edges scatter their final S into ``out`` (at
    ``problem['ids']`` slots) and survivors are re-bucketed.  Returns
    (levels, sublevels, compactions).

    The kernel executor rebuilds on the device (``_make_subproblem_device``)
    where ``prep.compacts_on_device`` says for the survivor count; there,
    and after it, the state stays on the device and the final S collect in
    a device copy of ``out``, downloaded once when device-built problems
    end.  Every other rebuild downloads the state and runs
    ``_make_subproblem``.  Each segment is a ``pkt.loop`` span and a
    ``pkt.readback`` span, each compaction a ``pkt.compact`` span (``m``
    the survivors, ``on`` "host" or the device's type), synced before it
    ends when ``sync``.
    """
    levels = subs = compactions = 0
    finals = None   # the output on the device, -1 where no S is final yet
    while True:
        m = problem["m"]
        n_live = problem["live"]
        live_target = 0
        if compact_frac and n_live > compact_min:
            # clamp below the live count so every segment must retire at
            # least one level before the loop considers compacting again
            live_target = min(int(compact_frac * m), n_live - 1)
        with trace.span("pkt.loop", m=m) as loop:
            S_ext, processed, lv, sb, left = _peel_loop(
                problem["N"], problem["Eid"], problem["S_ext0"],
                problem["processed0"], problem["tabs"], m=m,
                chunk=problem["chunk"], n_chunks=problem["n_chunks"],
                iters=problem["iters"], mode=mode, pinned=problem["pinned"],
                stop_live=live_target, span=loop)
            trace.set(levels=lv, sublevels=sb)
        levels += lv
        subs += sb
        on_dev = (mode == "kernel" and left > 0
                  and prep.compacts_on_device(left, device))
        host = None
        with trace.span("pkt.readback"):
            if on_dev or problem["El"] is None:
                if finals is None:
                    finals = torch.full(out.shape, -1, dtype=torch.int32,
                                        device=device)
                # a problem's first ``live`` slots are its real edges
                real = problem["live"]
                ids = _slots(problem, device)[:real]
                finals[ids] = torch.where(processed[:real], S_ext[:real],
                                          finals[ids])
            else:
                finals = _download(finals, out)
                S_np = S_ext[:m].cpu().numpy()
                proc_np = processed[:m].cpu().numpy()
                host = (S_np, proc_np)
                ids = problem["ids"]
                ids = np.arange(m) if ids is None else ids
                dead = proc_np & (ids >= 0)
                out[ids[dead]] = S_np[dead]
        if not left:
            _download(finals, out)
            return levels, subs, compactions
        # ≤ live_target survivors: gather them into a compacted edge space
        compactions += 1
        with trace.span("pkt.compact", m=left,
                        on=device.type if on_dev else "host"):
            if on_dev:
                problem = _make_subproblem_device(problem, S_ext, processed)
            else:
                problem = _make_subproblem(
                    *_host_rows(problem, S_ext, processed, host),
                    chunk_req=chunk_req, table_mode=table_mode, mode=mode,
                    device=device)
            if sync:
                synchronize(device)
        if problem["live"] >= n_live:
            raise AssertionError("compaction must strictly shrink the problem")


def _download(finals, out: np.ndarray) -> None:
    """Copy the final S that the device copy ``finals`` holds (or None)
    into ``out``; returns None, the device copy's state after it."""
    if finals is not None:
        fin = finals.cpu().numpy()
        done = fin >= 0
        out[done] = fin[done]
    return None


def peel_live_subset(El: np.ndarray, live_ids: np.ndarray,
                     S0_live: np.ndarray,
                     pinned_live: np.ndarray | None = None, *,
                     chunk: int | None = None, mode: str = "kernel",
                     table_mode: str = "device",
                     compact_frac: float | None = _COMPACT_FRAC,
                     compact_min: int = _COMPACT_MIN,
                     device="cuda") -> np.ndarray:
    """Peel a subset of a graph's edges in a compacted edge space.

    ``live_ids`` (strictly increasing edge ids into ``El``) are gathered
    into a compact pow2-bucketed subproblem — only their induced subgraph
    is materialized — and peeled to the fixed point (with further compaction
    as the subset shrinks).  ``S0_live`` seeds the per-edge state;
    ``pinned_live`` marks schedule edges exactly as in ``_peel_loop``.
    Returns the final S per ``live_ids`` row.  The kernel executor builds
    the subproblem on the device where ``prep.compacts_on_device`` says
    for ``len(live_ids)`` edges (``_device_problem``), else on the host.
    """
    check_axis("mode", mode, PEEL_MODES)
    device = resolve_device(device)
    live_ids = np.asarray(live_ids, dtype=np.int64)
    k = live_ids.shape[0]
    if k == 0:
        return np.zeros(0, np.int32)
    if k > 1 and not (np.diff(live_ids) > 0).all():
        # ascending ids are what make the compacted relabeling
        # order-preserving — the tie-break replay is silently wrong otherwise
        raise ValueError("live_ids must be strictly increasing edge ids")
    rows = np.asarray(El)[live_ids]
    S0_live = np.asarray(S0_live, dtype=np.int32)
    if pinned_live is not None:
        pinned_live = np.asarray(pinned_live, bool)
    if mode == "kernel" and prep.compacts_on_device(k, device):
        return peel_rows_device(
            torch.from_numpy(rows.astype(np.int64)).to(device),
            torch.from_numpy(S0_live).to(device),
            None if pinned_live is None
            else torch.from_numpy(pinned_live).to(device),
            compact_frac=compact_frac, compact_min=compact_min)
    out = np.zeros(k, np.int32)
    problem = _make_subproblem(
        rows, np.arange(k, dtype=np.int64), S0_live, pinned_live,
        chunk_req=chunk, table_mode=table_mode, mode=mode, device=device)
    _segmented_peel(problem, out, mode=mode, table_mode=table_mode,
                    compact_frac=compact_frac, compact_min=compact_min,
                    chunk_req=chunk, device=device)
    return out


def peel_rows_device(rows: torch.Tensor, S0: torch.Tensor,
                     pinned: torch.Tensor | None, *,
                     compact_frac: float | None = _COMPACT_FRAC,
                     compact_min: int = _COMPACT_MIN) -> np.ndarray:
    """``peel_live_subset`` with the kernel executor on the rows' device,
    from tensors there: ``rows`` the subset's (k, 2) canonical edges in
    ascending order (int64), ``S0`` their start S, ``pinned`` their
    schedule marks (or None).  The subproblem is built there
    (``_device_problem``) and only the final S per row (a host array)
    comes back."""
    k = rows.shape[0]
    out = np.zeros(k, np.int32)
    if k == 0:
        return out
    problem = _device_problem(rows[:, 0], rows[:, 1], S0,
                              torch.arange(k, device=rows.device), pinned,
                              int(rows.max()) + 1)
    _segmented_peel(problem, out, mode="kernel", table_mode="device",
                    compact_frac=compact_frac, compact_min=compact_min,
                    chunk_req=None, device=rows.device)
    return out


def pkt(g: CSRGraph, *, chunk: int | None = None, mode: str = "kernel",
        peel_mode: str | None = None, support_mode: str = "kernel",
        table_mode: str = "device",
        compact_frac: float | None = _COMPACT_FRAC,
        compact_min: int = _COMPACT_MIN,
        phase_timings: bool = False, support_site: bool = True,
        device="cuda") -> PKTResult:
    """Full PKT truss decomposition of one CSR graph.

    Every executor pairing produces bitwise-identical results, equal to the
    JAX package's ``repro.core.pkt.pkt``.

    Args:
        g: the graph as a :class:`~repro_torch.graphs.csr.CSRGraph`.
        chunk: wedge-table chunk size (pow2; ``None`` derives it from the
            table size, see ``kernels.wedge_common.auto_chunk``).
        mode: peel executor — one of ``PEEL_MODES`` ("chunked", "dense",
            "kernel"); alias ``peel_mode`` wins when both are given.
        peel_mode: alias for ``mode``.
        support_mode: support executor — one of
            ``support.SUPPORT_MODES`` ("torch", "kernel").
        table_mode: where the torch executors' wedge tables are built
            (``support.TABLE_MODES``): "device" (the default) or "numpy"
            (built on the host, kept as the parity oracle).  The kernel
            executors read the CSR and build no table; they ignore
            ``table_mode``.
        compact_frac: live-edge compaction threshold (DESIGN.md §10): once
            a peel segment leaves fewer than ``compact_frac · m`` edges
            live (and more than ``compact_min``), survivors are gathered
            into a compacted subproblem and peeling re-enters there.
            ``None`` disables compaction; results are bitwise identical
            either way.
        compact_min: minimum live-edge count for compaction to trigger.
        phase_timings: populate ``PKTResult.phases`` with a
            {tables, support, peel, compact} wall-time split, summed from
            the call's own spans (``PHASE_SPANS``), which are recorded for
            the call whether or not tracing is on (adds sync barriers
            between phases).
        support_site: consult the "support" fault site of
            ``testing/chaos.py`` before the support phase.  The engine's
            batched flush passes ``False``: as in the JAX package, whose
            flush never reaches ``pkt``, a flush consults only its own
            "flush" site.
        device: "cuda" (the default; raises when no card is present) or
            "cpu", where every "kernel" executor runs its plain version.

    Returns:
        :class:`PKTResult` — per-edge trussness (support + 2, aligned to
        ``g.El`` rows), initial support, and loop/compaction counters.

    Raises:
        ValueError: unknown ``mode`` / ``support_mode`` / ``table_mode``.
        RuntimeError: ``device`` is CUDA and no card is present.
    """
    mode = mode if peel_mode is None else peel_mode
    check_axis("mode", mode, PEEL_MODES)
    check_axis("support_mode", support_mode, support_mod.SUPPORT_MODES)
    check_axis("table_mode", table_mode, support_mod.TABLE_MODES)
    device = resolve_device(device)
    if g.m == 0:
        return PKTResult(np.zeros(0, np.int32), np.zeros(0, np.int32), 0, 0,
                         phases={} if phase_timings else None)
    with (trace.collect() if phase_timings
          else contextlib.nullcontext()) as recorded:
        res = _pkt(g, chunk=chunk, mode=mode, support_mode=support_mode,
                   table_mode=table_mode, compact_frac=compact_frac,
                   compact_min=compact_min, support_site=support_site,
                   sync=phase_timings, device=device)
    if phase_timings:
        res = dataclasses.replace(res, phases=phase_seconds(recorded))
    return res


def _pkt(g: CSRGraph, *, chunk, mode, support_mode, table_mode,
         compact_frac, compact_min, support_site,
         sync: bool, device: torch.device) -> PKTResult:
    """``pkt`` on a non-empty graph, its arguments checked.  Each phase is a
    span (``pkt.support``, ``pkt.peel_csr`` or ``pkt.tables``, then
    ``_segmented_peel``'s), synced before it ends when ``sync``."""
    # ---- support phase -----------------------------------------------------
    if support_site:
        fault_point("support", rung=f"{support_mode}/{table_mode}")
    # the kernel executor reads the CSR: no support table, host or device
    if support_mode == "kernel" or table_mode == "device":
        with trace.span("pkt.support", m=g.m):
            S0_dev = support_mod._support_device(
                g, mode=support_mode, chunk=chunk, device=device)
            S0 = S0_dev.cpu().numpy()
    else:
        with trace.span("pkt.tables", m=g.m):
            stab = support_mod.build_support_table(g)
        with trace.span("pkt.support", m=g.m):
            S0 = support_mod.compute_support(
                g, stab, mode=support_mode, chunk=chunk, device=device)
            S0_dev = torch.tensor(S0, device=device)
            if sync:
                synchronize(device)

    # ---- peel tables (torch executors) or CSR operands (kernel) -------------
    with trace.span("pkt.peel_csr" if mode == "kernel" else "pkt.tables",
                    m=g.m):
        if mode == "kernel":
            tabs = prepare_peel_csr(g, device=device)
            trace.set(peel_rows=tabs.peel_rows, work_cap=tabs.work_cap)
            chunk_eff = n_chunks = None
        elif table_mode == "device":
            tabs, chunk_eff, n_chunks = prepare_peel_device(g, chunk,
                                                            device=device)
        else:
            tabs, chunk_eff, n_chunks = prepare_peel(
                support_mod.build_peel_table(g), g.m, chunk, device=device)
        if sync:
            synchronize(device)

    # ---- segmented peel with live-edge compaction --------------------------
    dev = g.device_arrays(device)
    m = g.m
    S_ext0 = torch.cat([S0_dev.to(torch.int32),
                        torch.full((1,), _SENTINEL_S, dtype=torch.int32,
                                   device=device)])
    processed0 = torch.zeros(m + 1, dtype=torch.bool, device=device)
    processed0[m] = True
    problem = dict(
        N=dev["N"], Eid=dev["Eid"], tabs=tabs, chunk=chunk_eff,
        n_chunks=n_chunks, iters=support_mod._search_iters(g), m=m, live=m,
        S_ext0=S_ext0, processed0=processed0, pinned=None, pinned_np=None,
        El=g.El, ids=None)
    S_out = np.zeros(m, np.int32)
    levels, subs, compactions = _segmented_peel(
        problem, S_out, mode=mode, table_mode=table_mode,
        compact_frac=compact_frac, compact_min=compact_min, chunk_req=chunk,
        device=device, sync=sync)
    return PKTResult(
        trussness=S_out.astype(np.int32) + 2,
        support=S0,
        levels=levels,
        sublevels=subs,
        compactions=compactions,
    )


def truss_pkt(edges: np.ndarray, *, reorder: bool = True,
              chunk: int | None = None, mode: str = "kernel",
              support_mode: str = "kernel",
              table_mode: str = "device",
              compact_frac: float | None = _COMPACT_FRAC,
              compact_min: int = _COMPACT_MIN,
              device="cuda") -> np.ndarray:
    """Convenience entry: undirected edges → trussness aligned to input order.

    ``edges`` is any (k, 2) integer array: endpoint order is free and
    duplicate rows are allowed — rows are canonicalized and deduped exactly
    like ``TrussEngine.submit`` before decomposition, and the result is
    mapped back so ``out[i]`` is the trussness of ``edges[i]``.  Self-loops,
    negative vertex ids, and ids beyond the int32 CSR / int64 key-packing
    bounds are rejected.  With ``reorder`` (the paper's preprocessing)
    vertices are relabeled by increasing coreness before decomposition.
    Runs on ``device`` ("cuda" by default; raises when no card is present).
    The preprocessing and the alignment run where ``prep.prepare`` says: on
    a CUDA device from ``prep.DEVICE_PREP_MIN_ROWS`` rows on, else on the
    host.  The call is one ``pkt.one_shot`` span (``rows``, ``n``, ``m``)
    holding ``pkt.preprocess``, ``pkt``'s spans and ``pkt.align``.
    """
    device = resolve_device(device)
    with trace.span("pkt.one_shot", rows=len(edges)):
        g, n, row_keys = prepare(edges, reorder=reorder, device=device)
        trace.set(n=n, m=g.m)
        if g.m == 0:
            return np.zeros(0, np.int64)
        res = pkt(g, chunk=chunk, mode=mode, support_mode=support_mode,
                  table_mode=table_mode, compact_frac=compact_frac,
                  compact_min=compact_min, device=device)
        with trace.span("pkt.align"):
            return align(res.trussness, g, n, row_keys, device)
