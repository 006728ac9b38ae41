"""K2: one ProcessSubLevel decrement fold, fed by the CSR and the frontier,
and the sub-level state updates around it.

The port of the JAX package's Pallas kernel ``repro/kernels/peel.py:
peel_decrement_fold``.  At level ``l`` every wedge of a frontier edge ``e1 =
(a, b)`` is probed: a candidate slot ``c`` of the smaller-degree endpoint's
adjacency (ties: ``a``'s), searched in the other endpoint's adjacency — the
rows that the JAX package's peel table holds for ``e1``.  A hit whose edges
``e2 = Eid[c]`` and ``e3 = Eid[hit slot]`` are both unprocessed adds 1 to
``dec[e2]`` when ``S[e2] > l``, ``e2`` is not pinned, and ``e3`` is off the
frontier or ``e1 < e3`` (the paper's lowest-id tie-break: of two frontier
edges sharing a triangle, the lower id processes it); ``e3`` symmetrically.
The fold also lists the edges it decrements (the *touched* list).

The frontier reaches the fold as a *work list*: one item ``(work_e[t],
work_j[t])`` per slice of ``WORK_SLICE`` candidates of a frontier edge, so
an edge with a long scan side is spread over many warps.  ``counts`` is a
(4,) int32 device buffer ``[n_items, n_front, n_done, n_touched]``.  The
list's order does not matter (integer sums are order-free).  The update
kernels make the list on the device; ``frontier_work`` makes it from any
frontier list with torch ops.

A sub-level of the kernel path is the fold, then ``sublevel_update``: the
sparse update, which visits only the old frontier (``front_in``) and the
touched edges, and writes the next frontier as a flag, an id list
(``front_out``) and a work list.  It is right on the states the peel
reaches: within a level every live edge off the frontier has ``S > l``, so
only a decremented edge can reach ``S == l``.  A level starts with
``dense_update``, one pass over the ``m + 1`` slots, which forms the level's
first frontier (and takes any state the sparse update takes).  The frontier
id list is read while the next one is written, so the caller double-buffers
it and ``counts``: ``buffers`` allocates them.

``peel_loop`` runs whole levels of that loop as one launch: the level
start (``l = min(live S)``, then the dense walk), the folds and the sparse
updates, until the segment ends at a level boundary, with one host read of
``[levels, sublevels, n_done, status]`` at the end.  Its plain version is
``host_loop`` on CPU tensors: the loop driven from the host, one step
wrapper at a time, reading ``[#frontier, #processed]`` once a sub-level.
On CUDA tensors ``host_loop`` drives the three standalone kernels (the
parity oracle of the fused launch).

Every entry point launches its CUDA kernel (``csrc/peel.cu``) on CUDA
tensors, with the level ``l`` and the counts read on the device, so none
needs a host sync; on CPU tensors — and only there — it runs its plain
PyTorch version (``*_ref``).  Output of the fold: ``dec`` (m+1,) int32, read
``dec[:m]``; ``dec[m]`` stays 0.  Masks (``processed``/``inCurr``/
``pinned``, (m+1,)) travel as bytes (bool or uint8); ``pinned=None`` means
no schedule edges.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_build, wedge_common

#: launches of the CUDA kernels / calls of their plain versions: the fold
#: (K2), the sparse update after each fold, the dense update of a level's
#: start, and the fused loop (one per peel segment)
COUNTS = cuda_build.LaunchCounts()
UPDATE_COUNTS = cuda_build.LaunchCounts()
DENSE_COUNTS = cuda_build.LaunchCounts()
LOOP_COUNTS = cuda_build.LaunchCounts()

#: candidates of one work item (one warp of K2 takes one item; two per lane)
WORK_SLICE = 64

#: the support a processed slot counts as in a level's minimum
#: (``kSentinelS`` in csrc/peel.cu)
SENTINEL_S = 1 << 30


class Buffers(NamedTuple):
    """The kernel path's device buffers for an edge space of ``m`` slots."""

    dec: torch.Tensor      # (m+1,) int32, zero between sub-levels
    touched: torch.Tensor  # (m,) int32, the fold's touched edges
    front: torch.Tensor    # (2, m+1) int32, frontier id lists (double buffer)
    work_e: torch.Tensor   # (work_cap,) int32
    work_j: torch.Tensor   # (work_cap,) int32
    counts: torch.Tensor   # (2, 4) int32, one row per frontier list
    ctl: torch.Tensor      # (9,) int32, the fused loop's level words and
    #                        its result [levels, sublevels, n_done, status,
    #                        blocks]


def buffers(m: int, work_cap: int, device) -> Buffers:
    """Allocate the kernel path's buffers (``dec``, ``counts`` and ``ctl``
    zeroed)."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    # counts, ctl and dec in one zeroed allocation (one fill, not three),
    # counts first: the update kernels add to each row's first two words
    # with one 64-bit atomic, so a row must start 8-byte aligned
    zero = torch.zeros(8 + 9 + m + 1, dtype=torch.int32, device=device)
    return Buffers(dec=zero[17:], touched=empty(m), front=empty(2, m + 1),
                   work_e=empty(work_cap), work_j=empty(work_cap),
                   counts=zero[:8].view(2, 4), ctl=zero[8:17])


class LoopResult(NamedTuple):
    """What one peel segment (``peel_loop``, ``host_loop``) reports."""

    levels: int
    sublevels: int
    host_reads: int   # blocking reads of the device's counts
    wait_ns: int      # host ns blocked in those reads
    blocks: int       # the fused launch's grid; 0 where the host drives it
    live: int         # slots left unprocessed when the segment ended


def work_capacity(m: int, table_size: int) -> int:
    """Work items the largest frontier can make: every edge's
    ``ceil(deg_scan / WORK_SLICE)``, at most ``m + table_size / WORK_SLICE``
    (``table_size``: the peel table's rows, the sum of the scan sides)."""
    return m + -(-table_size // WORK_SLICE) + 1


def _scan_probe(e, u, v, Es):
    """Per edge: scan range start and length, probe range start and end
    (the peel table's degree rule)."""
    e = e.long()
    a = u[e].long()
    b = v[e].long()
    a0, a1, b0, b1 = Es[a], Es[a + 1], Es[b], Es[b + 1]
    swap = (a1 - a0) > (b1 - b0)
    s0 = torch.where(swap, b0, a0)
    n_scan = torch.where(swap, b1 - b0, a1 - a0)
    lo = torch.where(swap, a0, b0)
    hi = torch.where(swap, a1, b1)
    return s0, n_scan, lo, hi


def frontier_work(front, u, v, Es, work_e, work_j, counts) -> int:
    """Fill the work list of the frontier edges ``front`` (any order).

    Writes ``work_e``/``work_j`` and ``counts = [n_items, len(front), ...]``
    in place (``counts[2:]`` are left as they are) and returns ``n_items``.
    Plain torch ops; the host reads the item count once.
    """
    _, n_scan, _, _ = _scan_probe(front, u, v, Es)
    n_items_e = ((n_scan + WORK_SLICE - 1) // WORK_SLICE).long()
    n = int(n_items_e.sum())
    if n > work_e.shape[0]:
        raise ValueError(f"{n} work items exceed the list's {work_e.shape[0]}")
    first = torch.cumsum(n_items_e, 0) - n_items_e
    work_e[:n] = torch.repeat_interleave(front, n_items_e)
    work_j[:n] = (torch.arange(n, device=front.device)
                  - torch.repeat_interleave(first, n_items_e)).to(torch.int32)
    counts[0] = n
    counts[1] = front.shape[0]
    return n


def _launch(name: str, fn: str, *args) -> None:
    """Call ``fn`` of library ``name`` on the current stream; raise on a
    launch error.  Tensors pass as their data pointers."""
    lib = cuda_build.library(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn)(*ptrs, stream)
    cuda_build.check_launch(lib, name, code)


def _check_edges(dev, u, v, Es, m: int) -> None:
    cuda_build.check_int32("u", u, dev)
    cuda_build.check_int32("v", v, dev, tuple(u.shape))
    if u.shape[0] < m:
        raise ValueError(f"u has {u.shape[0]} edges, expected >= {m}")
    cuda_build.check_int32("Es", Es, dev)


def _check_state(dev, dec, S_ext, processed, inCurr, m: int) -> None:
    for name, t in (("dec", dec), ("S_ext", S_ext)):
        cuda_build.check_int32(name, t, dev, (m + 1,))
    for name, t in (("processed", processed), ("inCurr", inCurr)):
        cuda_build.check_mask(name, t, dev, (m + 1,))


def _check_work(dev, work_e, work_j) -> None:
    cap = work_e.shape[0]
    cuda_build.check_int32("work_e", work_e, dev, (cap,))
    cuda_build.check_int32("work_j", work_j, dev, (cap,))


def peel_decrement_fold(work_e, work_j, counts, l, u, v, Es, N, Eid, S_ext,
                        processed, inCurr, pinned=None, *, m: int,
                        dec=None, touched=None):
    """Decrements of one sub-level at level ``l`` → ``(dec, touched)``.

    ``work_e``/``work_j``/``counts``: the frontier's work list (module
    docstring); ``l`` (1,) int32; ``u``/``v`` (>= m,) edge endpoints;
    ``Es`` CSR offsets; ``N``/``Eid`` (two_m,); ``S_ext`` (m+1,) int32.
    ``dec``: an all-zero (m+1,) int32 buffer to fold into; ``touched``: an
    (m,) int32 list that receives the decremented edges, their number
    added to ``counts[3]`` (0 on entry); both allocated when None.
    """
    dev = S_ext.device
    if dev.type == "cpu":
        return peel_decrement_fold_ref(
            work_e, work_j, counts, l, u, v, Es, N, Eid, S_ext, processed,
            inCurr, pinned, m=m, dec=dec, touched=touched)
    if dev.type != "cuda":
        raise ValueError(f"peel_decrement_fold: unsupported device {dev}")
    _check_work(dev, work_e, work_j)
    cuda_build.check_int32("counts", counts, dev, (4,))
    cuda_build.check_int32("l", l, dev, (1,))
    _check_edges(dev, u, v, Es, 0)
    two_m = N.shape[0]
    cuda_build.check_int32("N", N, dev, (two_m,))
    cuda_build.check_int32("Eid", Eid, dev, (two_m,))
    cuda_build.check_int32("S_ext", S_ext, dev, (m + 1,))
    for name, t in (("processed", processed), ("inCurr", inCurr)):
        cuda_build.check_mask(name, t, dev, (m + 1,))
    if pinned is not None:
        cuda_build.check_mask("pinned", pinned, dev, (m + 1,))
    if dec is None:
        dec = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if touched is None:
        touched = torch.empty(m, dtype=torch.int32, device=dev)
    cuda_build.check_int32("dec", dec, dev, (m + 1,))
    cuda_build.check_int32("touched", touched, dev, (m,))
    if two_m == 0 or work_e.shape[0] == 0:
        return dec, touched
    _launch("peel", "peel_decrement_fold_launch", work_e, work_j, counts, l,
            u, v, Es, N, Eid, S_ext, processed, inCurr, pinned, dec, touched,
            WORK_SLICE)
    COUNTS.launched()
    return dec, touched


def decrement_rows(dec, e1, cand, lo, hi, N, Eid, S_ext, processed, inCurr,
                   pinned, l, *, iters: int) -> None:
    """Fold the decrements of a batch of wedge rows into ``dec`` in place.

    The row arithmetic of the JAX package's ``chunk_contrib``
    (``core/pkt.py``) and of its Pallas kernel body, in torch ops: shared by
    the plain version below and the torch executors of ``core/pkt.py``.
    ``processed``/``inCurr``/``pinned`` are bool; ``l`` is a 0-d tensor.
    """
    hit, safe = wedge_common.probe(N, cand, lo, hi, iters=iters)
    e2 = Eid[cand]
    e3 = Eid[safe]
    valid = inCurr[e1] & hit & ~processed[e2] & ~processed[e3]
    dec2 = valid & (S_ext[e2] > l) & (~inCurr[e3] | (e1 < e3))
    dec3 = valid & (S_ext[e3] > l) & (~inCurr[e2] | (e1 < e2))
    if pinned is not None:
        dec2 &= ~pinned[e2]
        dec3 &= ~pinned[e3]
    dec.index_add_(0, e2, dec2.to(torch.int32))
    dec.index_add_(0, e3, dec3.to(torch.int32))


def peel_decrement_fold_ref(work_e, work_j, counts, l, u, v, Es, N, Eid,
                            S_ext, processed, inCurr, pinned=None, *, m: int,
                            dec=None, touched=None):
    """Plain PyTorch version of ``peel_decrement_fold`` (same contract).

    Expands the work items into their wedge rows with torch ops, in slices
    of ``wedge_common.SLICE_ROWS`` rows, and folds them with
    ``decrement_rows``; the search runs enough halvings for the longest
    probe list, so it finds the exact lower bound.  The touched list comes
    out as ``nonzero(dec)``, in ascending order.
    """
    COUNTS.ran_plain()
    dev = S_ext.device
    if dec is None:
        dec = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if touched is None:
        touched = torch.empty(m, dtype=torch.int32, device=dev)
    n = int(counts[0])
    if n == 0 or N.shape[0] == 0:
        return dec, touched
    e = work_e[:n].long()
    s0, n_scan, lo, hi = _scan_probe(e, u, v, Es)
    start = s0 + work_j[:n] * WORK_SLICE
    n_cand = torch.clamp(n_scan - work_j[:n] * WORK_SLICE, max=WORK_SLICE)
    iters = max(1, int((hi - lo).max()).bit_length())
    ends = torch.cumsum(n_cand.long(), 0)
    proc = processed.bool()
    curr = inCurr.bool()
    pin = None if pinned is None else pinned.bool()
    lv = l.reshape(())
    for r0, r1 in wedge_common.row_slices(int(ends[-1])):
        rows = torch.arange(r0, r1, device=dev, dtype=torch.int64)
        item = torch.searchsorted(ends, rows, right=True)
        cand = (start[item] + (rows - (ends[item] - n_cand[item]))).to(
            torch.int32)
        decrement_rows(dec, e[item], cand, lo[item], hi[item], N, Eid, S_ext,
                       proc, curr, pin, lv, iters=iters)
    hit = torch.nonzero(dec[:m])[:, 0].to(torch.int32)
    touched[:hit.shape[0]] = hit
    counts[3] = hit.shape[0]
    return dec, touched


def apply_decrements(dec, S_ext, processed, inCurr, l, m: int):
    """One sub-level's state update in torch ops, in place; returns the next
    frontier mask.

    ``S ← where(~processed & ~inCurr & dec > 0, max(S − dec, l), S)``, then
    ``processed |= inCurr`` and ``inCurr' = ~processed & (S == l)`` with
    slot ``m`` off — the body of the JAX package's sub-level.
    """
    S_ext.copy_(torch.where(~processed & ~inCurr & (dec > 0),
                            torch.maximum(S_ext - dec, l), S_ext))
    processed |= inCurr
    nxt = ~processed & (S_ext == l)
    nxt[m] = False
    return nxt


def _next_frontier(nxt_ids, u, v, Es, front, work_e, work_j, counts) -> None:
    """Write the next frontier ``nxt_ids`` (ascending) as an id list and a
    work list; ``counts[:2] = [n_items, n_front]``."""
    front[:nxt_ids.shape[0]] = nxt_ids
    frontier_work(nxt_ids, u, v, Es, work_e, work_j, counts)


def dense_update(dec, S_ext, processed, inCurr, l, u, v, Es, front, work_e,
                 work_j, counts, *, m: int) -> None:
    """One sub-level's state update over all ``m + 1`` slots, in place (see
    ``apply_decrements``).

    Also writes the next frontier's id list into ``front`` ((m+1,) int32)
    and its work list into ``work_e``/``work_j``, sets ``counts = [n_items,
    n_front, n_done, 0]`` (``n_done``: processed slots of the m+1) and
    zeroes ``dec``.  With ``dec`` all zero and ``inCurr`` empty it forms the
    first frontier of level ``l``.  ``processed`` and ``inCurr`` are bool.
    """
    dev = S_ext.device
    if dev.type == "cpu":
        dense_update_ref(dec, S_ext, processed, inCurr, l, u, v, Es, front,
                         work_e, work_j, counts, m=m)
        return
    if dev.type != "cuda":
        raise ValueError(f"dense_update: unsupported device {dev}")
    _check_state(dev, dec, S_ext, processed, inCurr, m)
    cuda_build.check_int32("l", l, dev, (1,))
    _check_edges(dev, u, v, Es, m)
    cuda_build.check_int32("front", front, dev, (m + 1,))
    _check_work(dev, work_e, work_j)
    cuda_build.check_int32("counts", counts, dev, (4,))
    _launch("peel", "dense_update_launch", dec, S_ext, processed, inCurr, l,
            u, v, Es, front, work_e, work_j, counts, m, WORK_SLICE)
    DENSE_COUNTS.launched()


def dense_update_ref(dec, S_ext, processed, inCurr, l, u, v, Es, front,
                     work_e, work_j, counts, *, m: int) -> None:
    """Plain PyTorch version of ``dense_update`` (same contract); the id
    and work lists come out in ascending edge order."""
    DENSE_COUNTS.ran_plain()
    nxt = apply_decrements(dec, S_ext, processed, inCurr, l.reshape(()), m)
    inCurr.copy_(nxt)
    dec.zero_()
    _next_frontier(torch.nonzero(nxt)[:, 0].to(torch.int32), u, v, Es, front,
                   work_e, work_j, counts)
    counts[2] = processed.sum()
    counts[3] = 0


def sublevel_update(dec, S_ext, processed, inCurr, l, u, v, Es, touched,
                    front_in, counts_in, front_out, work_e, work_j,
                    counts_out, *, m: int) -> None:
    """The sub-level update after a fold, visiting only the old frontier
    and the touched edges, in place.

    Reads the old frontier ``front_in[:counts_in[1]]`` and the fold's
    touched list ``touched[:counts_in[3]]``: marks the old frontier
    processed and off the frontier, applies ``S ← max(S − dec, l)`` and
    ``dec ← 0`` to the touched edges, and puts each touched edge that
    reaches ``S == l`` on the next frontier (``inCurr``, ``front_out``, the
    work list).  ``counts_out = [n_items, n_front, n_done + n_front_in,
    0]``.  Equal to ``dense_update`` on the states the peel reaches: within
    a level every live edge off the frontier has ``S > l``, so no edge off
    both lists can join the next frontier.
    """
    dev = S_ext.device
    if dev.type == "cpu":
        sublevel_update_ref(dec, S_ext, processed, inCurr, l, u, v, Es,
                            touched, front_in, counts_in, front_out, work_e,
                            work_j, counts_out, m=m)
        return
    if dev.type != "cuda":
        raise ValueError(f"sublevel_update: unsupported device {dev}")
    _check_state(dev, dec, S_ext, processed, inCurr, m)
    cuda_build.check_int32("l", l, dev, (1,))
    _check_edges(dev, u, v, Es, m)
    cuda_build.check_int32("touched", touched, dev, (m,))
    for name, t in (("front_in", front_in), ("front_out", front_out)):
        cuda_build.check_int32(name, t, dev, (m + 1,))
    for name, t in (("counts_in", counts_in), ("counts_out", counts_out)):
        cuda_build.check_int32(name, t, dev, (4,))
    _check_work(dev, work_e, work_j)
    _launch("peel", "sparse_update_launch", dec, S_ext, processed, inCurr, l,
            u, v, Es, touched, front_in, counts_in, front_out, work_e, work_j,
            counts_out, m, WORK_SLICE)
    UPDATE_COUNTS.launched()


def sublevel_update_ref(dec, S_ext, processed, inCurr, l, u, v, Es, touched,
                        front_in, counts_in, front_out, work_e, work_j,
                        counts_out, *, m: int) -> None:
    """Plain PyTorch version of ``sublevel_update`` (same contract); the
    next frontier's id and work lists come out in ascending edge order."""
    UPDATE_COUNTS.ran_plain()
    _, n_front, n_done, n_touched = counts_in.tolist()
    old = front_in[:n_front].long()
    processed[old] = True
    inCurr[old] = False
    t = touched[:n_touched].long()
    s = torch.maximum(S_ext[t] - dec[t], l.reshape(()))
    S_ext[t] = s
    dec[t] = 0
    nxt = torch.sort(t[s == l.reshape(())]).values
    inCurr[nxt] = True
    _next_frontier(nxt.to(torch.int32), u, v, Es, front_out, work_e, work_j,
                   counts_out)
    counts_out[2] = n_done + n_front
    counts_out[3] = 0


def peel_loop(S_ext, processed, u, v, Es, N, Eid, pinned=None, *, m: int,
              work_cap: int, stop_live: int = 0) -> LoopResult:
    """Peel whole levels over the (m+1,) state in place, in one launch.

    Runs levels while more than ``stop_live`` of the ``m + 1`` slots are
    unprocessed (the test is made at each level's start): a level starts
    with ``l = min(live S)`` and the dense walk, then folds and sparse
    updates until the frontier is empty.  ``S_ext`` (m+1,) int32 and
    ``processed`` (m+1,) bool are updated in place; ``u``/``v``/``Es`` are
    the edge endpoints and CSR offsets, ``N``/``Eid`` the adjacency,
    ``pinned`` the schedule edges or None, ``work_cap`` the work list's
    size (``work_capacity``).  On CUDA tensors: one cooperative launch of
    ``peel_loop_kernel`` and one read of its result; a launch the card
    refuses, or a segment past ``m`` sub-levels, raises ``KernelError``.
    """
    dev = S_ext.device
    if dev.type == "cpu":
        return peel_loop_ref(S_ext, processed, u, v, Es, N, Eid, pinned, m=m,
                             work_cap=work_cap, stop_live=stop_live)
    if dev.type != "cuda":
        raise ValueError(f"peel_loop: unsupported device {dev}")
    if stop_live < 0:
        raise ValueError(f"stop_live must be >= 0, got {stop_live}")
    cuda_build.check_int32("S_ext", S_ext, dev, (m + 1,))
    cuda_build.check_mask("processed", processed, dev, (m + 1,))
    _check_edges(dev, u, v, Es, m)
    two_m = N.shape[0]
    cuda_build.check_int32("N", N, dev, (two_m,))
    cuda_build.check_int32("Eid", Eid, dev, (two_m,))
    if pinned is not None:
        cuda_build.check_mask("pinned", pinned, dev, (m + 1,))
    buf = buffers(m, work_cap, dev)
    inCurr = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    _launch("peel", "peel_loop_launch", buf.dec, S_ext, processed, inCurr, u,
            v, Es, N, Eid, pinned, buf.touched, buf.front, buf.work_e,
            buf.work_j, buf.counts, buf.ctl, m, WORK_SLICE, stop_live)
    LOOP_COUNTS.launched()
    t0 = time.perf_counter_ns()
    levels, subs, n_done, status, blocks = buf.ctl[4:].tolist()
    wait = time.perf_counter_ns() - t0
    if status != 0:
        _overrun(subs, m)
    return LoopResult(levels, subs, 1, wait, blocks, m + 1 - n_done)


def _overrun(subs: int, m: int):
    raise cuda_build.KernelError(
        f"peel loop stopped after {subs} sub-levels of an edge space of "
        f"{m}: each sub-level retires an edge, so the state is not one the "
        f"peel reaches")


def host_loop(S_ext, processed, u, v, Es, N, Eid, pinned=None, *, m: int,
              work_cap: int, stop_live: int = 0) -> LoopResult:
    """``peel_loop`` driven from the host, one step wrapper at a time.

    A level starts with ``l = min(live S)`` on the device and
    ``dense_update`` over a zero ``dec`` and an empty frontier, which forms
    the level's first frontier (never empty: some live edge holds the
    minimum) and counts the processed slots.  A sub-level is
    ``peel_decrement_fold`` over the frontier's work list, then
    ``sublevel_update``; the frontier id lists and their counts alternate
    between two buffers (``p``).  The host then reads ``[#frontier,
    #processed]`` once.  On CPU tensors every step runs its plain version
    (this is ``peel_loop_ref``); on CUDA tensors it launches the three
    standalone kernels.  Past ``m`` sub-levels it raises ``KernelError``, as
    ``peel_loop`` does.
    """
    dev = S_ext.device
    inCurr = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    buf = buffers(m, work_cap, dev)
    work = (buf.work_e, buf.work_j)
    front, counts = buf.front.unbind(), buf.counts.unbind()
    todo = (m + 1) - int(processed.sum())
    levels = subs = p = wait = 0
    while todo > stop_live:
        l = torch.where(processed, SENTINEL_S, S_ext).min().reshape(1)
        dense_update(buf.dec, S_ext, processed, inCurr, l, u, v, Es, front[p],
                     *work, counts[p], m=m)
        levels += 1
        while True:
            peel_decrement_fold(*work, counts[p], l, u, v, Es, N, Eid, S_ext,
                                processed, inCurr, pinned, m=m, dec=buf.dec,
                                touched=buf.touched)
            sublevel_update(buf.dec, S_ext, processed, inCurr, l, u, v, Es,
                            buf.touched, front[p], counts[p], front[1 - p],
                            *work, counts[1 - p], m=m)
            p = 1 - p
            subs += 1
            if subs > m:
                _overrun(subs, m)
            t0 = time.perf_counter_ns()
            n_front, n_done = counts[p][1:3].tolist()
            wait += time.perf_counter_ns() - t0
            if not n_front:
                break
        todo = (m + 1) - n_done
    return LoopResult(levels, subs, subs, wait, 0, todo)


def peel_loop_ref(S_ext, processed, u, v, Es, N, Eid, pinned=None, *,
                  m: int, work_cap: int, stop_live: int = 0) -> LoopResult:
    """Plain PyTorch version of ``peel_loop`` (same contract):
    ``host_loop``, whose steps run their plain versions."""
    LOOP_COUNTS.ran_plain()
    return host_loop(S_ext, processed, u, v, Es, N, Eid, pinned, m=m,
                     work_cap=work_cap, stop_live=stop_live)


def resident_grids() -> dict:
    """``{"loop": n, "fold": n}``: the blocks of the fused loop and of K2
    that the current card holds at once (their registers and shared memory
    set them)."""
    lib = cuda_build.library("peel")
    loop, fold = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.peel_loop_grid(ctypes.addressof(loop), ctypes.addressof(fold))
    cuda_build.check_launch(lib, "peel", code)
    return {"loop": loop.value, "fold": fold.value}
