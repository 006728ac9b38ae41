#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path — the one-shot PKT truss decomposition and the
engine that serves it — and its incremental path — a handle that takes edge
churn and answers community queries — on the card, and holds every
hand-written kernel against its plain PyTorch version.  Phases, one JSON
line each with its seconds:

1. environment: ``nvidia-smi`` name and power limit, torch version, device;
2. build: ``nvcc`` for every kernel source, all started together;
3. kernel check: K1 (support), K2 (peel) and the sub-level updates against
   their plain versions and the table-fed torch executors, bitwise, at full
   size — K1 on the whole graph, K2 and the updates on states from the
   first sub-level, a middle level (once with ``pinned``) and after a
   compaction: K2's touched list against ``nonzero(dec)``, the sparse
   update against its plain version, the dense update and the torch step;
   CUDA-graph times (the sparse and the dense update apart) beside the
   bounds computed from each call's inputs.  Then the fused peel loop (one
   launch a segment) against the host loop over those three kernels,
   bitwise on the state, levels and sub-levels: from the middle level with
   and without pinned edges, to the end and to the compaction point, and a
   pinned region peel (``peel_live_subset``);
4. main path: Graph500 R-MAT scale 17 / edge factor 16 / seed 0 through
   ``truss_pkt``'s steps with the default "kernel" executors, launch counts
   reset just before and read just after (1 K1, 1 fused loop a segment, no
   standalone K2 or update), then again with the torch executors; the two
   must agree bitwise; then the host loop over the standalone kernels, the
   loop the fused launch replaced, bitwise and with its launch counts, and
   the peel phase of both in turns (host, fused, fused, host); one traced
   run of each (device time by kernel) and one instrumented host-loop run
   (every K2 and update launch's bound, and the update bound with a dense
   ``dec`` read beside it);
5. small-graph oracle: ``truss_pkt`` on the card vs ``truss_numpy``;
6. engine: a seeded mix of 64 submissions through one ``TrussEngine``
   flush, each result equal to ``truss_pkt`` of the same graph;
7. K3 check: the intersect kernel against its plain version, bitwise on
   all three outputs, and its rows by path against each row's layout — a
   seeded sweep over the reference tests' shapes (int32 and int16; sorted,
   unsorted, duplicate, full, all-padding and 2–5-run rows), then every
   non-empty degree-class bucket of the scale-17 graph, every row searched,
   with CUDA-event times beside the bound (and the all-pairs bound);
8. support kernel path: ``compute_support_kernel`` at scale 17, launch
   counts reset just before and read just after, equal to K1's support;
   then once more under ``torch.profiler``;
9. engines: ``truss_trilist`` (once more under ``torch.profiler``),
   ``kcore_park`` and ``compute_support_ros`` at scale 17 against the main
   path and the host oracles, and ``truss_wc`` / ``truss_ros`` on the
   small-graph oracle suite;
10. cli: ``repro_torch.launch.truss.main`` with ``--verify`` on
    ``rmat-small`` for each of its four engines;
11. incremental: the scale-17 graph opened as an engine handle (K1 and
    peel-loop launches counted from 0 over the open), its trussness against
    ``truss_pkt`` and its triangle list against the device enumeration and
    the support; then churn batches of ``benchmarks/inc_bench.py``'s shape
    (remove k edges, add k absent ones: 4 at 0.1 % of m, 2 at 1 %), each
    with its launches counted from 0, its region peels by rung, and its
    trussness held bitwise against a from-scratch ``truss_pkt``; one more
    0.1 % batch forced onto the device rung if none took it (the peel
    loop over ``peel_live_subset`` with the boundary pinned); the host
    ``triangles_through`` of a 1 % batch timed alone; batched ≡ sequential
    ≡ from scratch on ``rmat-small`` and ``ba-small``; and a seeded
    "corrupt" fault at the region site raising ``IntegrityError`` with the
    committed state unchanged;
12. hierarchy: the churned handle's community index built in device mode
    (seconds, stats, flood rounds, peak memory), three levels against
    scipy's connected components, the invariants at every level on the
    device, and device ≡ host on ``rmat-small`` before and after a batch
    that remaps the upper levels;
13. cli_updates: ``repro_torch.launch.truss.main`` with ``--update-stream
    4 --churn 0.01 --query-communities 4 --verify`` on ``rmat-small``;
14. serve: the scale-17 graph opened through ``TrussScheduler.open_async``
    (a watchdog on, the kernels built before), the CLI's seeded ``--serve``
    schedule replayed against it (90/9/1 query/update/open, 100 requests at
    100 per second), then the engine phase's 64 graphs through
    ``submit_async``; K1 and peel-loop launches counted from 0 over the
    phase; latencies by kind, the stage breakdown and each repair's mode; every
    result bitwise against a synchronous replay on a second handle and the
    synchronous engine;
15. chaos: forced kernel-rung flush failures demote the flush ladder to
    ``chunked+torch`` and recovery re-promotes it to ``kernel+kernel``
    (peel-loop launches per request: none on the demoted rung, some
    after), outputs
    bitwise; one injected fault per dispatch site retried to parity; the
    CLI's ``--serve 200 --fault-rate 0.1 --deadline-ms 250 --verify`` on
    ``rmat-small``;
16. dist: ``pkt_dist`` on the scale-17 graph in a one-rank ``nccl`` group
    (its K1 launch counted from 0, its peak memory), bitwise against
    ``pkt`` with the torch executors; K1 over two edge ranges summed
    against K1 over ``[0, m)``.

Any mismatch or exception exits non-zero; no phase catches its own failure.
The line before the last holds the per-kernel summary, and the last line is
``{"ok": true, "device": {...}}``.

Run from the repository root; it takes no arguments::

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet) for the roofline bounds: device-memory
#: bandwidth, and the int32 issue rate of the CUDA cores — 132 SMs x 64
#: INT32 lanes x the 1,980 MHz maximum boost clock, one operation per lane
#: per cycle — for the kernels' scalar integer work (adds, compares,
#: address arithmetic; no multiply-add counted twice)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

SCALE, EDGE_FACTOR, SEED = 17, 16, 0

#: submissions in the engine phase
ENGINE_GRAPHS = 64

#: the sparse update walks all slots when its touched list holds more than
#: m / UPDATE_DENSE_SHARE edges (``kDenseShare`` in csrc/peel.cu)
UPDATE_DENSE_SHARE = 8

#: where the phases run; the script is for the card and refuses to run
#: without one
DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    """One JSON line per phase."""
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def search_steps(lo, hi) -> int:
    """Halvings the binary searches of these rows need, summed exactly."""
    length = (hi - lo).clamp(min=0).to(torch.float64)
    return int(torch.ceil(torch.log2(length + 1)).sum())


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work: bytes over bandwidth vs ops over rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def cuda_ms_each(setup, fn, reps: int) -> float:
    """Mean milliseconds of one ``fn(*setup())`` by CUDA events around each
    launch alone: for kernels that change their inputs, ``setup`` makes
    fresh ones outside the timed window."""
    fn(*setup())  # warm up
    total = 0.0
    for _ in range(reps):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def graph_ms(fn, restore=None, per_graph: int = 10, reps: int = 5) -> float:
    """Mean device milliseconds of one ``fn()``, from a CUDA graph of
    ``per_graph`` calls replayed ``reps`` times between CUDA events.

    The graph runs the launches back to back on the device, without the
    host time between them that a launch of a few microseconds cannot hide.
    ``restore`` (when given) runs before each call to reset the inputs that
    ``fn`` changes; a graph of ``restore`` alone is timed the same way and
    subtracted.
    """
    def timed(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(per_graph):
                body()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (reps * per_graph)

    if restore is None:
        return timed(fn)

    def both():
        restore()
        fn()

    return timed(both) - timed(restore)


def wedge_ops(n_scan, n_probe) -> int:
    """Compares the wedge intersections need: per edge the fewer of a merge
    (scan + probe) and a search (scan x ceil(log2(probe + 1)))."""
    n_scan = n_scan.to(torch.float64)
    n_probe = n_probe.to(torch.float64)
    search = n_scan * torch.ceil(torch.log2(n_probe + 1))
    return int(torch.minimum(n_scan + n_probe, search).sum())


def k1_bound(g, dev, mods, n_chunks) -> tuple:
    """Bytes and operations of the support phase on ``g``: each N+ list
    (m ids in all), Eid of the hit slots, the endpoints, the CSR offsets
    and the row offsets read once; S and the partials written once."""
    tl = mods["trilist"]
    tri = tl._triangles_dev(g, dev)
    hit_slots = int(torch.unique(torch.cat([tri[:, 1], tri[:, 2]])).numel())
    del tri
    torch.cuda.empty_cache()
    m, n = g.m, g.n
    nbytes = (4 * m + 4 * hit_slots + 8 * m + 4 * (2 * n + 1)
              + 4 * (m + 1) + 4 * (m + 1) + 4 * n_chunks)
    dplus = g.dplus.astype(np.int64)
    ops = wedge_ops(torch.from_numpy(dplus[g.El[:, 1]]),
                    torch.from_numpy(dplus[g.El[:, 0]]))
    return nbytes, ops, hit_slots


def check_k1(g, dev, mods) -> dict:
    """K1 vs its plain version, both fed by the CSR, and vs the torch
    executor over the device-built table, on the full-size graph."""
    wc, sup, ks = mods["wc"], mods["support"], mods["ksupport"]
    size = sup.support_table_size(g)
    size_pad = wc.next_pow2(size)
    chunk = wc.pow2_chunk(size_pad, None, size=size)
    n_chunks = size_pad // chunk
    arrays = g.device_arrays(dev)
    args = tuple(arrays[k] for k in ("u", "v", "Es", "Eo", "N", "Eid"))
    kw = dict(m=g.m, chunk=chunk, n_chunks=n_chunks)
    S_k, tri_k = ks.support_accumulate(*args, **kw)
    S_p, tri_p = ks.support_accumulate_ref(*args, **kw)
    e1, cand, lo, hi, _ = sup._build_support_table_dev(
        arrays["u"], arrays["v"], arrays["Es"], arrays["Eo"], g.m, m=g.m,
        size=size_pad)
    iters = sup._search_iters(g, oriented=True)
    S_t = sup._support_torch(arrays["N"], arrays["Eid"], e1, cand, lo, hi,
                             iters, g.m)
    torch.cuda.synchronize()
    table_ms = cuda_ms(lambda: sup._support_torch(
        arrays["N"], arrays["Eid"], e1, cand, lo, hi, iters, g.m), 1)
    del e1, cand, lo, hi
    torch.cuda.empty_cache()
    err = max(max_abs_err(S_k, S_p), max_abs_err(tri_k, tri_p),
              max_abs_err(S_k[:g.m], S_t))
    if err != 0:
        raise AssertionError(f"K1 disagrees with its plain version or the "
                             f"table-fed torch executor: {err}")
    if int(tri_k.sum()) * 3 != int(S_k[:g.m].sum()):
        raise AssertionError("K1 triangle partials do not sum to S.sum()/3")
    ms = cuda_ms(lambda: ks.support_accumulate(*args, **kw), 5)
    device_ms = graph_ms(lambda: ks.support_accumulate(*args, **kw),
                         per_graph=2, reps=2)
    plain_ms = cuda_ms(lambda: ks.support_accumulate_ref(*args, **kw), 1)
    nbytes, ops, hit_slots = k1_bound(g, dev, mods, n_chunks)
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(rows=size, rows_padded=size_pad, chunk=chunk,
                triangles=int(tri_k.sum()), hit_slots=hit_slots,
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, table_torch_executor_ms=table_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, S0=S_k[:g.m].clone())


def k2_call_bound(front, csr, N, Eid, pinned, mods, n_touched) -> tuple:
    """Bytes, operations and wedge rows of one decrement fold over the
    frontier edges ``front``: their ids and endpoints, the CSR offsets and
    adjacency lists of the endpoints and Eid of the hit slots read once;
    the state of the hit edges read once, their ``dec`` and the touched
    list (``n_touched`` ids) written once.  ``dec`` is written only where a
    hit lands (the update zeroes it), and the work list is the kernel's own
    form of the frontier, so neither counts in full."""
    kp, wc = mods["kpeel"], mods["wc"]
    s0, n_scan, lo, hi = kp._scan_probe(front, csr.u, csr.v, csr.Es)
    ends = torch.cumsum(n_scan.long(), 0)
    iters = max(1, int((hi - lo).max()).bit_length()) if front.numel() else 1
    slots = []
    for r0, r1 in wc.row_slices(int(ends[-1]) if front.numel() else 0):
        rows = torch.arange(r0, r1, device=N.device, dtype=torch.int64)
        k = torch.searchsorted(ends, rows, right=True)
        cand = (s0[k] + (rows - (ends[k] - n_scan[k]))).to(torch.int32)
        hit, safe = wc.probe(N, cand, lo[k], hi[k], iters=iters)
        slots += [cand[hit], safe[hit].to(torch.int32)]
    hit_slots = (torch.unique(torch.cat(slots)) if slots
                 else torch.zeros(0, dtype=torch.int32, device=N.device))
    hit_edges = int(torch.unique(Eid[hit_slots.long()]).numel())
    f = front.long()
    verts = torch.unique(torch.cat([csr.u[f], csr.v[f]])).long()
    deg = csr.Es[verts + 1] - csr.Es[verts]
    # S, processed, inCurr (and pinned) read, dec written
    state = 4 + 1 + 1 + (0 if pinned is None else 1) + 4
    nbytes = (4 * int(deg.sum()) + 8 * int(verts.numel())
              + 4 * int(hit_slots.numel()) + state * hit_edges
              + 12 * int(front.numel()) + 4 * n_touched)
    ops = wedge_ops(n_scan, (hi - lo))
    return nbytes, ops, int(ends[-1]) if front.numel() else 0


def update_bounds(m, n_front, n_touched, n_next) -> tuple:
    """Bytes of one sub-level update: the graph's need, and with a dense
    ``dec`` read.

    Restated, the work the graph needs: each old frontier edge's id read
    and its two flags written; each touched edge's id (the touched list),
    dec and S read and its S and dec written; the next frontier's flag and
    id written.  A level's start (``n_front == 0``: no fold before it)
    reads S and processed over the m + 1 slots instead.  The dense
    statement counts a ``dec`` read over the m + 1 slots after every fold
    and 14 B a decremented edge (S read and written, flags read, dec
    zeroed), what a pass over all slots reads."""
    if not n_front:
        level_start = 5 * (m + 1) + 5 * n_next
        return level_start, level_start
    restated = 6 * n_front + 20 * n_touched + 5 * n_next
    old = 4 * (m + 1) + 6 * n_front + 14 * n_touched + 5 * n_next
    return restated, old


class K2Bounds:
    """Wraps the K2 and update entry points of ``kernels/peel.py`` for one
    instrumented run: each call's bound is computed from its own inputs
    and outputs (reading them costs host syncs, so the run is not a timed
    one).  ``calls`` holds ``(kind, bytes, ops, rows)`` for the fold and
    ``(kind, bytes, 0, bytes with a dense dec read)`` for the updates."""

    def __init__(self, mods):
        self.kp = mods["kpeel"]
        self.mods = mods
        self.calls = []

    def __enter__(self):
        kp = self.kp
        self.saved = (kp.peel_decrement_fold, kp.sublevel_update,
                      kp.dense_update)
        orig_fold, orig_sparse, orig_dense = self.saved

        def fold(work_e, work_j, counts, l, u, v, Es, N, Eid, S_ext,
                 processed, inCurr, pinned=None, *, m, **kw):
            n = int(counts[0])
            front = work_e[:n][work_j[:n] == 0]
            out = orig_fold(work_e, work_j, counts, l, u, v, Es, N, Eid,
                            S_ext, processed, inCurr, pinned, m=m, **kw)
            csr = self.mods["pkt"].PeelCSR(u, v, Es, 0)
            self.calls.append(("fold",) + k2_call_bound(
                front, csr, N, Eid, pinned, self.mods, int(counts[3])))
            return out

        def sparse(*args, m):
            _, n_front, _, n_touched = args[10].tolist()
            orig_sparse(*args, m=m)
            new, old = update_bounds(m, n_front, n_touched, int(args[-1][1]))
            self.calls.append(("update", new, 0, old))

        def dense(*args, m):
            dec, curr = args[0], args[3]
            n_dec, n_front = int((dec != 0).sum()), int(curr.sum())
            orig_dense(*args, m=m)
            new, old = update_bounds(m, n_front, n_dec, int(args[-1][1]))
            self.calls.append(("dense", new, 0, old))

        kp.peel_decrement_fold = fold
        kp.sublevel_update, kp.dense_update = sparse, dense
        return self

    def __exit__(self, *exc):
        (self.kp.peel_decrement_fold, self.kp.sublevel_update,
         self.kp.dense_update) = self.saved

    def summed(self, kind) -> dict:
        """Calls of ``kind`` and their bounds summed; for the updates also
        the bound with a dense ``dec`` read."""
        rows = [c for c in self.calls if c[0] == kind]
        b = [bound_ms(nb, ops) for _, nb, ops, _ in rows]
        out = dict(calls=len(rows), bound_ms=sum(t for t, _ in b),
                   bound_by={by: sum(1 for _, x in b if x == by)
                             for by in ("bytes", "operations")},
                   bytes=sum(r[1] for r in rows),
                   ops=sum(r[2] for r in rows))
        if kind != "fold":
            out["bound_ms_dense_dec"] = sum(bound_ms(r[3], 0)[0] for r in rows)
        return out


def k2_case(label, st, mods) -> dict:
    """K2 and the sub-level updates against their plain versions and the
    table-fed torch executor ("chunked") at one peel state, the first
    sub-level of its level: the dense update forms the level's frontier,
    the fold lists its touched edges, and the sparse update (and the dense
    one, for comparison) consumes them.  CUDA-graph times beside the
    bounds."""
    pkt_mod, kp = mods["pkt"], mods["kpeel"]
    csr, tabs = st["csr"], st["tabs"]
    N, Eid, m, pinned = st["N"], st["Eid"], st["m"], st["pinned"]
    S_ext, processed = st["S_ext"], st["processed"]
    dev = S_ext.device
    zeros = functools.partial(torch.zeros, m + 1, device=dev)
    l = torch.where(processed, pkt_mod._SENTINEL_S, S_ext).min().reshape(1)

    def buffers():
        buf = kp.buffers(m, csr.work_cap, dev)
        for t in (buf.touched, buf.front, buf.work_e, buf.work_j):
            t.fill_(-1)
        return buf

    def same_set(x, y) -> bool:
        return torch.equal(torch.sort(x.long()).values,
                           torch.sort(y.long()).values)

    def items(buf, p) -> torch.Tensor:
        n_it = int(buf.counts[p, 0])
        pair = buf.work_e[:n_it].long() * (1 << 20) + buf.work_j[:n_it]
        return torch.sort(pair).values

    # the level's first frontier, made by the dense update (level start)
    lvl = buffers()
    inCurr = zeros(dtype=torch.bool)
    S0, P0 = S_ext.clone(), processed.clone()
    kp.dense_update(lvl.dec, S0, P0, inCurr, l, csr.u, csr.v, csr.Es,
                    lvl.front[0], lvl.work_e, lvl.work_j, lvl.counts[0], m=m)
    want = ~processed & (S_ext == l)
    want[m] = False
    n_front0 = int(lvl.counts[0, 1])
    if not (torch.equal(inCurr, want) and torch.equal(S0, S_ext)
            and torch.equal(P0, processed)
            and int(lvl.counts[0, 2]) == int(processed.sum())
            and same_set(lvl.front[0, :n_front0],
                         torch.nonzero(want)[:, 0])):
        raise AssertionError(f"dense update ({label}): level start")
    front = lvl.front[0, :n_front0].clone()
    work_e, work_j = lvl.work_e, lvl.work_j
    fold_args = (l, csr.u, csr.v, csr.Es, N, Eid, S_ext, processed, inCurr,
                 pinned)

    def fold_counts():
        return lvl.counts[0].clone()  # n_touched 0, as a fold needs

    counts = fold_counts()
    dec_k, touched_k = kp.peel_decrement_fold(work_e, work_j, counts,
                                              *fold_args, m=m)
    counts_p = fold_counts()
    dec_p, touched_p = kp.peel_decrement_fold_ref(work_e, work_j, counts_p,
                                                  *fold_args, m=m)
    # the same frontier in a shuffled order, listed by torch ops
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shuffled = front[torch.randperm(front.numel(), generator=gen,
                                    device=dev)]
    sh = buffers()
    kp.frontier_work(shuffled, csr.u, csr.v, csr.Es, sh.work_e, sh.work_j,
                     sh.counts[0])
    dec_s, touched_s = kp.peel_decrement_fold(sh.work_e, sh.work_j,
                                              sh.counts[0], *fold_args, m=m)
    dec_t = pkt_mod._decrements(
        "chunked", N, Eid, S_ext, processed, inCurr, l.reshape(()), tabs,
        pinned=pinned, m=m, chunk=st["chunk"], n_chunks=st["n_chunks"],
        iters=st["iters"])
    torch.cuda.synchronize()
    err = max(max_abs_err(dec_k, dec_p), max_abs_err(dec_k, dec_s),
              max_abs_err(dec_k[:m], dec_t[:m]), int(dec_k[m].abs()))
    if err != 0:
        raise AssertionError(f"K2 ({label}) disagrees with its plain version "
                             f"or the chunked torch executor: {err}")
    n_touched = int(counts[3])
    nz = torch.nonzero(dec_k[:m])[:, 0]
    if not (n_touched == nz.numel() == int(counts_p[3])
            == int(sh.counts[0, 3])
            and same_set(touched_k[:n_touched], nz)
            and torch.equal(touched_p[:n_touched].long(), nz)
            and same_set(touched_s[:n_touched], nz)):
        raise AssertionError(f"K2 ({label}): the touched list is not "
                             f"nonzero(dec)")
    n_items = int(counts[0])
    dec_acc = zeros(dtype=torch.int32)  # the graph's launches add into it
    t_acc = torch.empty(m, dtype=torch.int32, device=dev)
    ms = graph_ms(lambda: kp.peel_decrement_fold(
        work_e, work_j, fold_counts(), *fold_args, m=m, dec=dec_acc,
        touched=t_acc))
    plain_ms = cuda_ms_each(
        lambda: (zeros(dtype=torch.int32), fold_counts()),
        lambda dec, c: kp.peel_decrement_fold_ref(
            work_e, work_j, c, *fold_args, m=m, dec=dec), 1)
    nbytes, ops, _ = k2_call_bound(front, csr, N, Eid, pinned, mods,
                                   n_touched)
    b_ms, b_by = bound_ms(nbytes, ops)

    # the update after this fold: the sparse kernel and its plain version,
    # the dense kernel and its plain version, the torch executors' step
    def upd_state():
        buf = buffers()
        buf.dec.copy_(dec_k)
        buf.touched.copy_(touched_k)
        buf.front[0].copy_(lvl.front[0])
        buf.counts[0].copy_(counts)
        return buf, S_ext.clone(), processed.clone(), inCurr.clone()

    def sparse_args(buf, S, P, C):
        return (buf.dec, S, P, C, l, csr.u, csr.v, csr.Es, buf.touched,
                buf.front[0], buf.counts[0], buf.front[1], buf.work_e,
                buf.work_j, buf.counts[1])

    def dense_args(buf, S, P, C):
        return (buf.dec, S, P, C, l, csr.u, csr.v, csr.Es, buf.front[1],
                buf.work_e, buf.work_j, buf.counts[1])

    outs = []
    for fn, argf in ((kp.sublevel_update, sparse_args),
                     (kp.sublevel_update_ref, sparse_args),
                     (kp.dense_update, dense_args),
                     (kp.dense_update_ref, dense_args)):
        buf, S, P, C = upd_state()
        fn(*argf(buf, S, P, C), m=m)
        n_next = int(buf.counts[1, 1])
        outs.append(((buf.dec, S, P, C), buf.counts[1],
                     torch.sort(buf.front[1, :n_next].long()).values,
                     items(buf, 1)))
    tS, tP = S_ext.clone(), processed.clone()
    tC = kp.apply_decrements(dec_k.clone(), tS, tP, inCurr.clone(),
                             l.reshape(()), m)
    torch.cuda.synchronize()
    (kd, kS, kP, kC), k_counts, k_front, k_items = outs[0]
    upd_err = max(max_abs_err(x, y) for x, y in (
        (kd, torch.zeros_like(kd)), (kS, tS), (kP, tP), (kC, tC)))
    for state, cnt, fr, it in outs[1:]:
        upd_err = max([upd_err] + [max_abs_err(x, y) for x, y in
                                   zip((kd, kS, kP, kC), state)])
        if not (torch.equal(cnt, k_counts) and torch.equal(fr, k_front)
                and torch.equal(it, k_items)):
            upd_err = max(upd_err, 1)
    if upd_err != 0 or not torch.equal(k_front, torch.nonzero(tC)[:, 0]):
        raise AssertionError(f"update ({label}): the sparse update disagrees "
                             f"with its plain version, the dense update or "
                             f"the torch executors' step")

    # the dense update in its main-path role: a level's start (zero dec,
    # empty frontier)
    def start_state():
        buf = buffers()
        return buf, S_ext.clone(), processed.clone(), zeros(dtype=torch.bool)

    def upd_timed(fn, argf, state=upd_state):
        saved = state()
        work = state()

        def restore():
            for dst, src in zip((work[0].dec, *work[1:]),
                                (saved[0].dec, *saved[1:])):
                dst.copy_(src)

        return graph_ms(lambda: fn(*argf(*work), m=m), restore=restore)

    sparse_ms = upd_timed(kp.sublevel_update, sparse_args)
    dense_ms = upd_timed(kp.dense_update, dense_args)
    start_ms = upd_timed(kp.dense_update, dense_args, start_state)

    def plain_ms_of(fn, argf):
        return cuda_ms_each(lambda: argf(*upd_state()),
                            lambda *a: fn(*a, m=m), 1)

    sparse_plain_ms = plain_ms_of(kp.sublevel_update_ref, sparse_args)
    dense_plain_ms = plain_ms_of(kp.dense_update_ref, dense_args)
    n_items_next, n_front_next = k_counts[:2].tolist()
    u_bytes, u_bytes_old = update_bounds(m, n_front0, n_touched,
                                         n_front_next)
    s_bytes, _ = update_bounds(m, 0, 0, n_front0)
    return dict(state=label, level=int(l), pinned=pinned is not None,
                frontier_edges=n_front0, work_items=n_items,
                rows_frontier=int(torch.cumsum(kp._scan_probe(
                    front, csr.u, csr.v, csr.Es)[1].long(), 0)[-1]),
                decrements=int(dec_k.sum()), touched_edges=n_touched,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops,
                touched_list_equals_nonzero_dec=True,
                update=dict(max_abs_err=upd_err, ms=sparse_ms,
                            dense_ms=dense_ms, plain_ms=sparse_plain_ms,
                            dense_plain_ms=dense_plain_ms,
                            sparse_beats_dense=sparse_ms < dense_ms,
                            walks_all_slots=(n_touched
                                             > m // UPDATE_DENSE_SHARE),
                            bound_ms=bound_ms(u_bytes, 0)[0],
                            bound_by="bytes", bytes=u_bytes,
                            bound_ms_dense_dec=bound_ms(u_bytes_old, 0)[0],
                            bytes_dense_dec=u_bytes_old,
                            next_frontier_edges=n_front_next,
                            next_work_items=n_items_next),
                level_start=dict(ms=start_ms, bound_ms=bound_ms(s_bytes,
                                                                0)[0],
                                 bound_by="bytes", bytes=s_bytes))


def check_k2(g, dev, S0, mods) -> tuple:
    """K2 and the update at four states of a full-size run: a level's first
    sub-level at the start, at a middle level (with and without pinned
    edges) and after a compaction; and ``check_loop`` from the middle
    level.  Returns (the K2 cases, the loop check)."""
    pkt_mod, sup = mods["pkt"], mods["support"]
    m = g.m
    tabs, chunk, n_chunks = pkt_mod.prepare_peel_device(g, None, device=dev)
    csr = pkt_mod.prepare_peel_csr(g, device=dev)
    arrays = g.device_arrays(dev)
    N, Eid = arrays["N"], arrays["Eid"]
    iters = sup._search_iters(g)
    S_ext = torch.cat([S0, torch.full((1,), pkt_mod._SENTINEL_S,
                                      dtype=torch.int32, device=dev)])
    processed = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    processed[m] = True
    rng = np.random.default_rng(SEED)
    st = dict(csr=csr, tabs=tabs, chunk=chunk, n_chunks=n_chunks,
              iters=iters, N=N, Eid=Eid, m=m, pinned=None, S_ext=S_ext,
              processed=processed)
    cases = [k2_case("first sub-level", st, mods)]
    # a middle level: peel until half the edges are gone (level boundary)
    S_mid, p_mid, _, _, _ = pkt_mod._peel_loop(
        N, Eid, S_ext, processed, csr, m=m, chunk=None, n_chunks=None,
        iters=iters, mode="kernel", stop_live=m // 2)
    cases.append(k2_case("middle level", dict(st, S_ext=S_mid,
                                              processed=p_mid), mods))
    live_mid = ~p_mid.cpu().numpy()
    pin = torch.tensor(np.append(live_mid[:m] & (rng.random(m) < 0.25),
                                 False), device=dev)
    cases.append(k2_case("middle level, pinned",
                         dict(st, S_ext=S_mid, processed=p_mid, pinned=pin),
                         mods))
    loops = check_loop(g, dev, mods, dict(st, S_ext=S_mid, processed=p_mid,
                                          pinned=pin))
    # after a compaction: peel to the default compaction point, then gather
    # the survivors into a compacted subproblem as the segmented peel does
    target = int(pkt_mod._COMPACT_FRAC * m)
    S_c, p_c, _, _, _ = pkt_mod._peel_loop(
        N, Eid, S_mid, p_mid, csr, m=m, chunk=None, n_chunks=None,
        iters=iters, mode="kernel", stop_live=target)
    live_idx = np.nonzero(~p_c[:m].cpu().numpy())[0]
    del tabs, st
    torch.cuda.empty_cache()
    if live_idx.size:
        rows = (g.El[live_idx], live_idx, S_c[:m].cpu().numpy()[live_idx],
                None)
        sub = pkt_mod._make_subproblem(*rows, chunk_req=None,
                                       table_mode="device", mode="kernel",
                                       device=dev)
        sub_t = pkt_mod._make_subproblem(*rows, chunk_req=None,
                                         table_mode="device", mode="chunked",
                                         device=dev)
        cases.append(k2_case("after a compaction", dict(
            csr=sub["tabs"], tabs=sub_t["tabs"], chunk=sub_t["chunk"],
            n_chunks=sub_t["n_chunks"], iters=sub["iters"], N=sub["N"],
            Eid=sub["Eid"], m=sub["m"], pinned=None, S_ext=sub["S_ext0"],
            processed=sub["processed0"]), mods))
    return cases, loops


#: the reference tests' K3 shapes (``tests/test_kernels.py``) and row blocks
K3_SWEEP = ((1, 8, 8), (5, 8, 32), (17, 16, 16), (64, 32, 8), (33, 64, 128),
            (128, 128, 128), (3, 256, 64), (2, 256, 256))
K3_BLOCK_ROWS = (4, 64)


#: the b-row layouts of the sweep: the reference tests' sorted rows and
#: unsorted rows with repeats, and the layouts between which the kernel
#: chooses its path
K3_KINDS = ("sorted", "unsorted", "duplicates", "full", "padding", "runs2",
            "runs3", "runs4", "runs5")
#: the most non-decreasing runs of a b row that the kernel searches
K3_SEARCH_RUNS = 4


def k3_rows(rng, E, D, pad, dtype, kind):
    """(E, D) id rows of one layout: "sorted" (distinct ids, then ``pad``),
    "unsorted" (ids drawn with repeats from a small range, shuffled with
    pads, in more than ``K3_SEARCH_RUNS`` runs; D must exceed it), "duplicates" (sorted with repeats, then ``pad``), "full" (one
    sorted run, no padding), "padding" (all ``pad``) or "runs<k>" (``k``
    sorted runs, no padding; fewer when D < 2k)."""
    if kind == "unsorted":
        def draw():
            row = rng.integers(0, 24, size=D).astype(dtype)
            row[rng.random(D) < 0.2] = pad
            return row

        # redrawn until it has more runs than the kernel searches
        out = np.stack([draw() for _ in range(E)])
        for i in range(E):
            while k3_searched_rows(out[i:i + 1]):
                out[i] = draw()
        return out
    out = np.full((E, D), pad, dtype)
    if kind == "padding":
        return out
    for i in range(E):
        if kind == "sorted":
            vals = np.sort(rng.choice(500, size=int(rng.integers(0, D + 1)),
                                      replace=False))
        elif kind == "duplicates":
            vals = np.sort(rng.integers(0, 2 * D,
                                        size=int(rng.integers(0, D + 1))))
        elif kind == "full":
            vals = np.sort(rng.integers(0, 2 * D, size=D))
        else:
            k = min(int(kind[4:]), D // 2)
            lens = [D // k] * (k - 1) + [D - (D // k) * (k - 1)]
            # each run climbs from 0 to 2D, so each boundary descends
            vals = np.concatenate([np.sort(np.concatenate(
                [[0, 2 * D], rng.integers(0, 2 * D, size=n - 2)]))
                for n in lens])
        out[i, :vals.size] = vals
    return out


def k3_searched_rows(b) -> int:
    """Rows of ``b`` (numpy) the kernel should search: at most
    ``K3_SEARCH_RUNS`` maximal non-decreasing runs."""
    if b.shape[1] == 0:
        return b.shape[0]
    runs = 1 + (np.diff(b.astype(np.int64), axis=1) < 0).sum(axis=1)
    return int((runs <= K3_SEARCH_RUNS).sum())


def k3_compare(kint, a, b, block_rows, dev) -> dict:
    """K3 vs its plain version on one input; raises on any difference.
    Returns the kernel's rows by path for this launch."""
    kint.reset_path_rows()
    got = kint.intersect_blocked(a, b, block_rows=block_rows)
    paths = kint.path_rows(dev)
    want = kint.intersect_ref(a, b)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"K3 disagrees with its plain version on "
                             f"{tuple(a.shape)} x {tuple(b.shape)} "
                             f"{a.dtype}: {err}")
    if paths["search"] + paths["all_pairs"] != a.shape[0]:
        raise AssertionError(f"K3 counted {paths} rows of {a.shape[0]}")
    return paths


def check_k3_sweep(dev, kint) -> dict:
    """K3 on the reference tests' shapes: int32 and int16, block rows 4 and
    64, every b-row layout of ``K3_KINDS`` (a: sorted with repeats, or
    unsorted beside unsorted b).  Each launch's rows by path must be the
    layout's: every row of at most ``K3_SEARCH_RUNS`` runs searched, every
    other row all-pairs."""
    rng = np.random.default_rng(SEED)
    cases = 0
    by_kind = {k: dict(search=0, all_pairs=0) for k in K3_KINDS}
    for E, DA, DB in K3_SWEEP:
        for dtype in (np.int32, np.int16):
            for kind in K3_KINDS:
                a_kind = "unsorted" if kind == "unsorted" else "duplicates"
                a_np = k3_rows(rng, E, DA, -1, dtype, a_kind)
                b_np = k3_rows(rng, E, DB, -2, dtype, kind)
                if kind == "padding":
                    a_np[:, 0] = -2  # an id equal to the padding
                a = torch.tensor(a_np, device=dev)
                b = torch.tensor(b_np, device=dev)
                want = k3_searched_rows(b_np)
                for block_rows in K3_BLOCK_ROWS:
                    paths = k3_compare(kint, a, b, block_rows, dev)
                    if paths["search"] != want:
                        raise AssertionError(
                            f"K3 searched {paths['search']} rows of a "
                            f"{kind} {E}x{DB} b, expected {want}")
                    for key in by_kind[kind]:
                        by_kind[kind][key] += paths[key]
                    cases += 1
    # rows of at most two runs always search; unsorted rows never do, nor
    # five runs where the width holds them
    two_runs = ("sorted", "duplicates", "full", "padding", "runs2")
    if (any(by_kind[k]["all_pairs"] for k in two_runs)
            or by_kind["unsorted"]["search"]
            or not by_kind["runs5"]["all_pairs"]):
        raise AssertionError(f"K3 rows by layout and path: {by_kind}")
    return dict(cases=cases, shapes=len(K3_SWEEP), max_abs_err=0,
                rows_by_kind_and_path=by_kind)


def check_k3_buckets(g, dev, kint, ops) -> list:
    """K3 on every non-empty degree-class bucket of ``g``, built as
    ``compute_support_kernel`` builds it; every row must take the search
    path."""
    arrays = g.device_arrays(dev)
    buckets, _ = ops.degree_buckets(g)
    rows = []
    for D, ids, u_start, u_len, v_start, v_len in buckets:
        up = [torch.tensor(x, device=dev)
              for x in (u_start, u_len, v_start, v_len)]
        ra, _, rb, _ = ops.bucket_rows(arrays["N"], arrays["Eid"], *up, D)
        del up
        block_rows = ops.BLOCK_ROWS
        E = int(ids.size)
        paths = k3_compare(kint, ra, rb, block_rows, dev)
        if paths != {"search": E, "all_pairs": 0}:
            raise AssertionError(f"K3 bucket D = {D}: rows by path {paths}, "
                                 f"expected all {E} searched")
        ms = cuda_ms(lambda: kint.intersect_blocked(
            ra, rb, block_rows=block_rows), 5)
        plain_ms = cuda_ms(lambda: kint.intersect_ref(ra, rb), 1)
        # a and b read once, count, hit_a and hit_b written once; per row
        # the fewer of merge (DA + DB) and search (DA x ceil(log2(DB + 1)))
        # compares, and all-pairs (DA x DB) compares beside them
        nbytes = 4 * E * 2 * D + 4 * E + 4 * E * 2 * D
        ops_n = E * min(2 * D, D * int(np.ceil(np.log2(D + 1))))
        ops_all_pairs = E * D * D
        b_ms, b_by = bound_ms(nbytes, ops_n)
        rows.append(dict(D=D, E=E, block_rows=block_rows, max_abs_err=0,
                         rows_by_path=paths, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=ops_n,
                         bound_ms_all_pairs=bound_ms(nbytes,
                                                     ops_all_pairs)[0],
                         ops_all_pairs=ops_all_pairs))
        del ra, rb
        torch.cuda.empty_cache()
    return rows


def profile_run(fn, named=None, sequence=None) -> dict:
    """Run ``fn()`` once under ``torch.profiler``; device time by kernel.

    The kernels run on one stream, so their durations do not overlap and
    their sum is the device's busy time; the rest of the wall time (which
    here includes the profiler's own host overhead) the device sat idle.
    ``named`` maps a label to a substring of kernel names: the result's
    ``named`` sums the device time and calls of the matching kernels.
    ``sequence`` (a substring) also returns the matching launches' device
    milliseconds in launch order, under ``sequence_ms`` (not emitted).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ev.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    sums = {label: dict(
        ms=sum(t for k, (t, _) in by_name.items() if sub in k) / 1e3,
        calls=sum(c for k, (_, c) in by_name.items() if sub in k))
        for label, sub in (named or {}).items()}
    seq = [ev.time_range.elapsed_us() / 1e3 for ev in
           sorted((ev for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and sequence
                   and sequence in ev.name),
                  key=lambda ev: ev.time_range.start)]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                named=sums, sequence_ms=seq,
                device_idle_share=(1 - busy_us / wall_us) if busy_us else None,
                device_time_visible=busy_us > 0,
                top_kernels=[dict(name=name[:120], ms=t / 1e3, calls=c)
                             for name, (t, c) in top])


# ---- incremental maintenance and the community index (slice 5) --------------

#: churn batches on the main-path graph, as ``benchmarks/inc_bench.py``'s
#: "churn" shape: (fraction of m swapped each way, batches)
CHURN_PLAN = ((0.001, 4), (0.01, 2))

#: graphs of the sequential-oracle check (4 batches at 1 % churn each)
ORACLE_GRAPHS = ("rmat-small", "ba-small")


def kernel_counts(mods) -> dict:
    """Every kernel's launches and plain-version calls so far."""
    return dict(support=mods["ksupport"].COUNTS.as_dict(),
                peel=mods["kpeel"].COUNTS.as_dict(),
                update=mods["kpeel"].UPDATE_COUNTS.as_dict(),
                dense=mods["kpeel"].DENSE_COUNTS.as_dict(),
                loop=mods["kpeel"].LOOP_COUNTS.as_dict(),
                intersect=mods["kint"].COUNTS.as_dict())


def reset_counts(mods) -> None:
    """Set every kernel's counts to 0."""
    for c in (mods["ksupport"].COUNTS, mods["kpeel"].COUNTS,
              mods["kpeel"].UPDATE_COUNTS, mods["kpeel"].DENSE_COUNTS,
              mods["kpeel"].LOOP_COUNTS, mods["kint"].COUNTS):
        c.reset()


@contextlib.contextmanager
def host_peel_loop(kpeel):
    """Inside the block the kernel executor peels with ``host_loop``, the
    host loop over the three standalone kernels, instead of the fused
    launch: the loop before it, for parity and for timing."""
    fused = kpeel.peel_loop
    kpeel.peel_loop = kpeel.host_loop
    try:
        yield
    finally:
        kpeel.peel_loop = fused


def loop_pair(kpeel, state, m, pinned=None, stop_live=0) -> dict:
    """The fused loop and the host loop from one state (``S_ext,
    processed, csr, N, Eid``), bitwise on the state, levels and
    sub-levels; CUDA-event milliseconds of each."""
    S_ext, processed, csr, N, Eid = state
    out = {}
    for name, loop in (("host", kpeel.host_loop), ("fused", kpeel.peel_loop)):
        S, P = S_ext.clone(), processed.clone()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        res = loop(S, P, csr.u, csr.v, csr.Es, N, Eid, pinned, m=m,
                   work_cap=csr.work_cap, stop_live=stop_live)
        t1.record()
        torch.cuda.synchronize()
        out[name] = (S, P, res, t0.elapsed_time(t1))
    (hS, hP, hr, h_ms), (fS, fP, fr, f_ms) = out["host"], out["fused"]
    if not (torch.equal(hS, fS) and torch.equal(hP, fP)
            and (hr.levels, hr.sublevels) == (fr.levels, fr.sublevels)):
        raise AssertionError(f"fused loop differs from the host loop "
                             f"(pinned {pinned is not None}, stop_live "
                             f"{stop_live}): {fr} vs {hr}")
    return dict(pinned=pinned is not None, stop_live=stop_live,
                levels=fr.levels, sublevels=fr.sublevels,
                live_after=int((~fP).sum()), host_ms=h_ms, fused_ms=f_ms,
                fused_host_reads=fr.host_reads, bitwise_equal=True)


def check_loop(g, dev, mods, st) -> dict:
    """The fused loop against the host loop from the middle level ``st``
    (with and without its pinned edges, to the end and to the compaction
    point), and a pinned region peel through ``peel_live_subset`` with the
    fused loop and with the host loop."""
    pkt_mod, kp = mods["pkt"], mods["kpeel"]
    m = st["m"]
    state = (st["S_ext"], st["processed"], st["csr"], st["N"], st["Eid"])
    target = int(pkt_mod._COMPACT_FRAC * m)
    cases = [loop_pair(kp, state, m, pin, stop)
             for pin in (None, st["pinned"]) for stop in (0, target)]
    rng = np.random.default_rng(SEED + 1)
    S0 = st["S_ext"][:m].cpu().numpy()
    live = np.sort(rng.choice(m, size=m // 4, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    t0 = time.perf_counter()
    got = pkt_mod.peel_live_subset(g.El, live, S0[live], pinned, device=dev)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    with host_peel_loop(kp):
        want = pkt_mod.peel_live_subset(g.El, live, S0[live], pinned,
                                        device=dev)
    t_host = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("pinned region peel: the fused loop differs "
                             "from the host loop")
    return dict(cases=cases, region=dict(
        live=int(live.size), pinned=int(pinned.sum()), fused_seconds=t_fused,
        host_seconds=t_host, bitwise_equal=True))


def sync(dev) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def pack_rows(tri: torch.Tensor) -> torch.Tensor:
    """Each (a, b, c) edge-id row, sorted within itself, as one int64 key
    (21 bits an id), the keys sorted: equal sets of triangles give equal
    tensors."""
    rows = torch.sort(tri.to(torch.int64), dim=1).values
    if rows.numel() and int(rows.max()) >= 1 << 21:
        raise AssertionError("edge ids beyond 21 bits: cannot pack rows")
    return torch.sort((rows[:, 0] << 42) | (rows[:, 1] << 21)
                      | rows[:, 2]).values


def churn_step(eng, h, batch, dev, mods, label) -> dict:
    """One update batch through the engine, held bitwise against a
    from-scratch ``truss_pkt`` of the handle's edges on the card."""
    add, rm = batch
    inc = h._inc
    peels0 = dict(inc.region_peels)
    # host-clock seconds of the update's steps, from timers wrapped around
    # the handle's own methods for this batch only
    steps: dict = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync(dev)
                steps[name] = steps.get(name, 0.0) + time.perf_counter() - t
        return run

    for name in ("_apply_deletions", "_apply_insertions", "_level_regions",
                 "_region_peel", "_full_rebuild"):
        setattr(inc, name, timed(name.strip("_"), getattr(inc, name)))
    reset_counts(mods)
    sync(dev)
    t0 = time.perf_counter()
    try:
        st = eng.update(h, add_edges=add, remove_edges=rm)
    finally:
        for name in ("_apply_deletions", "_apply_insertions",
                     "_level_regions", "_region_peel", "_full_rebuild"):
            delattr(inc, name)
    sync(dev)
    t_upd = time.perf_counter() - t0
    counts = kernel_counts(mods)
    t0 = time.perf_counter()
    ref = mods["pkt"].truss_pkt(h.edges, device=dev)
    t_scratch = time.perf_counter() - t0
    if not np.array_equal(h.trussness, ref):
        raise AssertionError(f"{label}: handle trussness differs from a "
                             f"from-scratch truss_pkt")
    if any(c["plain"] for c in counts.values()):
        raise AssertionError(f"{label}: a plain version ran: {counts}")
    return dict(batch=label, mode=st.mode, insert_mode=st.insert_mode,
                m=st.m_after, inserted=st.inserted, deleted=st.deleted,
                affected=st.affected, boundary=st.boundary,
                rounds=st.rounds, changed=st.changed, seconds=st.seconds,
                wall_seconds=t_upd,
                region_peels={k: inc.region_peels[k] - peels0[k]
                              for k in peels0},
                step_seconds=steps,
                launches={k: v["kernel"] for k, v in counts.items()},
                # a full fallback's rebuild, by phase (the rest of the
                # update's seconds is the local attempt before it)
                rebuild_phases=(dict(inc.open_phases) if st.mode == "full"
                                else None),
                from_scratch_seconds=t_scratch, bitwise_equal=True)


def check_incremental(edges, dev, mods, TrussEngine, cli,
                      enumerate_triangles) -> tuple:
    """Phase ``incremental``: open the main-path graph as a handle, check
    it, then churn it (``CHURN_PLAN``), every batch held against a
    from-scratch ``truss_pkt``.  Returns ``(engine, handle, summary,
    batches)``."""
    pkt_mod = mods["pkt"]
    eng = TrussEngine(device=dev)
    reset_counts(mods)
    sync(dev)
    t0 = time.perf_counter()
    h = eng.open(edges)
    sync(dev)
    t_open = time.perf_counter() - t0
    open_counts = kernel_counts(mods)
    if (open_counts["support"]["kernel"] < 1
            or open_counts["loop"]["kernel"] < 1
            or any(c["plain"] for c in open_counts.values())):
        raise AssertionError(f"open did not run K1 and the peel loop on "
                             f"the card: {open_counts}")
    inc = h._inc
    t0 = time.perf_counter()
    ref = pkt_mod.truss_pkt(h.edges, device=dev)
    t_scratch = time.perf_counter() - t0
    if not np.array_equal(h.trussness, ref):
        raise AssertionError("open: trussness differs from truss_pkt")
    # the maintained list against the port's device enumeration (as sets),
    # its order (by lowest member id) and the support K1 computed
    tri = inc.tri          # the handle keeps it on the device
    enum = torch.from_numpy(enumerate_triangles(inc.g, device=dev)).to(dev)
    if not torch.equal(pack_rows(tri), pack_rows(enum)):
        raise AssertionError("open: triangle list differs from the device "
                             "enumeration")
    if tri.shape[0] and not (bool((tri[:, 0] < tri[:, 1]).all())
                             and bool((tri[:, 1] < tri[:, 2]).all())
                             and bool((tri[1:, 0] >= tri[:-1, 0]).all())):
        raise AssertionError("open: triangle rows out of order")
    per_edge = torch.bincount(tri.reshape(-1), minlength=inc.m)
    if not np.array_equal(per_edge.cpu().numpy(), inc.S.astype(np.int64)):
        raise AssertionError("open: triangle list disagrees with support")
    del tri, enum, per_edge
    summary = dict(m=h.m, n=h.n, open_seconds=t_open,
                   open_phases=inc.open_phases,
                   triangles=int(inc.tri.shape[0]),
                   max_trussness=int(h.trussness.max()),
                   launches_per_open={k: v["kernel"]
                                      for k, v in open_counts.items()},
                   from_scratch_seconds=t_scratch)

    rng = np.random.default_rng(SEED)
    n_vert = int(edges.max()) + 1
    batches = []
    for frac, count in CHURN_PLAN:
        for i in range(count):
            t0 = time.perf_counter()
            batch = cli.churn_batch(h.edges, n_vert, frac, rng)
            t_gen = time.perf_counter() - t0
            row = churn_step(eng, h, batch, dev, mods, f"{frac}#{i}")
            row.update(churn=frac, generate_seconds=t_gen)
            emit("incremental_batch", **row)
            batches.append(row)
    forced = not any(b["region_peels"]["device"] for b in batches)
    if forced:
        # no batch re-peeled a region on the device: one more 0.1 % batch
        # with every region sent to the device rung (host_peel_max = 0)
        # and no fallback (local_frac = 1), since on this graph a batch's
        # insertion region passes 25 % of m and the update recomputes
        limits = (inc.host_peel_max, inc.local_frac)
        inc.host_peel_max, inc.local_frac = 0, 1.0
        batch = cli.churn_batch(h.edges, n_vert, CHURN_PLAN[0][0], rng)
        row = churn_step(eng, h, batch, dev, mods, "forced-device")
        row.update(churn=CHURN_PLAN[0][0], host_peel_max=0, local_frac=1.0)
        inc.host_peel_max, inc.local_frac = limits
        emit("incremental_batch", **row)
        batches.append(row)
    pinned_k2 = [b for b in batches if b["mode"] == "local"
                 and b["region_peels"]["device"] and b["boundary"]
                 and b["launches"]["loop"]]
    if not pinned_k2:
        raise AssertionError("no batch ran the peel loop over a pinned "
                             "region on the card")
    # the host probe of a 1 % batch's new triangles (``triangles_through``
    # over the inserted edges' ids in the new graph), timed alone: the 1 %
    # batches above fall back before their insertion phase reaches it
    from repro_torch.core.truss_inc import triangles_through
    from repro_torch.graphs.csr import build_csr, edge_keys

    add, _ = cli.churn_batch(h.edges, n_vert, CHURN_PLAN[-1][0], rng)
    g_new = build_csr(np.concatenate([h.edges, add]), h.n)
    anchors = np.searchsorted(
        edge_keys(g_new.El[:, 0], g_new.El[:, 1], h.n),
        np.sort(edge_keys(add.min(axis=1), add.max(axis=1), h.n)))
    t0 = time.perf_counter()
    found = triangles_through(g_new, anchors)[0].size
    summary.update(triangles_through=dict(
        anchors=int(anchors.size), rows=int(found),
        seconds=time.perf_counter() - t0))
    summary.update(batches=len(batches), forced_device_batch=forced,
                   batches_with_pinned_k2=[b["batch"] for b in pinned_k2],
                   updates_local=eng.stats["updates_local"],
                   updates_full=eng.stats["updates_full"])
    return eng, h, summary, batches


def check_sequential_oracle(eng, dev, mods, datasets, cli) -> dict:
    """Batched ≡ sequential ≡ from scratch, bitwise, on the small graphs."""
    out = {}
    for name in ORACLE_GRAPHS:
        E = datasets.named_graph(name)
        n_vert = int(E.max()) + 1
        bat = eng.open(E)
        seq = eng.open(E, insert_mode="sequential")
        rng = np.random.default_rng(SEED)
        rows = []
        for i in range(4):
            add, rm = cli.churn_batch(bat.edges, n_vert, 0.01, rng)
            s1 = eng.update(bat, add_edges=add, remove_edges=rm)
            s2 = eng.update(seq, add_edges=add, remove_edges=rm)
            ref = mods["pkt"].truss_pkt(bat.edges, device=dev)
            tri_b, tri_s = bat._inc.tri, seq._inc.tri
            if not (np.array_equal(bat.edges, seq.edges)
                    and np.array_equal(bat.trussness, seq.trussness)
                    and np.array_equal(bat.trussness, ref)
                    and np.array_equal(bat._inc.S, seq._inc.S)
                    and torch.equal(pack_rows(tri_b), pack_rows(tri_s))):
                raise AssertionError(f"{name} batch {i}: batched, "
                                     f"sequential and from scratch differ")
            rows.append(dict(batched=s1.mode, sequential=s2.mode,
                             affected=[s1.affected, s2.affected],
                             seconds=[s1.seconds, s2.seconds]))
        eng.close(bat)
        eng.close(seq)
        out[name] = rows
    return out


def check_corrupt_fault(eng, dev, mods, datasets, cli, chaos,
                        IntegrityError) -> dict:
    """A seeded "corrupt" fault at the region site raises IntegrityError
    and leaves the handle's committed state as it was."""
    E = datasets.named_graph(ORACLE_GRAPHS[1])
    h = eng.open(E, local_frac=1.0)
    inc = h._inc
    snap = (inc.edges, inc.trussness, inc.support, inc.triangles)
    batch = cli.churn_batch(h.edges, int(E.max()) + 1, 0.01,
                            np.random.default_rng(SEED))
    plan = chaos.FaultPlan(seed=SEED).add("region", mode="corrupt", times=1)
    raised = False
    with plan:
        try:
            eng.update(h, add_edges=batch[0], remove_edges=batch[1])
        except IntegrityError:
            raised = True
    if not raised or plan.stats()["injected"].get("region") != 1:
        raise AssertionError(f"corrupt fault did not raise IntegrityError: "
                             f"{plan.stats()}")
    now = (inc.edges, inc.trussness, inc.support, inc.triangles)
    if not all(np.array_equal(a, b) for a, b in zip(snap, now)):
        raise AssertionError("corrupt fault changed the committed state")
    st = eng.update(h, add_edges=batch[0], remove_edges=batch[1])
    if not np.array_equal(h.trussness,
                          mods["pkt"].truss_pkt(h.edges, device=dev)):
        raise AssertionError("the batch after the fault is wrong")
    eng.close(h)
    return dict(graph=ORACLE_GRAPHS[1], raised=True,
                committed_state_unchanged=True, retry_mode=st.mode)


def scipy_labels(T: np.ndarray, tri: np.ndarray, k: int) -> np.ndarray:
    """Level-``k`` labels by scipy: edges are nodes, each triangle whose
    level is at least k links (a, b) and (a, c); each component maps to
    its minimum edge id, edges below k to -1."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    m = T.shape[0]
    act = tri[T[tri].min(axis=1) >= k]
    src = np.concatenate([act[:, 0], act[:, 0]])
    dst = np.concatenate([act[:, 1], act[:, 2]])
    adj = coo_matrix((np.ones(src.shape[0], np.int8), (src, dst)),
                     shape=(m, m)).tocsr()
    n_comp, comp = connected_components(adj, directed=False)
    low = np.full(n_comp, m, np.int64)
    np.minimum.at(low, comp, np.arange(m, dtype=np.int64))
    labels = low[comp]
    labels[T < k] = -1
    return labels


def check_hierarchy(h, dev, eng, datasets, cli) -> dict:
    """Phase ``hierarchy``: the main-path handle's index in device mode,
    three levels against scipy, the invariants at every level on the
    device; then device ≡ host on ``rmat-small`` before and after a batch
    that remaps the upper levels."""
    inc = h._inc
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hier = h.hierarchy().build_all()
    sync(dev)
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    levels = list(hier.levels)
    checked = sorted({3, levels[len(levels) // 2], hier.k_max}
                     & set(levels))
    t0 = time.perf_counter()
    tri_host = inc.triangles
    for k in checked:
        if not np.array_equal(hier.level_labels(k),
                              scipy_labels(inc.T, tri_host, k)):
            raise AssertionError(f"hierarchy level {k} differs from scipy")
    t_scipy = time.perf_counter() - t0
    # invariants at every level, on the device
    t0 = time.perf_counter()
    T = torch.from_numpy(inc.T).to(dev)
    tri = inc.tri
    lvl = T[tri].amin(dim=1)
    order = torch.sort(-lvl, stable=True).indices
    tri, lvl = tri[order], lvl[order]
    ids = torch.arange(inc.m, device=dev)
    for k in levels:
        L = torch.from_numpy(hier.level_labels(k)).to(dev)
        live = T >= k
        act = tri[: int((lvl >= k).sum())]
        Ll = L[live]
        ok = (bool((L[~live] == -1).all()) and bool((Ll >= 0).all())
              and bool((L[Ll] == Ll).all())
              and bool((Ll <= ids[live]).all()))
        if act.shape[0]:
            La = L[act]
            ok = ok and bool((La.amin(dim=1) == La.amax(dim=1)).all())
        if not ok:
            raise AssertionError(f"hierarchy level {k}: invariants fail")
    t_inv = time.perf_counter() - t0
    del T, tri, lvl, order, ids
    summary = dict(levels=len(levels), k_max=hier.k_max,
                   build_seconds=t_build, stats=hier.stats,
                   flood_rounds=hier.flood_rounds,
                   max_memory_allocated=peak, scipy_levels=checked,
                   scipy_seconds=t_scipy, invariant_seconds=t_inv)

    # rmat-small: device ≡ host, before and after a remapping batch
    E = datasets.named_graph("rmat-small")
    hs = eng.open(E, local_frac=1.0)
    small = {}
    for when in ("before", "after"):
        if when == "after":
            # a 1 % batch that removes only edges of trussness <= 3, so the
            # repair leaves the upper levels to the remap
            rng = np.random.default_rng(SEED)
            low = np.nonzero(hs.trussness <= 3)[0]
            k = int(round(0.01 * hs.m))
            rm = hs.edges[rng.choice(low, size=k, replace=False)]
            add, _ = cli.churn_batch(hs.edges, int(E.max()) + 1, 0.01, rng)
            st = eng.update(hs, add_edges=add, remove_edges=rm)
            if st.mode != "local":
                raise AssertionError("rmat-small remap batch went full")
        dev_h = hs.hierarchy().build_all()
        host_h = hs.hierarchy(mode="host").build_all()
        for k in dev_h.levels:
            if not np.array_equal(dev_h.level_labels(k),
                                  host_h.level_labels(k)):
                raise AssertionError(f"rmat-small {when}: device and host "
                                     f"labels differ at level {k}")
        small[when] = dict(stats=dict(dev_h.stats),
                           flood_rounds=dev_h.flood_rounds,
                           levels=len(dev_h.levels))
    if not small["after"]["stats"]["remapped_levels"]:
        raise AssertionError("rmat-small batch remapped no level")
    eng.close(hs)
    summary["rmat_small_device_equals_host"] = small
    return summary


# ---- the async scheduler, its ladders and distributed PKT (slice 6) ---------

#: requests of the serve phase's replay (the CLI's ``--serve`` schedule) and
#: their offered rate
SERVE_REQUESTS = 100
SERVE_QPS = 100.0


def engine_fleet(gen) -> list:
    """The engine phase's seeded mix of ``ENGINE_GRAPHS`` small graphs."""
    rng = np.random.default_rng(SEED)
    kinds = ("rmat", "ba", "er", "cliques")
    return [gen.random_graph_edges(str(k), "small", seed=int(s))
            for k, s in zip(rng.choice(kinds, ENGINE_GRAPHS),
                            rng.integers(0, 1 << 16, ENGINE_GRAPHS))]


def check_serve(edges, fleet, dev, mods, cli, TrussEngine,
                TrussScheduler) -> dict:
    """Phase ``serve``: the main-path graph opened through ``open_async``,
    the CLI's ``--serve`` schedule replayed against it, then the engine
    phase's mix through ``submit_async`` — K1 and K2 launches counted from
    0 over the whole phase; every result held bitwise against a synchronous
    replay on a second handle and against the synchronous engine."""
    _, ops = cli.serve_schedule(edges, SERVE_REQUESTS, SEED)
    n_req = len(ops) + len(fleet) + 1
    reset_counts(mods)
    sync(dev)
    t_phase = time.perf_counter()
    # the kernels were built before (phase build), so no nvcc runs on the
    # scheduler thread under the watchdog
    sched = TrussScheduler(max_batch=16, max_delay_ms=2.0,
                           max_queue=max(256, 4 * n_req),
                           max_inflight=max(64, 4 * n_req),
                           watchdog_s=600.0, device=dev)
    try:
        t0 = time.perf_counter()
        h = sched.open_async(edges).result()
        t_open = time.perf_counter() - t0
        outcomes, lat, duration = cli.replay(sched, h, ops, SERVE_QPS)
        t0 = time.perf_counter()
        futs = [sched.submit_async(e) for e in fleet]
        subs = [f.result() for f in futs]
        t_subs = time.perf_counter() - t0
        st = sched.stats()
    finally:
        sched.close()
    sync(dev)
    t_phase = time.perf_counter() - t_phase
    counts = kernel_counts(mods)
    failed = [type(v).__name__ for status, v in outcomes if status != "ok"]
    if failed:
        raise AssertionError(f"serve: {len(failed)} requests failed: "
                             f"{failed[:5]}")
    if (counts["support"]["kernel"] < 1 or counts["loop"]["kernel"] < 1
            or any(c["plain"] for c in counts.values())):
        raise AssertionError(f"serve did not run K1 and the peel loop on "
                             f"the card: {counts}")
    # a retried or demoted dispatch may have run on the torch or host rungs,
    # which count no plain call: only a run that never left the kernels'
    # rungs reports launches
    off_rung = {site: lad for site, lad in st["resilience"].items()
                if lad["failures"] or lad["demotions"]
                or lad["rung"] != lad["rungs"][0]}
    if st["counters"]["retries"] or st["counters"]["errors"] or off_rung:
        raise AssertionError(f"serve left the kernel rungs: counters "
                             f"{st['counters']}, ladders {off_rung}")
    t0 = time.perf_counter()
    if not cli.sync_replay(TrussEngine(device=dev), edges, ops, outcomes, h,
                           local_frac=0.25):
        raise AssertionError("serve: async results differ from the sync "
                             "replay on a second handle")
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = TrussEngine(max_pending=len(fleet) + 1, device=dev).map(fleet)
    t_sync_engine = time.perf_counter() - t0
    for i, (got, w) in enumerate(zip(subs, want)):
        if not np.array_equal(got, w):
            raise AssertionError(f"serve: submission {i} differs from the "
                                 f"sync engine")
    # each repair once (coalesced requests share one UpdateStats)
    repairs = {id(v): v for (kind, *_), (_, v) in zip(ops, outcomes)
               if kind == "update"}
    updates = [dict(mode=v.mode, coalesced=v.coalesced,
                    inserted=v.inserted, deleted=v.deleted,
                    affected=v.affected, boundary=v.boundary,
                    seconds=v.seconds) for v in repairs.values()]
    mix = {k: sum(op[0] == k for op in ops) for k in ("query", "update",
                                                      "open")}
    return dict(graph="main path", m=h.m, requests=len(ops), mix=mix,
                qps_offered=SERVE_QPS, qps_achieved=len(ops) / duration,
                replay_seconds=duration, open_seconds=t_open,
                latency=cli.latency_summary(lat), submissions=len(fleet),
                submit_seconds=t_subs,
                dispatches=st["counters"]["dispatches"],
                coalesced_updates=st["counters"]["coalesced_updates"],
                counters=st["counters"], stages=st["stages"],
                resilience={k: v["rung"] for k, v in
                            st["resilience"].items()},
                updates=updates,
                launches={k: v["kernel"] for k, v in counts.items()},
                sync_replay_seconds=t_replay,
                sync_engine_seconds=t_sync_engine, phase_seconds=t_phase,
                bitwise_equal_to_sync_replay=True,
                bitwise_equal_to_sync_engine=True)


def check_chaos(dev, mods, datasets, cli, TrussEngine, TrussScheduler,
                RetryPolicy, chaos) -> dict:
    """Phase ``chaos``: the flush ladder's demotion and re-promotion under
    forced kernel-rung failures, one injected fault per dispatch site
    retried to parity, and the CLI's faulted ``--serve`` replay."""
    pkt_mod = mods["pkt"]
    E = datasets.named_graph("rmat-small")
    want = pkt_mod.truss_pkt(E, device=dev)
    fast = RetryPolicy(max_retries=2, base_delay_s=0.001, max_delay_s=0.002)
    out = {}

    # forced failures on the kernel rung: demote, probe, re-promote; the
    # requests run one at a time, so each one's launches are its own
    plan = chaos.FaultPlan(seed=SEED).add("flush", rung="kernel", times=2)
    per_request = []
    with plan, TrussScheduler(max_batch=1, max_delay_ms=0.0, retry=fast,
                              ladder={"demote_after": 2, "probe_after": 1,
                                      "promote_after": 1},
                              device=dev) as sched:
        for _ in range(3):
            reset_counts(mods)
            got = sched.submit_async(E).result()
            sync(dev)
            c = kernel_counts(mods)
            per_request.append(dict(
                rung_after=sched.stats()["resilience"]["flush"]["rung"],
                k1=c["support"]["kernel"], loop=c["loop"]["kernel"],
                plain=sum(v["plain"] for v in c.values()),
                bitwise_equal=bool(np.array_equal(got, want))))
        flush = sched.stats()["resilience"]["flush"]
    ladder_ok = (flush["rungs"] == ["kernel+kernel", "chunked+torch", "host"]
                 and (flush["failures"], flush["demotions"], flush["probes"],
                      flush["promotions"]) == (2, 1, 1, 1)
                 and flush["rung"] == "kernel+kernel")
    k2_ok = (per_request[0]["loop"] == 0 and per_request[1]["loop"] > 0
             and per_request[2]["loop"] > 0
             and not any(r["plain"] for r in per_request))
    if not (ladder_ok and k2_ok
            and all(r["bitwise_equal"] for r in per_request)
            and plan.stats()["injected"].get("flush") == 2):
        raise AssertionError(f"flush ladder: {flush} {per_request} "
                             f"{plan.stats()}")
    out["flush_ladder"] = dict(ladder=flush, requests=per_request)

    # one injected fault per site, retried to parity
    rng = np.random.default_rng(SEED)
    sync_eng = TrussEngine(device=dev)
    sites = {}
    with TrussScheduler(max_batch=4, max_delay_ms=1.0, retry=fast,
                        device=dev) as sched:
        h = sched.open_async(E, local_frac=1.0).result()
        E2 = datasets.named_graph("ba-small")
        add, rm = cli.churn_batch(h.edges, int(E.max()) + 1, 0.01, rng)
        for site, call, check in (
                ("flush", lambda: sched.submit_async(E),
                 lambda r: np.array_equal(r, want)),
                ("region", lambda: sched.update_async(
                    h, add_edges=add, remove_edges=rm),
                 lambda r: r.mode == "local" and np.array_equal(
                     h.trussness, pkt_mod.truss_pkt(h.edges, device=dev))),
                ("support", lambda: sched.open_async(E2),
                 lambda r: np.array_equal(
                     r.trussness, pkt_mod.truss_pkt(r.edges, device=dev))),
                # the top level of the updated handle: built on demand
                ("hierarchy", lambda: sched.communities_async(
                    h, int(h.trussness.max())),
                 lambda r: (lambda w: len(r) == len(w) and all(
                     np.array_equal(a, b) for a, b in zip(r, w)))(
                     sync_eng.open(h.edges).communities(
                         int(h.trussness.max()))))):
            before = sched.stats()
            fp = chaos.FaultPlan(seed=SEED).add(site, times=1)
            with fp:
                result = call().result()
            after = sched.stats()
            row = dict(
                injected=fp.stats()["injected"].get(site, 0),
                retries=(after["counters"]["retries"]
                         - before["counters"]["retries"]),
                failures=(after["resilience"][site]["failures"]
                          - before["resilience"][site]["failures"]),
                bitwise_equal=bool(check(result)))
            if row != dict(injected=1, retries=1, failures=1,
                           bitwise_equal=True):
                raise AssertionError(f"chaos site {site}: {row}")
            sites[site] = row
    out["one_fault_per_site"] = sites

    # the CLI's faulted replay; it prints its own lines and exits non-zero
    # on a mismatch
    import contextlib
    import io

    args = ["--graph", "rmat-small", "--serve", "200", "--qps", "200",
            "--fault-rate", "0.1", "--deadline-ms", "250", "--verify",
            "--device", dev.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if "verify async vs sync engine (failed ops masked): OK" not in text:
        raise AssertionError("cli --serve under faults: no verify OK")
    out["cli"] = dict(args=args, seconds=time.perf_counter() - t0,
                      lines=[ln for ln in text.splitlines()
                             if ln.startswith(("chaos:", "  retries",
                                               "achieved", "verify"))])
    return out


def check_dist(g, dev, mods, pkt_dist_mod) -> dict:
    """Phase ``dist``: ``pkt_dist`` at scale 17 in a one-rank ``nccl``
    group, bitwise equal to ``pkt`` with the torch executors, its K1
    launches counted from 0; then K1 over two edge ranges, summed, against
    K1 over ``[0, m)``, and each range against K1's plain version over the
    same range."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    pkt_mod, ks, sup, wc = (mods["pkt"], mods["ksupport"], mods["support"],
                            mods["wc"])
    rdv = tempfile.mkdtemp(prefix=".rendezvous-", dir=ROOT)
    out = {}
    try:
        torch.cuda.set_device(0 if dev.index is None else dev.index)
        tdist.init_process_group(
            "nccl", init_method=pathlib.Path(rdv, "group").as_uri(),
            rank=0, world_size=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mods)
        t0 = time.perf_counter()
        T = pkt_dist_mod.pkt_dist(g, device=dev)
        t_dist = time.perf_counter() - t0
        counts = kernel_counts(mods)
        peak_dist = torch.cuda.max_memory_allocated()
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    if counts["support"] != {"kernel": 1, "plain": 0} or any(
            c["plain"] for c in counts.values()):
        raise AssertionError(f"pkt_dist did not launch K1 once: {counts}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = pkt_mod.pkt(g, mode="chunked", support_mode="torch", device=dev)
    t_torch = time.perf_counter() - t0
    peak_torch = torch.cuda.max_memory_allocated()
    if not np.array_equal(T, ref.trussness.astype(np.int64)):
        raise AssertionError("pkt_dist differs from pkt with the torch "
                             "executors")
    del ref
    torch.cuda.empty_cache()
    out.update(m=g.m, ranks=1, backend="nccl", pkt_dist_seconds=t_dist,
               max_memory_allocated=peak_dist,
               torch_executor_seconds=t_torch,
               torch_executor_max_memory_allocated=peak_torch,
               peel_table_rows=sup.peel_table_size(g),
               launches={k: v["kernel"] for k, v in counts.items()},
               bitwise_equal_to_torch_executors=True)

    # K1's edge ranges: two halves of the rows, summed, against [0, m)
    size = sup.support_table_size(g)
    size_pad = wc.next_pow2(size)
    chunk = wc.pow2_chunk(size_pad, None, size=size)
    arrays = g.device_arrays(dev)
    args = tuple(arrays[k] for k in ("u", "v", "Es", "Eo", "N", "Eid"))
    kw = dict(m=g.m, chunk=chunk, n_chunks=size_pad // chunk)
    bounds = pkt_dist_mod.edge_ranges(g, 2)
    S_all, tri_all = ks.support_accumulate(*args, **kw)
    halves = [ks.support_accumulate(*args, **kw, e_begin=int(a),
                                    e_end=int(b))
              for a, b in zip(bounds[:-1], bounds[1:])]
    err = max(max_abs_err(halves[0][0] + halves[1][0], S_all),
              max_abs_err(halves[0][1] + halves[1][1], tri_all))
    if err != 0:
        raise AssertionError(f"K1's edge ranges do not sum to [0, m): {err}")
    # each range on its own against the plain version over the same range
    plain_err = []
    for (a, b), (S_h, tri_h) in zip(zip(bounds[:-1], bounds[1:]), halves):
        S_p, tri_p = ks.support_accumulate_ref(*args, **kw, e_begin=int(a),
                                               e_end=int(b))
        plain_err.append(max(max_abs_err(S_h, S_p),
                             max_abs_err(tri_h, tri_p)))
    if any(plain_err):
        raise AssertionError(f"K1 over an edge range differs from its plain "
                             f"version over that range: {plain_err}")
    ms = [cuda_ms(lambda a=a, b=b: ks.support_accumulate(
        *args, **kw, e_begin=int(a), e_end=int(b)), 5)
        for a, b in zip(bounds[:-1], bounds[1:])]
    v = g.El[:, 1].astype(np.int64)
    off = np.concatenate([[0], np.cumsum(g.Es.astype(np.int64)[v + 1]
                                         - g.Eo.astype(np.int64)[v])])
    out["k1_edge_ranges"] = dict(
        bounds=[int(b) for b in bounds],
        rows=[int(r) for r in np.diff(off[bounds])],
        ms=ms, whole_ms=cuda_ms(lambda: ks.support_accumulate(*args, **kw),
                                5),
        max_abs_err=err, max_abs_err_vs_plain_per_range=plain_err)
    return out


def main() -> int:
    """Run every phase; return the process exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # ``repro_torch.core`` re-exports the ``pkt`` function, which shadows
    # the module of the same name: import the modules by name
    pkt_mod = importlib.import_module("repro_torch.core.pkt")
    sup = importlib.import_module("repro_torch.core.support")
    from repro_torch.core.kcore import kcore_numpy, kcore_park
    from repro_torch.core.ref import truss_numpy
    from repro_torch.core.ros import truss_ros
    from repro_torch.core.triangle_list import (enumerate_triangles,
                                                truss_trilist)
    from repro_torch.core.wc import truss_wc
    from repro_torch.graphs import datasets, gen
    from repro_torch.graphs.csr import build_csr
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import intersect as kint
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import peel as kpeel
    from repro_torch.kernels import support as ksupport
    from repro_torch.kernels import wedge_common as wc
    from repro_torch.launch import truss as cli
    from repro_torch.core.truss_inc import IntegrityError
    from repro_torch.serve import RetryPolicy, TrussScheduler
    from repro_torch.serve.truss_engine import TrussEngine
    from repro_torch.testing import chaos

    mods = dict(pkt=pkt_mod, support=sup, kpeel=kpeel, ksupport=ksupport,
                kint=kint, wc=wc, trilist=importlib.import_module(
                    "repro_torch.core.triangle_list"))
    dev = torch.device(DEVICE)
    t_all = time.perf_counter()

    # ---- 1. environment ----------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    kind = torch.cuda.get_device_name(0)
    emit("environment", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count(),
         python=sys.version.split()[0], seconds=time.perf_counter() - t0)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.library(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", sources=list(cuda_build.SOURCES), ptxas=ptxas,
         seconds=time.perf_counter() - t0)

    # ---- host preprocessing of the main-path graph -------------------------
    t0 = time.perf_counter()
    edges = gen.rmat_edges(SCALE, edge_factor=EDGE_FACTOR, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g, n, row_keys = pkt_mod.preprocess(edges)
    t_prep = time.perf_counter() - t0
    emit("graph", generator="Graph500 R-MAT (A,B,C = 0.57,0.19,0.19)",
         scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED, n=n, m=g.m,
         max_degree=int(g.degrees.max()), max_dplus=int(g.dplus.max()),
         support_table_rows=sup.support_table_size(g),
         peel_table_rows=sup.peel_table_size(g), generate_seconds=t_gen,
         preprocess_seconds=t_prep)

    # ---- 3. kernel check ---------------------------------------------------
    t0 = time.perf_counter()
    k1 = check_k1(g, dev, mods)
    S0 = k1.pop("S0")
    emit("kernel_check_k1", **k1)
    k2_cases, loop_check = check_k2(g, dev, S0, mods)
    for case in k2_cases:
        emit("kernel_check_k2", **case)
    emit("kernel_check_loop", **loop_check)
    del S0
    torch.cuda.empty_cache()
    emit("kernel_check", seconds=time.perf_counter() - t0)

    # ---- 4. main path --------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the kernel path must not touch the chunk mask: count its calls
    mask_calls = []
    chunk_mask = pkt_mod._active_chunk_mask

    def counted_mask(*args, **kwargs):
        mask_calls.append(1)
        return chunk_mask(*args, **kwargs)

    pkt_mod._active_chunk_mask = counted_mask
    t0 = time.perf_counter()
    reset_counts(mods)
    res = pkt_mod.pkt(g, phase_timings=True, device=dev)
    truss = pkt_mod.align_to_input(res.trussness, g, None, n, keys=row_keys)
    counts = kernel_counts(mods)
    t_kernel = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pkt_mod._active_chunk_mask = chunk_mask
    if (counts["support"]["kernel"] != 1
            or counts["loop"]["kernel"] != res.compactions + 1
            or counts["peel"]["kernel"] or counts["update"]["kernel"]
            or counts["dense"]["kernel"]):
        raise AssertionError(f"main path did not launch K1 once and the "
                             f"fused peel loop once per segment, with no "
                             f"standalone K2 or update: {counts}")
    if any(c["plain"] for c in counts.values()) or mask_calls:
        raise AssertionError(f"main path ran a plain version or the chunk "
                             f"mask ({len(mask_calls)} calls): {counts}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = pkt_mod.pkt(g, mode="chunked", support_mode="torch", device=dev)
    t_torch = time.perf_counter() - t0
    for field in ("trussness", "support"):
        if not np.array_equal(getattr(res, field), getattr(ref, field)):
            raise AssertionError(f"main path: {field} differs between the "
                                 f"kernel and torch executors")
    got = (res.levels, res.sublevels, res.compactions)
    want = (ref.levels, ref.sublevels, ref.compactions)
    if got != want:
        raise AssertionError(f"main path counters differ: {got} vs {want}")
    if truss.shape != (edges.shape[0],) or (truss < 2).any():
        raise AssertionError("main path: malformed aligned trussness")
    emit("main_path", m=g.m, n=n,
         support_table_rows=k1["rows"],
         peel_table_rows=sup.peel_table_size(g),
         max_trussness=int(res.trussness.max()),
         triangles=int(res.support.sum()) // 3, levels=res.levels,
         sublevels=res.sublevels, compactions=res.compactions,
         # the fused loop reads the host once per segment (its result),
         # then the S and processed copies at its end; compactions split
         # the peel into compactions + 1 segments
         host_syncs_in_peel=3 * (res.compactions + 1),
         phases=res.phases, kernel_seconds=t_kernel,
         preprocess_seconds=t_prep,
         torch_executor_seconds=t_torch, max_memory_allocated=peak,
         launches=counts, bitwise_equal_to_torch_executors=True)
    main_counts = counts
    del ref
    torch.cuda.empty_cache()
    # the host loop over the standalone kernels (the loop the fused launch
    # replaced): the same results with its launch counts, and the peel
    # phase of both in turns
    peel_seconds = {"host": [], "fused": []}
    for name in ("host", "fused", "fused", "host"):
        reset_counts(mods)
        with (host_peel_loop(kpeel) if name == "host"
              else contextlib.nullcontext()):
            r = pkt_mod.pkt(g, phase_timings=True, device=dev)
        c = kernel_counts(mods)
        if not (np.array_equal(r.trussness, res.trussness)
                and (r.levels, r.sublevels, r.compactions)
                == (res.levels, res.sublevels, res.compactions)):
            raise AssertionError(f"main path with the {name} loop differs")
        if name == "host":
            if (c["peel"]["kernel"] != res.sublevels
                    or c["update"]["kernel"] != res.sublevels
                    or c["dense"]["kernel"] != res.levels
                    or c["loop"]["kernel"]):
                raise AssertionError(f"the host loop did not launch the "
                                     f"kernels once per sub-level / level: "
                                     f"{c}")
            counts = c
        peel_seconds[name].append(r.phases["peel"])
    host_counts = counts
    emit("main_path_loops", peel_seconds=peel_seconds,
         host_loop_launches=host_counts, fused_launches=main_counts,
         resident_grids=kpeel.resident_grids(),
         bitwise_equal_to_host_loop=True)
    # where the main path's device time goes: one more run of each loop,
    # traced (outside the counted windows above)
    main_profile = profile_run(
        lambda: pkt_mod.pkt(g, device=dev),
        named=dict(peel_loop="peel_loop_kernel",
                   support_accumulate="support_kernel"))
    main_profile.pop("sequence_ms")
    emit("main_path_profile", **main_profile)
    if main_profile["named"]["peel_loop"]["calls"] != main_counts["loop"][
            "kernel"]:
        raise AssertionError(f"the profile saw "
                             f"{main_profile['named']['peel_loop']} loop "
                             f"launches, the main path made "
                             f"{main_counts['loop']['kernel']}")
    with host_peel_loop(kpeel):
        host_profile = profile_run(
            lambda: pkt_mod.pkt(g, device=dev),
            named=dict(peel_decrement_fold="peel_kernel",
                       sparse_update="sparse_update_kernel",
                       dense_update="dense_update_kernel",
                       support_accumulate="support_kernel"),
            sequence="peel_kernel")
    k2_launch_ms = host_profile.pop("sequence_ms")
    emit("main_path_profile_host_loop", **host_profile)
    # the bound of every K2 and update launch of one host-loop
    # decomposition, from each launch's own inputs (an instrumented run: it
    # reads them back)
    t0 = time.perf_counter()
    with host_peel_loop(kpeel), K2Bounds(mods) as k2_bounds:
        res_b = pkt_mod.pkt(g, device=dev)
    if not np.array_equal(res_b.trussness, res.trussness):
        raise AssertionError("instrumented run differs from the main path")
    for key, label in (("peel", "peel_decrement_fold"),
                       ("update", "sparse_update"),
                       ("dense", "dense_update")):
        if host_profile["named"][label]["calls"] != counts[key]["kernel"]:
            raise AssertionError(f"the profile saw "
                                 f"{host_profile['named'][label]} {label} "
                                 f"launches, the host loop made "
                                 f"{counts[key]['kernel']}")
    k2_total = dict(k2_bounds.summed("fold"),
                    device_ms=host_profile["named"]["peel_decrement_fold"])
    update_total = dict(k2_bounds.summed("update"),
                        device_ms=host_profile["named"]["sparse_update"])
    dense_total = dict(k2_bounds.summed("dense"),
                       device_ms=host_profile["named"]["dense_update"])
    # K2's launches by the wedge rows of their frontier: the profile's
    # launch times beside the instrumented run's bounds (same launch order)
    folds = [c for c in k2_bounds.calls if c[0] == "fold"]
    if len(folds) != len(k2_launch_ms):
        raise AssertionError(f"{len(k2_launch_ms)} traced K2 launches, "
                             f"{len(folds)} instrumented")
    by_rows = {}
    for (_, nb, ops, rows), ms in zip(folds, k2_launch_ms):
        key = "<1e3" if rows < 1000 else f"1e{min(6, len(str(rows)) - 1)}+"
        row = by_rows.setdefault(key, dict(launches=0, rows=0, device_ms=0.0,
                                           bound_ms=0.0))
        row["launches"] += 1
        row["rows"] += rows
        row["device_ms"] += ms
        row["bound_ms"] += bound_ms(nb, ops)[0]
    emit("main_path_k2_aggregate", peel_decrement_fold=k2_total,
         sparse_update=update_total, dense_update=dense_total,
         k2_by_frontier_rows=by_rows,
         seconds=time.perf_counter() - t0)
    del res_b, k2_bounds
    torch.cuda.empty_cache()

    # ---- 5. small-graph oracle -----------------------------------------------
    t0 = time.perf_counter()
    small = {}
    for name in ("fig1", "karate_like", "cliques-tiny", "rmat-tiny",
                 "ba-tiny"):
        E = datasets.named_graph(name)
        got_t = pkt_mod.truss_pkt(E, device=dev)
        want_t = truss_numpy(E)
        if not np.array_equal(got_t, want_t):
            raise AssertionError(f"{name}: truss_pkt on the card differs "
                                 f"from truss_numpy")
        small[name] = dict(m=int(E.shape[0]), max_trussness=int(got_t.max()))
    emit("small_graph_oracle", graphs=small,
         seconds=time.perf_counter() - t0)

    # ---- 6. engine -----------------------------------------------------------
    t0 = time.perf_counter()
    fleet = engine_fleet(gen)
    t_fleet = time.perf_counter() - t0
    eng = TrussEngine(max_pending=len(fleet) + 1, device=dev)
    t0 = time.perf_counter()
    tickets = eng.submit_many(fleet)
    t_submit = time.perf_counter() - t0
    key_of = [eng.bucket_of(t) for t in tickets]
    buckets = set(key_of)
    if len(buckets) < 2:
        raise AssertionError("engine fleet filled fewer than two size classes")
    t0 = time.perf_counter()
    eng.flush()
    t_flush = time.perf_counter() - t0
    for t, E in zip(tickets, fleet):
        if not np.array_equal(eng.result(t), pkt_mod.truss_pkt(E, device=dev)):
            raise AssertionError(f"engine ticket {t} differs from truss_pkt")
    per_bucket = [dict(m_pad=k.m_pad, sup_pad=k.sup_pad, peel_pad=k.peel_pad,
                       graphs=key_of.count(k), **v)
                  for k, v in eng.stats["bucket_launches"].items()]
    for row in per_bucket:
        if (row["support"] < 1 or row["loop"] < 1 or row["plain"]
                or row["peel"] or row["update"]):
            raise AssertionError(f"engine bucket skipped a kernel or "
                                 f"launched a standalone K2 or update: "
                                 f"{row}")
    emit("engine", graphs=len(fleet), size_classes=len(buckets),
         edges=int(sum(e.shape[0] for e in fleet)),
         submit_seconds=t_submit, flush_seconds=t_flush,
         graphs_per_second=len(fleet) / t_flush,
         bucket_launches=per_bucket, generate_seconds=t_fleet,
         seconds=time.perf_counter() - t0)

    # ---- 7. K3 check ----------------------------------------------------------
    # the main path's tables are gone with its results; free the cache
    # before the D = 256 bucket's rows, masks and gather index (about 7 GB)
    del fleet, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k3_sweep = check_k3_sweep(dev, kint)
    emit("kernel_check_k3_sweep", **k3_sweep,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    k3_buckets = check_k3_buckets(g, dev, kint, kops)
    for row in k3_buckets:
        emit("kernel_check_k3", **row)
    emit("kernel_check_k3_buckets", buckets=len(k3_buckets),
         row_slots=sum(r["E"] * r["D"] for r in k3_buckets),
         ms=sum(r["ms"] for r in k3_buckets),
         bound_ms=sum(r["bound_ms"] for r in k3_buckets),
         bound_ms_all_pairs=sum(r["bound_ms_all_pairs"] for r in k3_buckets),
         plain_ms=sum(r["plain_ms"] for r in k3_buckets),
         seconds=time.perf_counter() - t0)

    # ---- 8. support kernel path ---------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts(mods)
    S_k3 = kops.compute_support_kernel(g, device=dev)
    k3_counts = kernel_counts(mods)
    t_k3 = time.perf_counter() - t0
    if not np.array_equal(S_k3, res.support):
        raise AssertionError("compute_support_kernel differs from K1's "
                             "support")
    if k3_counts["intersect"] != {"kernel": len(k3_buckets), "plain": 0}:
        raise AssertionError(f"support kernel path did not launch K3 once "
                             f"per bucket: {k3_counts}")
    _, fb = kops.degree_buckets(g)
    fb_wedges = int((g.Es[g.El[fb, 1] + 1].astype(np.int64)
                     - g.Eo[g.El[fb, 1]]).sum())
    emit("support_kernel_path", m=g.m, buckets=len(k3_buckets),
         fallback_edges=int(fb.size), fallback_wedges=fb_wedges,
         seconds=t_k3, launches=k3_counts, equal_to_k1=True)
    del S_k3
    torch.cuda.empty_cache()
    # where its device time goes: one more call, traced (outside the
    # counted window above)
    emit("support_kernel_path_profile", **profile_run(
        lambda: kops.compute_support_kernel(g, device=dev)))
    torch.cuda.empty_cache()

    # ---- 9. engines ----------------------------------------------------------
    t_eng = time.perf_counter()
    t0 = time.perf_counter()
    tri = enumerate_triangles(g, device=dev)
    t_enum = time.perf_counter() - t0
    if tri.shape != (int(res.support.sum()) // 3, 3):
        raise AssertionError(f"enumerate_triangles: shape {tri.shape}")
    del tri
    reset_counts(mods)
    t0 = time.perf_counter()
    t_tri = truss_trilist(g, device=dev)
    t_trilist = time.perf_counter() - t0
    tri_counts = kernel_counts(mods)
    if not np.array_equal(t_tri, res.trussness):
        raise AssertionError("truss_trilist differs from the main path")
    if tri_counts["support"] != {"kernel": 1, "plain": 0}:
        raise AssertionError(f"truss_trilist did not take K1: {tri_counts}")
    torch.cuda.empty_cache()
    trilist_profile = profile_run(lambda: truss_trilist(g, device=dev))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    core = kcore_park(g, device=dev)
    t_park = time.perf_counter() - t0
    t0 = time.perf_counter()
    core_bz = kcore_numpy(g)
    t_bz = time.perf_counter() - t0
    if not np.array_equal(core, core_bz):
        raise AssertionError("kcore_park differs from kcore_numpy")
    t0 = time.perf_counter()
    S_ros = sup.compute_support_ros(g, device=dev)
    t_ros = time.perf_counter() - t0
    if not np.array_equal(S_ros, res.support):
        raise AssertionError("compute_support_ros differs from K1's support")
    del S_ros
    torch.cuda.empty_cache()
    small_eng = {}
    for name in ("fig1", "karate_like", "cliques-tiny", "rmat-tiny",
                 "ba-tiny"):
        gs = build_csr(datasets.named_graph(name))
        want_t = truss_numpy(gs.El)
        for eng_name, got_t in (("wc", truss_wc(gs)),
                                ("ros", truss_ros(gs, device=dev)),
                                ("trilist", truss_trilist(gs, device=dev))):
            if not np.array_equal(got_t, want_t):
                raise AssertionError(f"{name}: truss_{eng_name} differs from "
                                     f"truss_numpy")
        if not np.array_equal(kops.compute_support_kernel(gs, device=dev),
                              sup.compute_support(gs, device=dev)):
            raise AssertionError(f"{name}: compute_support_kernel differs")
        if not np.array_equal(kcore_park(gs, device=dev), kcore_numpy(gs)):
            raise AssertionError(f"{name}: kcore_park differs")
        small_eng[name] = dict(m=gs.m, max_trussness=int(want_t.max()))
    emit("engines", m=g.m, triangles=int(res.support.sum()) // 3,
         max_core=int(core.max()), enumerate_triangles_seconds=t_enum,
         trilist_seconds=t_trilist, trilist_launches=tri_counts,
         trilist_profile=trilist_profile,
         kcore_park_seconds=t_park, kcore_numpy_seconds=t_bz,
         support_ros_seconds=t_ros, small_graph_oracle=small_eng,
         seconds=time.perf_counter() - t_eng)

    # ---- 10. cli -------------------------------------------------------------
    t0 = time.perf_counter()
    cli_s = {}
    for engine in cli.ENGINES:
        t1 = time.perf_counter()
        # prints its own summary lines; exits non-zero on a mismatch
        cli.main(["--graph", "rmat-small", "--engine", engine, "--verify"])
        cli_s[engine] = time.perf_counter() - t1
    emit("cli", graph="rmat-small", engines=list(cli.ENGINES),
         seconds_by_engine=cli_s, seconds=time.perf_counter() - t0)
    del res
    torch.cuda.empty_cache()

    # ---- 11. incremental -------------------------------------------------------
    t0 = time.perf_counter()
    inc_eng, handle, inc_summary, inc_batches = check_incremental(
        edges, dev, mods, TrussEngine, cli, enumerate_triangles)
    t1 = time.perf_counter()
    oracle = check_sequential_oracle(inc_eng, dev, mods, datasets, cli)
    t_oracle = time.perf_counter() - t1
    t1 = time.perf_counter()
    fault = check_corrupt_fault(inc_eng, dev, mods, datasets, cli, chaos,
                                IntegrityError)
    t_fault = time.perf_counter() - t1
    emit("incremental", **inc_summary, sequential_oracle=oracle,
         sequential_oracle_seconds=t_oracle, corrupt_fault=fault,
         corrupt_fault_seconds=t_fault, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # ---- 12. hierarchy ---------------------------------------------------------
    t0 = time.perf_counter()
    hier_summary = check_hierarchy(handle, dev, inc_eng, datasets, cli)
    emit("hierarchy", **hier_summary, seconds=time.perf_counter() - t0)
    inc_eng.close(handle)
    torch.cuda.empty_cache()

    # ---- 13. cli_updates -------------------------------------------------------
    t0 = time.perf_counter()
    cli_args = ["--graph", "rmat-small", "--update-stream", "4", "--churn",
                "0.01", "--query-communities", "4", "--verify"]
    # prints its own lines; exits non-zero on a mismatch
    cli.main(cli_args)
    emit("cli_updates", args=cli_args, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # ---- 14. serve ---------------------------------------------------------------
    t0 = time.perf_counter()
    serve = check_serve(edges, engine_fleet(gen), dev, mods, cli,
                        TrussEngine, TrussScheduler)
    emit("serve", **serve, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # ---- 15. chaos ---------------------------------------------------------------
    t0 = time.perf_counter()
    chaos_summary = check_chaos(dev, mods, datasets, cli, TrussEngine,
                                TrussScheduler, RetryPolicy, chaos)
    emit("chaos", **chaos_summary, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # ---- 16. dist ----------------------------------------------------------------
    t0 = time.perf_counter()
    dist_summary = check_dist(g, dev, mods, importlib.import_module(
        "repro_torch.core.pkt_dist"))
    emit("dist", **dist_summary, seconds=time.perf_counter() - t0)

    # ---- summary -------------------------------------------------------------
    # the summary line reports the widest K2 launch checked (and the update
    # after it); the per_pkt_* keys hold one decomposition's launches
    k2_first = max(k2_cases, key=lambda c: c["rows_frontier"])
    upd_first = k2_first["update"]
    kernels = [
        dict(name="support_accumulate", route="cuda",
             source="src/repro_torch/kernels/csrc/support.cu",
             replaces="src/repro/kernels/support.py:86",
             launches=main_counts["support"]["kernel"],
             launches_per_open=inc_summary["launches_per_open"]["support"],
             launches_per_update_batch=[b["launches"]["support"]
                                        for b in inc_batches],
             launches_serve=serve["launches"]["support"],
             launches_per_pkt_dist=dist_summary["launches"]["support"],
             max_abs_err=max(k1["max_abs_err"],
                             dist_summary["k1_edge_ranges"]["max_abs_err"]),
             ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="peel_decrement_fold", route="cuda",
             source="src/repro_torch/kernels/csrc/peel.cu",
             replaces="src/repro/kernels/peel.py:107",
             launches=main_counts["peel"]["kernel"],
             launches_host_loop=host_counts["peel"]["kernel"],
             launches_per_open=inc_summary["launches_per_open"]["peel"],
             launches_per_update_batch=[b["launches"]["peel"]
                                        for b in inc_batches],
             launches_serve=serve["launches"]["peel"],
             launches_per_pkt_dist=dist_summary["launches"]["peel"],
             max_abs_err=max(c["max_abs_err"] for c in k2_cases),
             state=k2_first["state"], ms=k2_first["ms"],
             plain_ms=k2_first["plain_ms"],
             bound_ms=k2_first["bound_ms"], bound_by=k2_first["bound_by"],
             library_ms=None,
             per_pkt_device_ms=k2_total["device_ms"]["ms"],
             per_pkt_bound_ms=k2_total["bound_ms"]),
        # the sparse update after a fold and the dense one of a level's
        # start; ms / plain_ms / bound_ms are the sparse launch's
        dict(name="sublevel_update", route="cuda",
             source="src/repro_torch/kernels/csrc/peel.cu",
             replaces="src/repro/core/pkt.py:264",
             launches=(main_counts["update"]["kernel"]
                       + main_counts["dense"]["kernel"]),
             launches_host_loop=(host_counts["update"]["kernel"]
                                 + host_counts["dense"]["kernel"]),
             launches_sparse=host_counts["update"]["kernel"],
             launches_level_start=host_counts["dense"]["kernel"],
             max_abs_err=max(c["update"]["max_abs_err"] for c in k2_cases),
             state=k2_first["state"], ms=upd_first["ms"],
             dense_ms=upd_first["dense_ms"],
             plain_ms=upd_first["plain_ms"], bound_ms=upd_first["bound_ms"],
             bound_by=upd_first["bound_by"], library_ms=None,
             per_pkt_device_ms=(update_total["device_ms"]["ms"]
                                + dense_total["device_ms"]["ms"]),
             per_pkt_sparse_ms=update_total["device_ms"]["ms"],
             per_pkt_level_start_ms=dense_total["device_ms"]["ms"],
             per_pkt_bound_ms=(update_total["bound_ms"]
                               + dense_total["bound_ms"]),
             per_pkt_bound_ms_dense_dec=(update_total["bound_ms_dense_dec"]
                                    + dense_total["bound_ms_dense_dec"])),
        # the fused loop: one launch a segment runs the fold and both
        # updates; per_pkt_* are one decomposition's, beside the host loop's
        # K2 and update launches summed
        dict(name="peel_loop", route="cuda",
             source="src/repro_torch/kernels/csrc/peel.cu",
             replaces="none: the JAX package's peel loop is a "
                      "lax.while_loop (src/repro/core/pkt.py:217)",
             launches=main_counts["loop"]["kernel"],
             launches_per_open=inc_summary["launches_per_open"]["loop"],
             launches_per_update_batch=[b["launches"]["loop"]
                                        for b in inc_batches],
             launches_serve=serve["launches"]["loop"],
             bitwise_equal_to_host_loop=True,
             per_pkt_device_ms=main_profile["named"]["peel_loop"]["ms"],
             host_loop_per_pkt_device_ms=(
                 k2_total["device_ms"]["ms"] + update_total["device_ms"]["ms"]
                 + dense_total["device_ms"]["ms"]),
             peel_seconds=peel_seconds["fused"],
             host_loop_peel_seconds=peel_seconds["host"],
             resident_grid=kpeel.resident_grids()),
        # the widest bucket; the all_buckets_* keys sum the six launches of
        # one compute_support_kernel call
        dict(name="intersect_blocked", route="cuda",
             source="src/repro_torch/kernels/csrc/intersect.cu",
             replaces="src/repro/kernels/intersect.py:65",
             launches=k3_counts["intersect"]["kernel"],
             max_abs_err=max([k3_sweep["max_abs_err"]]
                             + [r["max_abs_err"] for r in k3_buckets]),
             bucket_D=k3_buckets[-1]["D"], ms=k3_buckets[-1]["ms"],
             plain_ms=k3_buckets[-1]["plain_ms"],
             bound_ms=k3_buckets[-1]["bound_ms"],
             bound_by=k3_buckets[-1]["bound_by"], library_ms=None,
             all_buckets_ms=sum(r["ms"] for r in k3_buckets),
             all_buckets_bound_ms=sum(r["bound_ms"] for r in k3_buckets),
             all_buckets_bound_ms_all_pairs=sum(
                 r["bound_ms_all_pairs"] for r in k3_buckets),
             bucket_rows_by_path=dict(
                 search=sum(r["rows_by_path"]["search"] for r in k3_buckets),
                 all_pairs=sum(r["rows_by_path"]["all_pairs"]
                               for r in k3_buckets)),
             launches_on_pkt_main_path=main_counts["intersect"]["kernel"]),
    ]
    emit("done", seconds=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
