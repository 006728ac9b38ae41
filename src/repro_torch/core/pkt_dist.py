"""Distributed PKT — bulk-synchronous truss decomposition over ranks.

The port of the JAX package's ``core/pkt_dist.py`` (a ``shard_map`` over a
mesh axis) to ``torch.distributed``: one process per rank, each with its
own device, joined by a process group.

  * the flat peel-wedge table (the unit of peel work) is split into one
    slice per rank; each rank builds only its slice and computes the
    decrements of its rows;
  * edge state (S, processed, frontier) is replicated; one all-reduce of
    the (m+1,) int32 decrement vector per sub-level is the only
    communication — the distributed analogue of the paper's per-sub-level
    barrier.  Integer sums are exact, so every rank holds the same state
    and the result is bitwise the single-device one;
  * the support phase fans out the same way and all-reduces the partial
    supports once.  ``support_mode="kernel"`` runs K1
    (``kernels/support.py``) on each rank's edge range — the edges whose
    oriented rows are the rank's share of the support table, cut where the
    row offsets cross ``rank · rows / world`` — and builds no table;
    ``support_mode="torch"`` runs the torch executor over the rank's slice
    of the oriented table.

The peel body is the JAX package's dense one (jnp, not a Pallas kernel), in
torch ops: every row of the slice is read each sub-level and masked by the
frontier.  The port selects the frontier's rows before their probe rather
than after it, which changes no decrement and skips the searches of rows
the mask would zero.

Without a process group (``group=None`` and ``torch.distributed`` not
initialized) it runs as one rank with no collective.  A group's backend
must fit the device: ``nccl`` for CUDA tensors, ``gloo`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import support as support_mod
from repro_torch.core.pkt import _SENTINEL_S
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels import peel as peel_kernel
from repro_torch.kernels import wedge_common

#: the backend a group must have for the device its tensors live on
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _rank_of(group, device: torch.device) -> tuple:
    """``(group, world, rank)``; ``(None, 1, 0)`` without a process group.

    Raises:
        ValueError: the group's backend does not serve ``device``.
    """
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    want = _BACKENDS[device.type]
    # a group may name one backend per device type ("cpu:gloo,cuda:nccl")
    per_type = dict(part.split(":", 1) for part in backend.split(",")
                    if ":" in part)
    have = per_type.get(device.type, backend)
    if have != want:
        raise ValueError(
            f"pkt_dist on {device.type} needs a {want!r} process group, got "
            f"backend {backend!r}; pass a group of the right backend or "
            f"another device")
    return group, dist.get_world_size(group), dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (a no-op on one rank)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _host_slice(tab: support_mod.WedgeTable, start: int, size: int, m: int,
                device: torch.device) -> tuple:
    """Rows ``[start, start + size)`` of a host table, padded inertly
    (anchor ``m``, empty probe range), on ``device``."""
    def part(a, fill):
        out = np.full(size, fill, np.int32)
        rows = a[start:start + size]
        out[:rows.shape[0]] = rows
        return torch.from_numpy(out).to(device)

    return (part(tab.e1, m), part(tab.cand_slot, 0), part(tab.lo, 0),
            part(tab.hi, 0))


def edge_ranges(g: CSRGraph, world: int) -> np.ndarray:
    """``(world + 1,)`` edge bounds: rank ``r`` takes the anchors
    ``[b[r], b[r+1])`` of the oriented support rows, cut where the row
    offsets cross ``r · rows / world``."""
    v = g.El[:, 1].astype(np.int64)
    cnt = g.Es.astype(np.int64)[v + 1] - g.Eo.astype(np.int64)[v]
    off = np.concatenate([[0], np.cumsum(cnt)])
    rows = int(off[-1])
    targets = np.arange(world + 1, dtype=np.int64) * rows // world
    bounds = np.searchsorted(off, targets, side="left")
    bounds[-1] = g.m
    return bounds


def _support(g: CSRGraph, dev: dict, *, mode: str, table_mode: str,
             chunk: int, iters: int, world: int, rank: int, group,
             device: torch.device) -> torch.Tensor:
    """The sharded support phase: (m,) int32 on ``device``, summed over the
    ranks."""
    m = g.m
    s_size = support_mod.support_table_size(g)
    per_shard = max(1, -(-max(s_size, 1) // world))
    if mode == "kernel":
        from repro_torch.kernels.support import support_accumulate

        # the JAX package rounds each shard to whole kernel chunks
        sup_chunk = wedge_common.pow2_chunk(1 << 13, chunk)
        per_shard = -(-per_shard // sup_chunk) * sup_chunk
        support_mod._check_table_size((rank + 1) * per_shard)
        bounds = edge_ranges(g, world)
        S, _ = support_accumulate(
            dev["u"], dev["v"], dev["Es"], dev["Eo"], dev["N"], dev["Eid"],
            m=m, chunk=sup_chunk, n_chunks=per_shard * world // sup_chunk,
            e_begin=int(bounds[rank]), e_end=int(bounds[rank + 1]))
        S = S[:m].contiguous()
    else:
        start = rank * per_shard
        support_mod._check_table_size(start + per_shard)
        if table_mode == "device":
            e1, cand, lo, hi, _ = support_mod._build_support_table_dev(
                dev["u"], dev["v"], dev["Es"], dev["Eo"], m, m=m,
                size=per_shard, start=start)
        else:
            e1, cand, lo, hi = _host_slice(
                support_mod.build_support_table(g), start, per_shard, m,
                device)
        S = support_mod._support_torch(dev["N"], dev["Eid"], e1, cand, lo,
                                       hi, iters, m)
        del e1, cand, lo, hi
    return _all_reduce(S, group)


def _slice_decrements(tab: tuple, N, Eid, S_ext, processed, inCurr, l, *,
                      m: int, iters: int) -> torch.Tensor:
    """This rank's (m+1,) int32 decrements over its peel-table slice."""
    e1, cand, lo, hi = tab
    dec = torch.zeros(m + 1, dtype=torch.int32, device=S_ext.device)
    # the frontier mask over the whole slice: one host sync a sub-level
    front = torch.nonzero(inCurr[e1])[:, 0]
    for start, stop in wedge_common.row_slices(front.shape[0]):
        rows = front[start:stop]
        peel_kernel.decrement_rows(
            dec, e1[rows], cand[rows], lo[rows], hi[rows], N, Eid, S_ext,
            processed, inCurr, None, l, iters=iters)
    return dec


def pkt_dist(g: CSRGraph, *, chunk: int = 1 << 12,
             support_mode: str = "kernel", table_mode: str = "device",
             group=None, device="cuda") -> np.ndarray:
    """Run distributed PKT over the ranks of ``group``; returns the (m,)
    int64 trussness aligned to ``g.El`` rows, on every rank.

    Bitwise equal to the JAX package's ``pkt_dist`` and to the
    single-device ``truss_pkt``, for any number of ranks.

    Args:
        g: the graph (every rank passes the same one).
        chunk: the peel table's chunk: each rank's slice is a whole number
            of chunks (pow2).
        support_mode: per-rank support executor (``support.SUPPORT_MODES``):
            "kernel" — K1 over the rank's edge range, no table — or
            "torch" — the torch executor over the rank's table slice.
        table_mode: where the wedge-table slices are built:
            "device" (the default) or "numpy" (host builders, the parity
            oracle).
        group: the ``torch.distributed`` process group; ``None`` uses the
            default group when one is initialized, else runs one rank with
            no collective.
        device: "cuda" (the default; raises when no card is present) or
            "cpu", where K1 runs its plain version.

    Raises:
        ValueError: unknown ``support_mode``/``table_mode``; a group whose
            backend does not serve ``device`` (``nccl`` for CUDA, ``gloo``
            for the CPU); a table slice beyond the int32 layout.
        RuntimeError: ``device`` is CUDA and no card is present.
    """
    support_mod.check_axis("support_mode", support_mode,
                           support_mod.SUPPORT_MODES)
    support_mod.check_axis("table_mode", table_mode, support_mod.TABLE_MODES)
    device = resolve_device(device)
    group, world, rank = _rank_of(group, device)
    m = g.m
    if m == 0:
        return np.zeros(0, np.int64)
    chunk = wedge_common.next_pow2(chunk)
    iters = support_mod._search_iters(g)
    dev = g.device_arrays(device)

    S0 = _support(g, dev, mode=support_mode, table_mode=table_mode,
                  chunk=chunk, iters=iters, world=world, rank=rank,
                  group=group, device=device)

    p_size = support_mod.peel_table_size(g)
    per = max(chunk, -(-max(p_size, 1) // world))
    per = -(-per // chunk) * chunk           # round to a chunk multiple
    start = rank * per
    support_mod._check_table_size(start + per)
    if table_mode == "device":
        tab = support_mod._build_peel_table_dev(
            dev["u"], dev["v"], dev["Es"], m, m=m, size=per, chunk=chunk,
            start=start)[:4]
    else:
        tab = _host_slice(support_mod.build_peel_table(g), start, per, m,
                          device)

    S_ext = torch.cat([S0.to(torch.int32),
                       torch.full((1,), _SENTINEL_S, dtype=torch.int32,
                                  device=device)])
    processed = torch.zeros(m + 1, dtype=torch.bool, device=device)
    processed[m] = True
    todo = m
    while todo > 0:
        l = torch.where(processed, _SENTINEL_S, S_ext).min()
        inCurr = ~processed & (S_ext == l)
        # a level's first frontier is never empty: some live edge holds l
        while True:
            dec = _slice_decrements(tab, dev["N"], dev["Eid"], S_ext,
                                    processed, inCurr, l, m=m, iters=iters)
            _all_reduce(dec, group)
            inCurr = peel_kernel.apply_decrements(dec, S_ext, processed,
                                                  inCurr, l, m)
            if not bool(inCurr.any()):
                break
        todo = (m + 1) - int(processed.sum())
    return S_ext[:m].cpu().numpy().astype(np.int64) + 2
