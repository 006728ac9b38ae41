"""K2: one ProcessSubLevel decrement fold over the peel wedge table.

The port of the JAX package's Pallas kernel ``repro/kernels/peel.py:
peel_decrement_fold``.  At level ``l`` a table row counts when its chunk is
active, its anchor ``e1`` is on the frontier, the probe ``N[cand] ∈
N[lo:hi)`` hits, and neither ``e2 = Eid[cand]`` nor ``e3 = Eid[safe]`` is
processed.  It then adds 1 to ``dec[e2]`` when ``S[e2] > l``, ``e2`` is not
pinned, and ``e3`` is off the frontier or ``e1 < e3`` (the paper's
lowest-id tie-break: of two frontier edges sharing a triangle, the lower id
processes it); ``e3`` symmetrically.

``peel_decrement_fold`` launches the CUDA kernel ``csrc/peel.cu`` on CUDA
tensors — over all chunks, with the active mask and the level read on the
device, so the launch needs no host sync — and runs
``peel_decrement_fold_ref``, its plain PyTorch version, on CPU tensors and
only there.  Output of both: ``dec`` (m+1,) int32, read ``dec[:m]``; slot
``m`` is outside the contract (the port leaves it 0).

Operands: ``active`` (n_chunks,) bool/uint8; ``l`` (1,) int32 on the device;
table arrays (n_chunks*chunk,) int32; ``N``/``Eid`` (two_m,) int32;
``S_ext`` (m+1,) int32; ``processed``/``inCurr``/``pinned`` (m+1,)
bool/uint8 (``pinned=None``: no schedule edges).  The masks travel as bytes,
a quarter of the JAX kernel's int32 state traffic; their values, and so the
result, are the same.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build, wedge_common

#: launches of the CUDA kernel / calls of the plain version
COUNTS = cuda_build.LaunchCounts()


def peel_decrement_fold(active, l, e1, cand, lo, hi, N, Eid, S_ext,
                        processed, inCurr, pinned=None, *, chunk: int,
                        n_chunks: int, iters: int, m: int):
    """Decrement vector of one sub-level at level ``l`` → (m+1,) int32."""
    dev = e1.device
    if dev.type == "cpu":
        return peel_decrement_fold_ref(
            active, l, e1, cand, lo, hi, N, Eid, S_ext, processed, inCurr,
            pinned, chunk=chunk, n_chunks=n_chunks, iters=iters, m=m)
    if dev.type != "cuda":
        raise ValueError(f"peel_decrement_fold: unsupported device {dev}")
    rows = n_chunks * chunk
    for name, t in (("e1", e1), ("cand", cand), ("lo", lo), ("hi", hi)):
        cuda_build.check_int32(name, t, dev, (rows,))
    two_m = N.shape[0]
    cuda_build.check_int32("N", N, dev, (two_m,))
    cuda_build.check_int32("Eid", Eid, dev, (two_m,))
    cuda_build.check_int32("S_ext", S_ext, dev, (m + 1,))
    cuda_build.check_int32("l", l, dev, (1,))
    cuda_build.check_mask("active", active, dev, (n_chunks,))
    for name, t in (("processed", processed), ("inCurr", inCurr)):
        cuda_build.check_mask(name, t, dev, (m + 1,))
    if pinned is not None:
        cuda_build.check_mask("pinned", pinned, dev, (m + 1,))
    dec = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if rows == 0 or two_m == 0:
        return dec
    lib = cuda_build.library("peel")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.peel_decrement_fold_launch(
            active.data_ptr(), l.data_ptr(), e1.data_ptr(), cand.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), N.data_ptr(), Eid.data_ptr(),
            S_ext.data_ptr(), processed.data_ptr(), inCurr.data_ptr(),
            None if pinned is None else pinned.data_ptr(), dec.data_ptr(),
            n_chunks, chunk, iters, two_m, stream)
    cuda_build.check_launch(lib, "peel", code)
    COUNTS.kernel += 1
    return dec


def decrement_rows(dec, e1, cand, lo, hi, N, Eid, S_ext, processed, inCurr,
                   pinned, l, *, iters: int) -> None:
    """Fold the decrements of a batch of table rows into ``dec`` in place.

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


def peel_decrement_fold_ref(active, l, e1, cand, lo, hi, N, Eid, S_ext,
                            processed, inCurr, pinned=None, *, chunk: int,
                            n_chunks: int, iters: int, m: int):
    """Plain PyTorch version of ``peel_decrement_fold`` (same contract).

    Walks the table in slices of ``wedge_common.SLICE_ROWS`` rows and, like
    the kernel, probes only the rows whose chunk is active and whose anchor
    is on the frontier; the others cannot count.
    """
    COUNTS.plain += 1
    dev = e1.device
    dec = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if N.shape[0] == 0:
        return dec
    act = active.bool()
    proc = processed.bool()
    curr = inCurr.bool()
    pin = None if pinned is None else pinned.bool()
    lv = l.reshape(())
    for start, stop in wedge_common.row_slices(n_chunks * chunk):
        rows = torch.arange(start, stop, device=dev, dtype=torch.int64)
        rows = rows[act[rows // chunk] & curr[e1[start:stop]]]
        decrement_rows(dec, e1[rows], cand[rows], lo[rows], hi[rows], N, Eid,
                       S_ext, proc, curr, pin, lv, iters=iters)
    return dec
