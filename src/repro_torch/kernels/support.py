"""K1: the AM4 support phase (oriented triangle counting) over a wedge table.

The port of the JAX package's Pallas kernel ``repro/kernels/support.py:
support_accumulate``.  One table row is one oriented wedge ``(u→v, w ∈
N⁺(v))``: the candidate ``w = N[cand]`` is searched in ``N⁺(u) = N[lo:hi)``
and each hit — one triangle, found exactly once under the orientation —
adds 1 to the support of its three edges: the anchor ``e1``, ``Eid[cand]``
and ``Eid[safe]``.  Each chunk of the table also reports its triangle count.

``support_accumulate`` launches the CUDA kernel ``csrc/support.cu`` on CUDA
tensors and runs ``support_accumulate_ref``, its plain PyTorch version, on
CPU tensors — and only there.  Output contract of both: ``S_ext`` (m+1,)
int32 with the supports in ``S_ext[:m]``; slot ``m`` is outside the
contract (the JAX kernel scatters misses there, the port writes nothing to
it); ``tri`` (n_chunks,) int32 triangle partials that sum to
``S_ext[:m].sum() / 3``.

Bound at the main path's shape (Graph500 scale 17): streaming the 380 M real
table rows of 16 bytes once, 6.1 GB, about 1.8 ms at 3.35 TB/s — see the
kernel's source note and PERF.md.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build, wedge_common

#: launches of the CUDA kernel / calls of the plain version
COUNTS = cuda_build.LaunchCounts()


def support_accumulate(e1, cand, lo, hi, N, Eid, *, chunk: int,
                       n_chunks: int, iters: int, m: int):
    """Fused support fold and per-chunk triangle partials for a full table.

    Table arrays are ``(n_chunks*chunk,)`` int32, padded per
    ``wedge_common.pad_chunked``; ``N``/``Eid`` are ``(two_m,)`` int32.
    Returns ``(S_ext, tri)`` as described in the module docstring.  CUDA
    tensors launch the kernel; CPU tensors run the plain version.
    """
    dev = e1.device
    if dev.type == "cpu":
        return support_accumulate_ref(e1, cand, lo, hi, N, Eid, chunk=chunk,
                                      n_chunks=n_chunks, iters=iters, m=m)
    if dev.type != "cuda":
        raise ValueError(f"support_accumulate: unsupported device {dev}")
    rows = n_chunks * chunk
    for name, t in (("e1", e1), ("cand", cand), ("lo", lo), ("hi", hi)):
        cuda_build.check_int32(name, t, dev, (rows,))
    two_m = N.shape[0]
    cuda_build.check_int32("N", N, dev, (two_m,))
    cuda_build.check_int32("Eid", Eid, dev, (two_m,))
    S = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    tri = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    if rows == 0 or two_m == 0:
        return S, tri
    lib = cuda_build.library("support")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.support_accumulate_launch(
            e1.data_ptr(), cand.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            N.data_ptr(), Eid.data_ptr(), S.data_ptr(), tri.data_ptr(),
            rows, chunk, iters, two_m, stream)
    cuda_build.check_launch(lib, "support", code)
    COUNTS.kernel += 1
    return S, tri


def support_accumulate_ref(e1, cand, lo, hi, N, Eid, *, chunk: int,
                           n_chunks: int, iters: int, m: int):
    """Plain PyTorch version of ``support_accumulate`` (same contract).

    Walks the table in slices of ``wedge_common.SLICE_ROWS`` rows: probe,
    then integer scatter-adds of the hits into ``S_ext`` and ``tri``.
    """
    COUNTS.plain += 1
    dev = e1.device
    S = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    tri = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    if N.shape[0] == 0:
        return S, tri
    for start, stop in wedge_common.row_slices(n_chunks * chunk):
        c = cand[start:stop]
        hit, safe = wedge_common.probe(N, c, lo[start:stop], hi[start:stop],
                                       iters=iters)
        inc = hit.to(torch.int32)
        S.index_add_(0, e1[start:stop], inc)
        S.index_add_(0, Eid[c], inc)
        S.index_add_(0, Eid[safe], inc)
        rows = torch.arange(start, stop, device=dev, dtype=torch.int64)
        tri.index_add_(0, rows // chunk, inc)
    # misses added 0 everywhere, padding rows 0 to slot m: S[m] == 0, as the
    # kernel leaves it
    return S, tri
