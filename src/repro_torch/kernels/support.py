"""K1: the AM4 support phase (oriented triangle counting), fed by the CSR.

The port of the JAX package's Pallas kernel ``repro/kernels/support.py:
support_accumulate``.  The JAX kernel streams the oriented wedge table: one
row per edge ``(u, v)`` and candidate ``w ∈ N⁺(v)``, searched in ``N⁺(u)``.
Each hit — one triangle, found exactly once under the orientation — adds 1
to the support of its three edges: the edge itself, ``Eid[cand]`` and
``Eid[hit slot]``; each table chunk also reports its triangle count.  Here
the rows are read from the CSR (``N⁺(x) = N[Eo[x]:Es[x+1])``) and the table
never exists: row ``j`` of edge ``e`` is table row ``off[e] + j``, with
``off`` the prefix of ``|N⁺(v)|`` (``support_offsets``).

``support_accumulate`` launches the CUDA kernel ``csrc/support.cu`` on CUDA
tensors and runs ``support_accumulate_ref``, its plain PyTorch version, on
CPU tensors — and only there.  Output contract of both: ``S_ext`` (m+1,)
int32 with the supports in ``S_ext[:m]``; slot ``m`` is outside the
contract (the JAX kernel scatters misses there, the port writes nothing to
it); ``tri`` (n_chunks,) int32 triangle partials of the reference's table
chunks of ``chunk`` rows, which sum to ``S_ext[:m].sum() / 3``.

An edge range ``[e_begin, e_end)`` (default ``[0, m)``) restricts both to
the rows of those edges: the triangles they anchor, counted on all three of
their edges.  The sums over ranges that cover ``[0, m)`` equal the whole
call; distributed PKT (``core/pkt_dist.py``) gives each rank one range.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build, wedge_common

#: launches of the CUDA kernel / calls of the plain version
COUNTS = cuda_build.LaunchCounts()


def support_offsets(u, v, Es, Eo):
    """(m+1,) int32 table offsets: edge ``e``'s rows are ``[off[e],
    off[e+1])``, one per slot of ``N⁺(v[e])``."""
    v = v.long()
    cnt = Es[v + 1] - Eo[v]
    off = torch.zeros(cnt.shape[0] + 1, dtype=torch.int32, device=cnt.device)
    torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
    return off


def _edge_range(m: int, e_begin: int, e_end: int | None) -> tuple[int, int]:
    e_end = m if e_end is None else int(e_end)
    if not 0 <= int(e_begin) <= e_end <= m:
        raise ValueError(f"edge range [{e_begin}, {e_end}) is not inside "
                         f"[0, {m})")
    return int(e_begin), e_end


def support_accumulate(u, v, Es, Eo, N, Eid, *, m: int, chunk: int,
                       n_chunks: int, e_begin: int = 0,
                       e_end: int | None = None):
    """Fused support fold and per-chunk triangle partials → ``(S_ext, tri)``.

    ``u``/``v`` (m,) int32 edge endpoints (``u < v``); ``Es`` (n+1,) and
    ``Eo`` (n,) CSR offsets; ``N``/``Eid`` (two_m,) int32.  ``chunk`` and
    ``n_chunks`` name the reference table's chunks (``n_chunks * chunk``
    rows at least).  Only the anchors ``e_begin <= e < e_end`` are
    scanned (default: all ``m``).  CUDA tensors launch the kernel; CPU
    tensors run the plain version.
    """
    dev = u.device
    if dev.type == "cpu":
        return support_accumulate_ref(u, v, Es, Eo, N, Eid, m=m, chunk=chunk,
                                      n_chunks=n_chunks, e_begin=e_begin,
                                      e_end=e_end)
    if dev.type != "cuda":
        raise ValueError(f"support_accumulate: unsupported device {dev}")
    cuda_build.check_int32("u", u, dev, (m,))
    cuda_build.check_int32("v", v, dev, (m,))
    cuda_build.check_int32("Es", Es, dev)
    cuda_build.check_int32("Eo", Eo, dev, (Es.shape[0] - 1,))
    two_m = N.shape[0]
    cuda_build.check_int32("N", N, dev, (two_m,))
    cuda_build.check_int32("Eid", Eid, dev, (two_m,))
    if chunk < 1 or n_chunks < 1:
        raise ValueError(f"chunk {chunk} / n_chunks {n_chunks} must be >= 1")
    e_begin, e_end = _edge_range(m, e_begin, e_end)
    S = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    tri = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    if e_end == e_begin or two_m == 0:
        return S, tri
    off = support_offsets(u, v, Es, Eo)
    lib = cuda_build.library("support")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.support_accumulate_launch(
            u.data_ptr(), v.data_ptr(), Es.data_ptr(), Eo.data_ptr(),
            off.data_ptr(), N.data_ptr(), Eid.data_ptr(), S.data_ptr(),
            tri.data_ptr(), e_begin, e_end, chunk, stream)
    cuda_build.check_launch(lib, "support", code)
    COUNTS.launched()
    return S, tri


def support_accumulate_ref(u, v, Es, Eo, N, Eid, *, m: int, chunk: int,
                           n_chunks: int, e_begin: int = 0,
                           e_end: int | None = None):
    """Plain PyTorch version of ``support_accumulate`` (same contract).

    Expands the rows of the range's edges with torch ops, in slices of
    ``wedge_common.SLICE_ROWS`` rows: the owning edge by a search of the
    offsets, the candidate and probe range from the CSR, then the probe and
    integer scatter-adds of the hits into ``S_ext`` and ``tri``.  The search
    runs enough halvings for the longest ``N⁺`` list, so it finds the exact
    lower bound.
    """
    COUNTS.ran_plain()
    e_begin, e_end = _edge_range(m, e_begin, e_end)
    dev = u.device
    S = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    tri = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    if e_end == e_begin or N.shape[0] == 0:
        return S, tri
    off = support_offsets(u, v, Es, Eo)
    iters = max(1, int((Es[1:Eo.shape[0] + 1] - Eo).max()).bit_length())
    base = int(off[e_begin])
    for start, stop in wedge_common.row_slices(int(off[e_end]) - base):
        rows = torch.arange(base + start, base + stop, dtype=torch.int32,
                            device=dev)
        e = torch.searchsorted(off[1:], rows, right=True)
        j = rows - off[e]
        cand = Eo[v[e].long()] + j
        a = u[e].long()
        hit, safe = wedge_common.probe(N, cand, Eo[a], Es[a + 1], iters=iters)
        idx = torch.nonzero(hit)[:, 0]
        ones = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
        S.index_add_(0, e[idx], ones)
        S.index_add_(0, Eid[cand[idx]], ones)
        S.index_add_(0, Eid[safe[idx]], ones)
        tri.index_add_(0, rows[idx].long() // chunk, ones)
    return S, tri
