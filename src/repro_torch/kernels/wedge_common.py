"""Shared wedge-table machinery for the port's torch executors.

The JAX package's hot-phase kernels walk a flat *wedge table* — one row per
(anchor edge, candidate adjacency slot) pair, with a probe range ``[lo,
hi)`` into the CSR adjacency array ``N``: the oriented AM4 table for the
support phase, the full-adjacency ProcessSubLevel table for the peel.  The
port's torch executors keep those tables (they are the parity oracle); the
CUDA kernels read the same wedges from the CSR and build none.  This module
is the single home of the table math:

  * **chunk layout** — tables are cut into fixed-size chunks (the unit of
    chunk skipping in the peel); ``chunk_layout`` sanitizes a requested
    chunk size (clamped so that ``n_chunks >= 1`` always holds, including
    zero-entry tables) and ``pad_chunked`` pads the four table arrays to a
    whole number of chunks with inert sentinel rows (anchor ``m``, empty
    probe range ``lo == hi``);
  * **the search primitive** — ``ranged_searchsorted`` is the branch-free
    lower-bound binary search both phases use as their membership test, and
    ``probe`` fuses it with the candidate gather and hit predicate
    (``w ∈ N[lo:hi)``).  These torch versions serve the torch executors
    and the kernels' plain versions; the CUDA kernels search to the exact
    lower bound, which the ``iters`` bound always reaches, in
    ``csrc/wedge_common.cuh``.

The chunk policy is the formula fallback of the JAX package's
``auto_chunk``: its hill-climbed table was measured on JAX CPU executors and
says nothing about the card.  The chunk size never changes a result, only
the padding layout.
"""

from __future__ import annotations

import numpy as np
import torch


#: adjacency padding value: larger than any vertex id, so padded slots can
#: never match a probe (shared by the engine and the compacted re-peel)
PAD_N = np.int32(1 << 30)

#: the plain torch executors process tables in slices of at most this many
#: rows, so an ``iters``-step search over a 2^29-row table keeps its
#: temporaries to a few hundred MiB instead of tens of GiB
SLICE_ROWS = 1 << 24


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x - 1).bit_length())


#: auto-chunk policy: aim for this many chunks per wedge table, so that the
#: chunk-skipping peel has skippable units even on small graphs …
AUTO_CHUNK_TARGET = 16
#: … clamped to this band
AUTO_CHUNK_MIN = 1 << 7
AUTO_CHUNK_MAX = 1 << 14


def auto_chunk(size: int, *, target: int = AUTO_CHUNK_TARGET,
               lo: int = AUTO_CHUNK_MIN, hi: int = AUTO_CHUNK_MAX) -> int:
    """Derive a chunk size from the table size (used when none is requested).

    A power of two sized so the table splits into roughly ``target``
    chunks, clamped to ``[lo, hi]``.
    """
    size = max(1, int(size))
    want = next_pow2(-(-size // max(1, int(target))))
    return int(min(hi, max(lo, want)))


def pow2_chunk(size_pad: int, chunk: int | None, *,
               size: int | None = None) -> int:
    """Chunk size for a pow2-padded table: a power of two dividing ``size_pad``.

    ``chunk=None`` applies the ``auto_chunk`` policy against the *real*
    table size (``size``, defaulting to ``size_pad``); an explicit chunk is
    rounded down to a power of two so it always divides the padded table.
    """
    if chunk is None:
        chunk = auto_chunk(size_pad if size is None else size)
    else:
        chunk = 1 << max(0, int(chunk).bit_length() - 1)
    return max(1, min(int(chunk), int(size_pad)))


def pad1(x: np.ndarray, size: int, fill) -> np.ndarray:
    """Right-pad a 1-D int array to ``size`` with ``fill`` (int32 out)."""
    out = np.full(size, fill, np.int32)
    out[: x.shape[0]] = x
    return out


def chunk_layout(size: int, chunk: int | None = None) -> tuple[int, int]:
    """Sanitize a requested chunk size against a table of ``size`` entries.

    Returns ``(chunk, n_chunks)`` with ``1 <= chunk`` and ``n_chunks >= 1``:
    a chunk larger than the table, zero, or negative is clamped; a zero-entry
    table yields one all-padding chunk of size 1.  ``chunk=None`` derives
    the size from the table via ``auto_chunk``.
    """
    size = max(1, int(size))
    if chunk is None:
        chunk = auto_chunk(size)
    chunk = max(1, min(int(chunk), size))
    return chunk, -(-size // chunk)


def pad_chunked(e1: np.ndarray, cand_slot: np.ndarray, lo: np.ndarray,
                hi: np.ndarray, *, m: int, chunk: int,
                n_chunks: int) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Pad the four wedge-table arrays to ``n_chunks * chunk`` inert rows.

    Padding rows carry the anchor sentinel ``m`` and an empty probe range
    (``lo == hi == 0``), so they can never produce a hit.
    """
    nw = int(e1.shape[0])
    pad = n_chunks * chunk - nw
    if pad < 0:
        raise ValueError(f"{nw} rows do not fit {n_chunks} chunks of {chunk}")
    return (
        np.concatenate([e1, np.full(pad, m, np.int32)]).astype(np.int32),
        np.concatenate([cand_slot, np.zeros(pad, np.int32)]).astype(np.int32),
        np.concatenate([lo, np.zeros(pad, np.int32)]).astype(np.int32),
        np.concatenate([hi, np.zeros(pad, np.int32)]).astype(np.int32),
    )


def row_slices(rows: int):
    """``(start, stop)`` pairs covering ``range(rows)``, ``SLICE_ROWS`` each."""
    return [(s, min(s + SLICE_ROWS, rows))
            for s in range(0, rows, SLICE_ROWS)]


def ranged_searchsorted(N: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, iters: int) -> torch.Tensor:
    """Lower-bound binary search of ``w`` in sorted ``N[lo:hi)``, elementwise.

    Returns the insertion index (== hi when all elements < w).  ``iters``
    must be >= ceil(log2(max(hi - lo) + 1)); exactly ``iters`` masked
    halvings run, as in the JAX package.
    """
    lo_ = lo.clone()
    hi_ = hi.clone()
    top = max(N.shape[0] - 1, 0)
    for _ in range(iters):
        adv = lo_ < hi_
        mid = (lo_ + hi_) >> 1
        go_right = N[mid.clamp(max=top)] < w
        lo_ = torch.where(adv & go_right, mid + 1, lo_)
        hi_ = torch.where(adv & ~go_right, mid, hi_)
    return lo_


def probe(N: torch.Tensor, cand_slot: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, *, iters: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Fused wedge membership test: is ``w = N[cand_slot]`` in ``N[lo:hi)``?

    Returns ``(hit, safe)`` where ``safe`` is the (clamped) index of the
    matching slot — valid as a gather index whenever ``hit`` is True, and a
    harmless in-bounds index otherwise.
    """
    w = N[cand_slot]
    idx = ranged_searchsorted(N, w, lo, hi, iters)
    safe = idx.clamp(max=N.shape[0] - 1)
    hit = (idx < hi) & (N[safe] == w)
    return hit, safe


def ranged_searchsorted_np(N: np.ndarray, w: np.ndarray, lo: np.ndarray,
                           hi: np.ndarray, iters: int) -> np.ndarray:
    """Host-numpy mirror of ``ranged_searchsorted`` (same bounds contract)."""
    lo_ = lo.astype(np.int64, copy=True)
    hi_ = hi.astype(np.int64, copy=True)
    top = max(N.shape[0] - 1, 0)
    for _ in range(iters):
        adv = lo_ < hi_
        mid = (lo_ + hi_) >> 1
        val = N[np.minimum(mid, top)]
        go_right = val < w
        lo_ = np.where(adv & go_right, mid + 1, lo_)
        hi_ = np.where(adv & ~go_right, mid, hi_)
    return lo_


def probe_np(N: np.ndarray, cand_slot: np.ndarray, lo: np.ndarray,
             hi: np.ndarray, *, iters: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-numpy mirror of ``probe``: (hit, safe) for w = N[cand_slot]."""
    if N.size == 0 or cand_slot.size == 0:
        z = np.zeros(cand_slot.shape[0], np.int64)
        return z.astype(bool), z
    w = N[cand_slot]
    idx = ranged_searchsorted_np(N, w, lo, hi, iters)
    safe = np.minimum(idx, N.shape[0] - 1)
    hit = (idx < hi) & (N[safe] == w)
    return hit, safe
