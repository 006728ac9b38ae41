"""K3: row-wise set intersection of padded id rows.

The port of the JAX package's Pallas kernel ``repro/kernels/intersect.py:
intersect_blocked``.  For rows ``a`` (E, DA) and ``b`` (E, DB) of vertex
ids — padded with -1 in ``a`` and -2 in ``b`` by the callers, so padding
never matches — it returns, all int32:

  count  (E,)      |a_row ∩ b_row| counted over a's slots
  hit_a  (E, DA)   1 where an ``a`` slot equals some ``b`` slot of its row
  hit_b  (E, DB)   1 where a ``b`` slot equals some ``a`` slot of its row

The rows need not be sorted and may repeat ids.  The hit masks let
``ops.compute_support_kernel`` add support at the edge ids of the matching
adjacency slots.

``intersect_blocked`` launches the CUDA kernel ``csrc/intersect.cu`` (int32
and int16 ids) on CUDA tensors and runs ``intersect_ref``, its plain
PyTorch version, on CPU tensors — and only there.  The kernel picks a path
per row from the data: a ``b`` row of at most four non-decreasing runs (a
CSR row and its padding are two) is binary-searched, any other row is
compared all-pairs.  ``path_rows`` reads how many rows took each path.

Bound at the degree-class buckets of Graph500 scale 17: 4.43 GB of reads
and writes, about 1.33 ms at the H100's 3.35 TB/s — see the kernel's source
note and PERF.md.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build

#: launches of the CUDA kernel / calls of the plain version
COUNTS = cuda_build.LaunchCounts()

#: id types the kernel is built for, and their launch functions
_LAUNCH = {torch.int32: "intersect_i32_launch",
           torch.int16: "intersect_i16_launch"}

#: shared memory one block may use on the H100; one warp stages a B row
#: and its hit flags there
_MAX_SMEM = 232448

#: the plain version compares at most this many pairs per slice of rows
_REF_PAIRS = 1 << 26

#: the kernel's per-path row counts by device: int64 [searched, all-pairs]
_PATH_ROWS: dict = {}


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def path_rows(device) -> dict:
    """Rows the kernel took on each path on ``device`` since the last
    ``reset_path_rows``: ``{"search": n, "all_pairs": n}`` (a host sync)."""
    rows = _PATH_ROWS.get(_device_key(device))
    search, all_pairs = (0, 0) if rows is None else rows.tolist()
    return {"search": search, "all_pairs": all_pairs}


def reset_path_rows() -> None:
    """Set every device's per-path row counts to 0."""
    for rows in _PATH_ROWS.values():
        rows.zero_()


def _check_rows(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b must be (E, DA) and (E, DB), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share an id type, got {a.dtype} and "
                        f"{b.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")


def intersect_blocked(a, b, *, block_rows: int = 256):
    """Row-wise intersection of padded id rows → ``(count, hit_a, hit_b)``.

    ``block_rows`` is the number of rows one thread block takes (the JAX
    kernel's row block); it changes no result.  CUDA tensors (int32 or
    int16, contiguous) launch the kernel; CPU tensors run the plain version.
    """
    _check_rows(a, b)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    dev = a.device
    if dev.type == "cpu":
        return intersect_ref(a, b)
    if dev.type != "cuda":
        raise ValueError(f"intersect_blocked: unsupported device {dev}")
    if a.dtype not in _LAUNCH:
        raise TypeError(f"the kernel takes int32 or int16 ids, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    E, DA = a.shape
    DB = b.shape[1]
    if DB * (4 + a.element_size()) > _MAX_SMEM:
        raise ValueError(f"a row of b ({DB} ids) does not fit one warp's "
                         f"shared memory")
    cnt = torch.empty(E, dtype=torch.int32, device=dev)
    hita = torch.empty((E, DA), dtype=torch.int32, device=dev)
    hitb = torch.empty((E, DB), dtype=torch.int32, device=dev)
    if E == 0:
        return cnt, hita, hitb
    key = _device_key(dev)
    if key not in _PATH_ROWS:
        _PATH_ROWS[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = cuda_build.library("intersect")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _LAUNCH[a.dtype])(
            a.data_ptr(), b.data_ptr(), cnt.data_ptr(), hita.data_ptr(),
            hitb.data_ptr(), _PATH_ROWS[key].data_ptr(), E, DA, DB,
            block_rows, stream)
    cuda_build.check_launch(lib, "intersect", code)
    COUNTS.launched()
    return cnt, hita, hitb


def intersect_ref(a, b):
    """Plain PyTorch version of ``intersect_blocked`` (same contract).

    The all-pairs ``eq`` of the JAX package's ``kernels/ref.py:
    intersect_ref``, taken over slices of rows so that no slice compares
    more than ``_REF_PAIRS`` pairs.
    """
    _check_rows(a, b)
    COUNTS.ran_plain()
    E, DA = a.shape
    DB = b.shape[1]
    dev = a.device
    cnt = torch.zeros(E, dtype=torch.int32, device=dev)
    hita = torch.zeros((E, DA), dtype=torch.int32, device=dev)
    hitb = torch.zeros((E, DB), dtype=torch.int32, device=dev)
    step = max(1, _REF_PAIRS // max(1, DA * DB))
    for s in range(0, E, step):
        eq = a[s:s + step, :, None] == b[s:s + step, None, :]
        ha = eq.any(dim=2)
        hita[s:s + step] = ha.to(torch.int32)
        hitb[s:s + step] = eq.any(dim=1).to(torch.int32)
        cnt[s:s + step] = ha.sum(dim=1, dtype=torch.int32)
    return cnt, hita, hitb
