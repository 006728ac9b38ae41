"""The k-core decomposition as one cooperative launch (``csrc/kcore.cu``).

``core_loop`` computes every vertex's coreness from a CSR on the card:
``peel_cores``' level-synchronous peel (``core/kcore.py``), frontier-driven,
in one launch of ``kcore_kernel`` and one host read of its counts.  Level
``l`` removes, sub-level by sub-level, the frontier ``{v alive : deg[v] <=
l}``; the kernel walks only the frontier's rows (split into slices of
``SLICE`` slots, so a hub spreads over many warps), decrements the alive
neighbours with atomics, and the decrement that takes a degree from ``l +
1`` to ``l`` puts the neighbour on the next frontier.  The coreness and the
sub-level count equal ``peel_cores``', sub-level for sub-level.

It replaces no TPU kernel: the JAX package peels cores with jnp operations
in a ``lax.while_loop``.  Its plain version is ``core.kcore.peel_cores``,
the same loop as torch operations with one host read a sub-level;
``core.kcore.coreness`` chooses between them by the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_build

#: launches of the CUDA kernel / calls of its plain version
#: (``core.kcore.coreness`` counts those)
COUNTS = cuda_build.LaunchCounts()

#: slots of one work item (``kSlice`` in csrc/kcore.cu)
SLICE = 128


class CoreResult(NamedTuple):
    """What one k-core peel reports."""

    core: torch.Tensor  # (n,) int32 coreness, on the CSR's device
    sublevels: int      # sub-levels run, empty ones included
    host_reads: int     # blocking reads of the device's counts
    blocks: int         # the launch's grid; 0 where the host drives it


def core_loop(Es: torch.Tensor, N: torch.Tensor) -> CoreResult:
    """Coreness of every vertex of the CSR ``(Es, N)`` (int32, on a CUDA
    device; row ``v`` is ``N[Es[v]:Es[v+1]]``, each undirected edge a slot
    each way, in any order within a row), in one cooperative launch of
    ``kcore_kernel`` and one read of its counts.  A launch the card refuses,
    or a peel past ``2 n`` sub-levels (a state no simple graph reaches),
    raises ``KernelError``."""
    dev = Es.device
    if dev.type != "cuda":
        raise ValueError(f"core_loop: the kernel runs on a CUDA device, got "
                         f"{dev} (core.kcore.coreness takes peel_cores "
                         f"there)")
    cuda_build.check_int32("Es", Es, dev)
    if Es.dim() != 1 or Es.shape[0] < 1:
        raise ValueError(f"Es must be (n + 1,), got {tuple(Es.shape)}")
    cuda_build.check_int32("N", N, dev, (N.numel(),))
    n = Es.shape[0] - 1
    if n == 0:
        return CoreResult(torch.zeros(0, dtype=torch.int32, device=dev), 0,
                          0, 0)
    scratch = torch.empty(4, n, dtype=torch.int32, device=dev)
    deg, core, list_v, list_item = scratch.unbind()
    # three 64-bit counter rows (zeroed), then [sublevels, status, blocks]
    ctl = torch.zeros(9, dtype=torch.int32, device=dev)
    lib = cuda_build.library("kcore")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.kcore_launch(Es.data_ptr(), N.data_ptr(), deg.data_ptr(),
                                core.data_ptr(), list_v.data_ptr(),
                                list_item.data_ptr(), ctl.data_ptr(),
                                ctl[6:].data_ptr(), n, stream)
    cuda_build.check_launch(lib, "kcore", code)
    COUNTS.launched()
    subs, status, blocks = ctl[6:].tolist()
    if status != 0:
        raise cuda_build.KernelError(
            f"k-core peel stopped after {subs} sub-levels of {n} vertices: "
            f"a simple graph peels in at most {2 * n}")
    return CoreResult(core, subs, 1, blocks)
