"""Hand-written CUDA kernels for Hopper (``csrc/``), with plain versions.

The two wedge-table kernels of the JAX package — the support phase's
oriented table scan (``support.py``, K1) and the peel phase's sub-level
decrement fold (``peel.py``, K2) — as CUDA C++ for ``sm_90a``, built with
``nvcc`` into plain-C shared libraries and called through ``ctypes``
(``cuda_build.py``).  Both share the chunk layout and the ranged binary
search of ``wedge_common.py`` / ``csrc/wedge_common.cuh``.  Each wrapper
launches its kernel on CUDA tensors and runs its plain PyTorch version on
CPU tensors, and counts both (``COUNTS``); ``count_launches`` reads the
counts of one block of work.
"""

import contextlib

from repro_torch.kernels import peel, support
from repro_torch.kernels.peel import (peel_decrement_fold,
                                      peel_decrement_fold_ref)
from repro_torch.kernels.support import (support_accumulate,
                                         support_accumulate_ref)

__all__ = ["count_launches", "peel_decrement_fold", "peel_decrement_fold_ref",
           "support_accumulate", "support_accumulate_ref"]


@contextlib.contextmanager
def count_launches():
    """Count the kernel launches and plain-version calls inside the block.

    Yields a dict that is filled when the block exits: ``{"support": n,
    "peel": n, "plain": n}`` — K1 and K2 launches, and calls of either
    kernel's plain version.  The counts are process-global, so work on
    other threads during the block would be counted too.
    """
    mods = {"support": support, "peel": peel}
    before = {k: mod.COUNTS.as_dict() for k, mod in mods.items()}
    counts: dict = {}
    yield counts
    after = {k: mod.COUNTS.as_dict() for k, mod in mods.items()}
    for k in mods:
        counts[k] = after[k]["kernel"] - before[k]["kernel"]
    counts["plain"] = sum(after[k]["plain"] - before[k]["plain"]
                          for k in mods)
