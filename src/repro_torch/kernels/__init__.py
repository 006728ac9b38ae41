"""Hand-written CUDA kernels for Hopper (``csrc/``), with plain versions.

The three Pallas kernels of the JAX package as CUDA C++ for ``sm_90a``,
built with ``nvcc`` into plain-C shared libraries and called through
``ctypes`` (``cuda_build.py``): the support phase's oriented wedge scan
(``support.py``, K1) and the peel phase's sub-level decrement fold with
the fused sub-level update beside it (``peel.py``, K2) — both read their
wedges from the CSR and share the wedge intersection of
``csrc/wedge_common.cuh`` — and the row-wise intersect of padded id rows
(``intersect.py``, K3), which the degree-class support path
``ops.compute_support_kernel`` runs.  Each wrapper launches its kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors, and counts
both (``COUNTS``; the update: ``peel.UPDATE_COUNTS``); ``count_launches``
reads the counts of one block of work.
"""

import contextlib

from repro_torch.kernels import intersect, peel, support
from repro_torch.kernels.intersect import intersect_blocked, intersect_ref
from repro_torch.kernels.ops import compute_support_kernel
from repro_torch.kernels.peel import (peel_decrement_fold,
                                      peel_decrement_fold_ref,
                                      sublevel_update, sublevel_update_ref)
from repro_torch.kernels.support import (support_accumulate,
                                         support_accumulate_ref)

__all__ = ["count_launches", "compute_support_kernel", "intersect_blocked",
           "intersect_ref", "peel_decrement_fold", "peel_decrement_fold_ref",
           "sublevel_update", "sublevel_update_ref", "support_accumulate",
           "support_accumulate_ref"]


@contextlib.contextmanager
def count_launches():
    """Count the kernel launches and plain-version calls inside the block.

    Yields a dict that is filled when the block exits: ``{"support": n,
    "peel": n, "update": n, "intersect": n, "plain": n}`` — K1, K2, the
    sub-level update and K3 launches, and calls of any kernel's plain
    version.  The counts are process-global, so work on
    other threads during the block would be counted too.
    """
    mods = {"support": support.COUNTS, "peel": peel.COUNTS,
            "update": peel.UPDATE_COUNTS, "intersect": intersect.COUNTS}
    before = {k: c.as_dict() for k, c in mods.items()}
    counts: dict = {}
    yield counts
    after = {k: c.as_dict() for k, c in mods.items()}
    for k in mods:
        counts[k] = after[k]["kernel"] - before[k]["kernel"]
    counts["plain"] = sum(after[k]["plain"] - before[k]["plain"]
                          for k in mods)
