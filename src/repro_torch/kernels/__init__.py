"""Hand-written CUDA kernels for Hopper (``csrc/``), with plain versions.

The three Pallas kernels of the JAX package as CUDA C++ for ``sm_90a``,
built with ``nvcc`` into plain-C shared libraries and called through
``ctypes`` (``cuda_build.py``): the support phase's oriented wedge scan
(``support.py``, K1) and the peel phase's sub-level decrement fold with
the sub-level updates beside it (``peel.py``, K2) — both read their
wedges from the CSR and share the wedge intersection of
``csrc/wedge_common.cuh`` — and the row-wise intersect of padded id rows
(``intersect.py``, K3), which the degree-class support path
``ops.compute_support_kernel`` runs.  Each wrapper launches its kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors, and counts
both (``COUNTS``; the updates: ``peel.UPDATE_COUNTS`` after a fold,
``peel.DENSE_COUNTS`` at a level's start; ``peel.LOOP_COUNTS`` the fused
peel loop, one launch per peel segment), each thread on its own;
``count_launches`` reads the calling thread's counts over one block of
work.  The k-core of the device preprocessing (``kcore.py``) replaces no
TPU kernel; its wrapper only launches, and ``core.kcore.coreness`` takes
its plain version, ``core.kcore.peel_cores``, off the card.
"""

import contextlib

from repro_torch.kernels import intersect, kcore, peel, support
from repro_torch.kernels.intersect import intersect_blocked, intersect_ref
from repro_torch.kernels.ops import compute_support_kernel
from repro_torch.kernels.peel import (dense_update, dense_update_ref,
                                      peel_decrement_fold,
                                      peel_decrement_fold_ref, peel_loop,
                                      peel_loop_ref, sublevel_update,
                                      sublevel_update_ref)
from repro_torch.kernels.support import (support_accumulate,
                                         support_accumulate_ref)

__all__ = ["count_launches", "compute_support_kernel", "dense_update",
           "dense_update_ref", "intersect_blocked", "intersect_ref",
           "peel_decrement_fold", "peel_decrement_fold_ref", "peel_loop",
           "peel_loop_ref", "sublevel_update", "sublevel_update_ref",
           "support_accumulate", "support_accumulate_ref"]


@contextlib.contextmanager
def count_launches():
    """Count the kernel launches and plain-version calls inside the block.

    Yields a dict that is filled when the block exits: ``{"support": n,
    "peel": n, "update": n, "loop": n, "intersect": n, "plain": n}`` — K1,
    K2, the sub-level updates (sparse and dense together), the fused peel
    loop and K3 launches, and calls of any kernel's plain version.  Only
    the calling thread's work counts: launches made on other threads during
    the block do not.
    """
    mods = {"support": (support.COUNTS,), "peel": (peel.COUNTS,),
            "update": (peel.UPDATE_COUNTS, peel.DENSE_COUNTS),
            "loop": (peel.LOOP_COUNTS,),
            "intersect": (intersect.COUNTS,)}

    def read(field):
        return {k: sum(c.mine()[field] for c in cs) for k, cs in
                mods.items()}

    kernel0, plain0 = read("kernel"), read("plain")
    counts: dict = {}
    yield counts
    kernel1, plain1 = read("kernel"), read("plain")
    for k in mods:
        counts[k] = kernel1[k] - kernel0[k]
    counts["plain"] = sum(plain1[k] - plain0[k] for k in mods)
